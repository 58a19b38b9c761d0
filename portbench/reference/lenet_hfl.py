"""Plain PyTorch reference of synchronous Algorithm 1 on LeNet.

Every UE keeps its own LeNet replica; a UE's gradient is the gradient of
its own full-batch mean cross entropy.  All N replicas run at once as
grouped convolutions (``groups=N``) and batched products, and one
backward of the sum of the UEs' losses gives each replica its own
gradient.  An edge
round is ``a`` GD steps on every UE, then eq. 6 (each UE takes its edge's
D_n-weighted mean); a cloud round is ``b`` edge rounds, then eq. 10
(every UE takes the fleet's D_n-weighted mean).  The means are taken in
float64.  Imports nothing of the program.

``mode="tf32"`` computes every product in TF32 (the control: the nearest
precision below the configuration's fp32): the dense products on the
tensor cores, and the convolutions, whose grouped kernels have no TF32
path, on operands rounded to TF32's 10-bit mantissa, forward and
backward, accumulated in fp32, as TF32 products are.
``half_batch=True`` takes each UE's gradient over the first half of its
samples (a fault).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LEAVES = (("conv1", "w"), ("conv1", "b"), ("conv2", "w"), ("conv2", "b"),
          ("fc1", "w"), ("fc1", "b"), ("fc2", "w"), ("fc2", "b"),
          ("out", "w"), ("out", "b"))


@contextlib.contextmanager
def precision(mode: str):
    """fp32 products with TF32 off, or TF32 on (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _mode[0])
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _mode[0] = mode
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _mode[0]) = old


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to the nearest TF32 value (10 mantissa bits)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _GroupedConv(torch.autograd.Function):
    """``conv2d(x, w, groups=groups)`` whose forward and backward products
    take their operands through ``rnd`` (the identity, or ``tf32_round``)."""

    @staticmethod
    def forward(ctx, x, w, groups, rnd):
        x, w = rnd(x), rnd(w)
        ctx.save_for_backward(x, w)
        ctx.groups, ctx.rnd = groups, rnd
        return F.conv2d(x, w, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = ctx.rnd(g.contiguous())
        gx = (torch.nn.grad.conv2d_input(x.shape, w, g, groups=ctx.groups)
              if ctx.needs_input_grad[0] else None)
        gw = torch.nn.grad.conv2d_weight(x, w.shape, g, groups=ctx.groups)
        return gx, gw, None, None


_ROUND = {"fp32": lambda t: t, "tf32": tf32_round}
_mode = ["fp32"]


def stacked_logits(P: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (N, k, classes) of N replicas ``P`` (leaves with a leading N
    axis; convolutions HWIO, dense (in, out)) on their own images
    ``x`` (N, k, H, W, C)."""
    N, k, H, W, C = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(k, N * C, H, W)
    rnd = _ROUND[_mode[0]]
    for name in ("conv1", "conv2"):
        w = P[name]["w"]                       # (N, kh, kw, cin, cout)
        cin, cout = w.shape[3], w.shape[4]
        wk = w.permute(0, 4, 3, 1, 2).reshape(N * cout, cin, w.shape[1],
                                              w.shape[2])
        h = _GroupedConv.apply(h, wk, N, rnd) \
            + P[name]["b"].reshape(1, -1, 1, 1)
        h = F.max_pool2d(torch.tanh(h), 2)
    c2, s = P["conv2"]["w"].shape[4], h.shape[-1]
    h = h.reshape(k, N, c2, s, s).permute(1, 0, 3, 4, 2).reshape(N, k, -1)
    for name in ("fc1", "fc2"):
        h = torch.tanh(torch.baddbmm(P[name]["b"][:, None, :], h,
                                     P[name]["w"]))
    return torch.baddbmm(P["out"]["b"][:, None, :], h, P["out"]["w"])


def logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) of one LeNet ``p`` on images ``x`` (n, H, W, C)."""
    one = {n: {l: v[None] for l, v in layer.items()} for n, layer in p.items()}
    return stacked_logits(one, x[None])[0]


def xent(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the last-but-one axis."""
    ll = torch.log_softmax(z, -1)
    return -ll.gather(-1, y.long()[..., None])[..., 0].mean(-1)


def _map(fn, *trees):
    return {k: {kk: fn(*(t[k][kk] for t in trees)) for kk in trees[0][k]}
            for k in trees[0]}


def resample(sizes, k: int, seed: int) -> list:
    """Each UE's k sample indices into its own D_n samples, drawn as the
    simulator stacks UEs to a common size (with replacement where D_n < k,
    none where D_n = k)."""
    rng = np.random.default_rng(seed)
    return [rng.choice(m, size=k, replace=m < k) if m != k else np.arange(k)
            for m in sizes]


def run(p0: dict, images: torch.Tensor, labels: torch.Tensor, weights,
        edge_of_ue, a: int, b: int, lr: float, rounds: int, test: dict,
        mode: str = "fp32", half_batch: bool = False) -> list:
    """``rounds`` cloud rounds from the global model ``p0``.  ``images``
    (N, k, H, W, C) and ``labels`` (N, k) are every UE's stacked samples,
    ``weights`` the D_n.  Returns a dict a round: the global model
    (fp32 leaves), its D_n-weighted train loss over the UEs' samples and
    its test loss."""
    N = images.shape[0]
    dev = images.device
    w = torch.as_tensor(np.asarray(weights, np.float64), device=dev)
    gid = torch.as_tensor(np.asarray(edge_of_ue), device=dev).long()
    M = int(gid.max()) + 1
    edge_w = torch.zeros(M, dtype=torch.float64, device=dev).index_add_(
        0, gid, w)
    kk = images.shape[1] // 2 if half_batch else images.shape[1]
    xs, ys = images[:, :kk], labels[:, :kk]

    def edge_mean(t):
        flat = t.reshape(N, -1).double() * w[:, None]
        s = torch.zeros((M, flat.shape[1]), dtype=torch.float64,
                        device=dev).index_add_(0, gid, flat)
        return (s / edge_w[:, None])[gid].reshape(t.shape).float()

    def cloud_mean(t):
        flat = t.reshape(N, -1).double()
        return ((w @ flat) / w.sum()).reshape(t.shape[1:]).float()

    out = []
    g = _map(lambda v: v.detach().float(), p0)
    with precision(mode):
        for _ in range(rounds):
            P = _map(lambda v: v[None].repeat((N,) + (1,) * v.dim())
                     .contiguous(), g)
            for _ in range(b):
                for _ in range(a):
                    leaves = [P[n][l].requires_grad_() for n, l in LEAVES]
                    loss = xent(stacked_logits(P, xs), ys).sum()
                    grads = torch.autograd.grad(loss, leaves)
                    with torch.no_grad():
                        for (n, l), gr in zip(LEAVES, grads):
                            P[n][l] = (P[n][l] - lr * gr).detach()
                P = _map(edge_mean, P)
            g = _map(cloud_mean, P)
            with torch.no_grad():
                per_ue = torch.stack([
                    xent(logits(g, images[n]), labels[n]) for n in range(N)])
                train = float((w * per_ue.double()).sum() / w.sum())
                test_loss = float(xent(logits(g, test["images"]),
                                       test["labels"]))
            out.append({"params": g, "train_loss": train,
                        "test_loss": test_loss})
    return out


def norm_gaps(start: dict, got: dict, ref: dict, floor: float = 1e-3):
    """The worst leaf's gap between the norm of the program's change
    ``got - start`` and the reference's ``ref - start``, over the larger
    of the reference's norm of that leaf and the median leaf's.  Leaves
    whose reference change is under ``floor`` of the median leaf's move
    by round-off alone and are left out.  Returns (gap, leaf, kept)."""
    norms_ref, norms_got = {}, {}
    for n, l in LEAVES:
        s = start[n][l].double()
        norms_ref[(n, l)] = float((ref[n][l].double() - s).norm())
        norms_got[(n, l)] = float((got[n][l].double() - s).norm())
    med = float(np.median(list(norms_ref.values())))
    worst, leaf, kept = 0.0, None, 0
    for key, r in norms_ref.items():
        if r < floor * med:
            continue
        kept += 1
        gap = abs(norms_got[key] - r) / max(r, med)
        if gap >= worst or not math.isfinite(gap):
            worst, leaf = gap, key
            if not math.isfinite(gap):
                return math.inf, key, kept
    return worst, leaf, kept
