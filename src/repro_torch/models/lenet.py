"""LeNet in functional PyTorch — the paper's own simulation model (§V,
Figs. 4/6), ported from the JAX package's ``repro/models/lenet.py``.

Strongly-convex logistic regression (for which Assumption 1 actually holds)
is also provided; the paper's convergence-count formulas (eqs. 2/7) assume
β-strong convexity + L-smoothness.

Parameters are plain dicts of tensors in the JAX package's layout, so its
parameters load unchanged (``repro_torch.weights.from_jax_params``):
images are NHWC, conv weights HWIO, and ``fc1`` reads the NHWC flatten of
the last pooled map.  Inside ``lenet_apply`` the convolutions run in
PyTorch's NCHW/OIHW layout.  Every function works on one model and one
batch; the simulator batches it over UEs with ``torch.func.vmap``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.lenet_mnist import LeNetConfig
from repro_torch.device import resolve_device


def lenet_init(generator: torch.Generator, cfg: LeNetConfig, *,
               device=None) -> dict:
    """Random LeNet parameters.  The draws come from ``generator`` on the
    CPU, so one seed gives the same parameters on every device."""
    dev = resolve_device(device)
    c1, c2 = cfg.conv_channels
    ks = cfg.kernel_size
    sz = cfg.image_size
    # two valid convs + 2x2 pools
    s1 = (sz - ks + 1) // 2
    s2 = (s1 - ks + 1) // 2
    flat = s2 * s2 * c2
    f1, f2 = cfg.fc_dims

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def dense(i, o):
        return {"w": normal(i, o) * math.sqrt(2.0 / i), "b": torch.zeros(o)}

    params = {
        "conv1": {"w": normal(ks, ks, cfg.in_channels, c1) * 0.1,
                  "b": torch.zeros(c1)},
        "conv2": {"w": normal(ks, ks, c1, c2) * 0.1, "b": torch.zeros(c2)},
        "fc1": dense(flat, f1),
        "fc2": dense(f1, f2),
        "out": dense(f2, cfg.num_classes),
    }
    return {k: {kk: v.to(dev) for kk, v in layer.items()}
            for k, layer in params.items()}


def _conv(x, w, b):
    """Valid conv of NCHW ``x`` with an HWIO weight."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b)


def lenet_apply(params, images):
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    x = torch.tanh(_conv(x, params["conv1"]["w"], params["conv1"]["b"]))
    x = F.max_pool2d(x, 2)
    x = torch.tanh(_conv(x, params["conv2"]["w"], params["conv2"]["b"]))
    x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # NHWC flatten
    x = torch.tanh(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.tanh(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def _xent_acc(logits, labels):
    labels = labels.long()
    ll = F.log_softmax(logits, dim=-1)
    loss = -ll.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def lenet_loss(params, batch):
    loss, acc = _xent_acc(lenet_apply(params, batch["images"]),
                          batch["labels"])
    return loss, {"acc": acc}


# -- strongly convex task (Assumption 1 holds exactly) ----------------------

def logreg_init(dim: int, num_classes: int, *, device=None) -> dict:
    dev = resolve_device(device)
    return {"w": torch.zeros(dim, num_classes, device=dev),
            "b": torch.zeros(num_classes, device=dev)}


def logreg_loss(params, batch, l2: float = 1e-3):
    """l2 > 0 makes the objective β-strongly convex with β = l2."""
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    loss, acc = _xent_acc(x @ params["w"] + params["b"], batch["labels"])
    reg = 0.5 * l2 * ((params["w"] ** 2).sum() + (params["b"] ** 2).sum())
    return loss + reg, {"acc": acc}
