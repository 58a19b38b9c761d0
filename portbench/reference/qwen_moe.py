"""Plain PyTorch reference of the Qwen1.5-MoE forward pass, in float32.

It reads the weights the benchmark drew (bf16) and computes every layer
in fp32 with TF32 off, one layer at a time over whole sequences: RMSNorm,
q/k/v with rotary positions (rotate-half over the whole head), causal
softmax attention, the output projection; RMSNorm, the router's softmax
and top-k (renormalised), each expert's SwiGLU on the tokens that picked
it, the shared expert's SwiGLU times sigmoid(x . gate); the final norm and
the head.  The routed experts keep the configuration's capacity rule: the
tokens of one call of the program (``groups``: a prefill's prompts, or
one decode step's B tokens) share each expert's ``C`` places, dealt in
token order; a pick past them adds nothing.  Imports nothing of the
program.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (a scale a row of the activations and a column of the
weights), accumulated in fp32.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def capacity(tokens: int, experts: int, k: int, factor: float) -> int:
    """Places an expert has in a call of ``tokens`` tokens: ceil(k T / E
    x factor), rounded up to a multiple of 8."""
    c = int(math.ceil(k * tokens / experts * factor))
    return max(8, (c + 7) // 8 * 8)


def _qdq(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the contraction), back in fp32."""
    s = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    def __init__(self, mode: str):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.fp8 = mode == "fp8"

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., n) @ w (n, m) in fp32, or on fp8-rounded operands."""
        w = w.float()
        if self.fp8:
            x, w = _qdq(x, -1), _qdq(w, 0)
        return x @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, hd), rotate-half form."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, one row at a time: q (B, S, H, hd), k, v
    (B, S, K, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    out = torch.empty_like(q)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        qb = q[b].transpose(0, 1)                         # (H, S, hd)
        kb = k[b].repeat_interleave(g, 1).transpose(0, 1)
        vb = v[b].repeat_interleave(g, 1).transpose(0, 1)
        s = (qb @ kb.transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        out[b] = (torch.softmax(s, -1) @ vb).transpose(0, 1)
    return out


def routed(c: dict, lw: dict, h: torch.Tensor, groups, pr) -> torch.Tensor:
    """The routed experts' output (B, S, d) for h (B, S, d) (normed);
    ``groups``: position ranges [p0, p1), each one call of the program
    whose B x (p1 - p0) tokens, batch-major, share the capacity."""
    B, S, d = h.shape
    E, k = c["num_experts"], c["num_experts_per_tok"]
    logits = pr.lin(h.reshape(-1, d), lw["router"])
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    top_p, top_e = top_p.reshape(B, S, k), top_e.reshape(B, S, k)
    keep = torch.zeros_like(top_e, dtype=torch.bool)
    for p0, p1 in groups:
        e = top_e[:, p0:p1].reshape(-1)                    # batch-major picks
        C = capacity(B * (p1 - p0), E, k, c["capacity_factor"])
        onehot = torch.nn.functional.one_hot(e, E)
        place = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[:, p0:p1] = (place < C).reshape(B, p1 - p0, k)
    y = torch.zeros(B * S, d, dtype=torch.float32, device=h.device)
    hf = h.reshape(-1, d)
    flat_e, flat_p = top_e.reshape(-1, k), top_p.reshape(-1, k)
    flat_keep = keep.reshape(-1, k)
    for ex in range(E):
        tok, slot = torch.nonzero((flat_e == ex) & flat_keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = hf[tok]
        a = torch.nn.functional.silu(pr.lin(x, lw["w_gate"][ex])) \
            * pr.lin(x, lw["w_up"][ex])
        y.index_add_(0, tok, pr.lin(a, lw["w_down"][ex])
                     * flat_p[tok, slot][:, None])
    return y.reshape(B, S, d)


def hidden(c: dict, w: dict, tokens: torch.Tensor, groups,
           mode: str = "fp32", kv: dict = None) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S).
    With ``kv`` (a dict whose keys are layer indices), each of those
    layers' keys (rotated) and values (B, S, K, hd) are put in it."""
    pr = Precision(mode)
    eps = c["rms_norm_eps"]
    B, S = tokens.shape
    H, K, hd = c["num_attention_heads"], c["num_key_value_heads"], \
        c["head_dim"]
    x = w["embedding"][tokens.long()].float()
    L = c["num_hidden_layers"]
    st = w["scanned"]
    for i in range(L):
        lw = {"attn": {k: v[i] for k, v in st["attn"].items()},
              "moe": {k: v[i] for k, v in st["moe"].items() if k != "shared"},
              "shared": {k: v[i] for k, v in st["moe"]["shared"].items()}}
        h = rms(x, st["ln1"]["scale"][i], eps)
        q = pr.lin(h, lw["attn"]["wq"].flatten(1)).reshape(B, S, H, hd)
        k = pr.lin(h, lw["attn"]["wk"].flatten(1)).reshape(B, S, K, hd)
        v = pr.lin(h, lw["attn"]["wv"].flatten(1)).reshape(B, S, K, hd)
        q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
        if kv is not None and i in kv:
            kv[i] = {"k": k, "v": v}
        o = attention(q, k, v).reshape(B, S, H * hd)
        x = x + pr.lin(o, lw["attn"]["wo"].flatten(0, 1))
        h = rms(x, st["ln2"]["scale"][i], eps)
        sh = lw["shared"]
        shared = (torch.nn.functional.silu(pr.lin(h, sh["wi_gate"]))
                  * pr.lin(h, sh["wi_up"]))
        shared = pr.lin(shared, sh["wo"]) \
            * torch.sigmoid(pr.lin(h, sh["gate"]))
        x = x + routed(c, lw["moe"], h, groups, pr) + shared
    return rms(x, w["final_norm"]["scale"], eps)


def logits(c: dict, w: dict, h: torch.Tensor, mode: str = "fp32"):
    """Head logits (..., V) of normed hidden states ``h`` (..., d)."""
    return Precision(mode).lin(h, w["lm_head"])
