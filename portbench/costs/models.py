"""FLOPs and bytes that a cell's work needs, counted from the model's
shapes (products only: 2 FLOPs a multiply-add; elementwise work left
out).  These are what the ``mfu.*`` metrics divide by the time taken."""
from __future__ import annotations


# -- LeNet: Algorithm 1 -----------------------------------------------------

def lenet_layers(m: dict) -> list:
    """(name, forward FLOPs a sample) of each product of LeNet with valid
    convolutions and 2 x 2 pools, from the configuration's sizes."""
    c1, c2 = m["conv_channels"]
    k, size, cin = m["kernel_size"], m["image_size"], m["in_channels"]
    f1, f2 = m["fc_dims"]
    o1 = size - k + 1
    s1 = o1 // 2
    o2 = s1 - k + 1
    s2 = o2 // 2
    return [("conv1", 2 * o1 * o1 * c1 * k * k * cin),
            ("conv2", 2 * o2 * o2 * c2 * k * k * c1),
            ("fc1", 2 * s2 * s2 * c2 * f1),
            ("fc2", 2 * f1 * f2),
            ("out", 2 * f2 * m["num_classes"])]


def lenet_forward_flops(m: dict) -> int:
    return sum(f for _, f in lenet_layers(m))


def lenet_train_flops(m: dict) -> int:
    """Forward, weight gradient and input gradient of every product, a
    sample, but the first convolution's input gradient (the images need
    none)."""
    layers = lenet_layers(m)
    return 3 * sum(f for _, f in layers) - layers[0][1]


def hfl_round_flops(m: dict, num_ues: int, samples_per_ue: int, a: int,
                    b: int, eval_samples: int) -> int:
    """One cloud round of Algorithm 1: a*b full-batch GD steps on every
    UE's samples, then the round's evaluation (a forward pass over the
    test set and over every UE's training samples)."""
    return (a * b * num_ues * samples_per_ue * lenet_train_flops(m)
            + eval_samples * lenet_forward_flops(m))


# -- Qwen1.5-MoE: prefill and decode -----------------------------------------

def moe_token_flops(c: dict) -> int:
    """Product FLOPs a token a layer: q, k, v and output projections, the
    router, the k routed experts' SwiGLU and the shared experts' SwiGLU
    and gate."""
    d, h, kv, hd = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"], c["head_dim"]
    f, fs = c["moe_intermediate_size"], c["shared_expert_intermediate_size"]
    attn = 2 * d * hd * (2 * h + 2 * kv)
    router = 2 * d * c["num_experts"]
    routed = c["num_experts_per_tok"] * 3 * 2 * d * f
    shared = 3 * 2 * d * fs + 2 * d
    return attn + router + routed + shared


def attention_flops(c: dict, pairs: int) -> int:
    """Score and value products over ``pairs`` (query, key) pairs of one
    (row, head), a layer, for every query head."""
    return 4 * c["head_dim"] * c["num_attention_heads"] * pairs


def head_flops(c: dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, batch: int, seq: int) -> int:
    """A prefill of ``batch`` prompts of ``seq`` tokens: every layer on
    every token, causal attention, and the head on the last token of each
    row (prefill returns the last logits only)."""
    L = c["num_hidden_layers"]
    pairs = seq * (seq + 1) // 2
    return (batch * seq * L * moe_token_flops(c)
            + batch * L * attention_flops(c, pairs)
            + batch * head_flops(c))


def decode_flops(c: dict, batch: int, counted: int) -> int:
    """One decode step of ``batch`` rows whose new token attends to
    ``counted`` cache slots."""
    L = c["num_hidden_layers"]
    return batch * (L * (moe_token_flops(c) + attention_flops(c, counted))
                    + head_flops(c))


def decode_bytes(c: dict, batch: int, counted: int, experts_picked: float,
                 elem: int = 2) -> float:
    """Bytes one decode step needs: every weight outside the routed
    experts once (attention, norms, router, shared experts, the head, the
    batch's embedding rows), the routed experts that the step's tokens
    picked (``experts_picked``: distinct experts summed over the layers),
    the counted K and V slots read and the new token's K and V written."""
    d, h, kv, hd = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"], c["head_dim"]
    f, fs, E = c["moe_intermediate_size"], \
        c["shared_expert_intermediate_size"], c["num_experts"]
    L = c["num_hidden_layers"]
    layer = (d * hd * (2 * h + 2 * kv) + 2 * d + d * E
             + 3 * d * fs + d)
    weights = L * layer + d * c["vocab_size"] + d + batch * d
    experts = experts_picked * 3 * d * f
    cache = L * 2 * batch * kv * hd * (counted + 1)
    return elem * (weights + experts + cache)
