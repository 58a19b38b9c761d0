"""What the two serving entries share: the program's model built from a
configuration file, the weights drawn from the seed, the prompts, and the
spans the traced run puts around the MoE FFN."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from unittest import mock

MOE_SPAN = "pb.moe"


def sizes(cfg: dict) -> dict:
    """The published sizes the reference and the cost arithmetic read."""
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "head_dim", "moe_intermediate_size",
            "shared_expert_intermediate_size", "num_experts",
            "num_experts_per_tok", "vocab_size", "rope_theta",
            "rms_norm_eps", "capacity_factor")
    return {k: cfg[k] for k in keys}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for the configuration file, checked
    to state the file's sizes."""
    from repro_torch.configs.base import get_config
    prog = cfg["program"]
    mc = dataclasses.replace(get_config(prog["arch"],
                                        smoke=prog.get("smoke", False)),
                             **prog.get("overrides", {}))
    want = {"d_model": cfg["hidden_size"],
            "num_layers": cfg["num_hidden_layers"],
            "num_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"],
            "resolved_head_dim": cfg["head_dim"],
            "moe_d_ff": cfg["moe_intermediate_size"],
            "num_experts": cfg["num_experts"],
            "num_experts_per_tok": cfg["num_experts_per_tok"],
            "vocab_size": cfg["vocab_size"],
            "rope_theta": cfg["rope_theta"], "norm_eps": cfg["rms_norm_eps"],
            "capacity_factor": cfg["capacity_factor"]}
    got = {k: getattr(mc, k) for k in want}
    got_shared = mc.num_shared_experts * mc.moe_d_ff
    if got != want or got_shared != cfg["shared_expert_intermediate_size"] \
            or mc.tie_embeddings != cfg["tie_word_embeddings"] \
            or mc.act != cfg["hidden_act"] or not mc.homogeneous:
        raise ValueError(f"the program's {prog['arch']} config does not state "
                         f"the file's sizes: {got} (shared {got_shared}) "
                         f"against {want}")
    return mc


def weight_specs(c: dict) -> dict:
    """{path: (shape, fan-in or None for ones)} of the stacked MoE model's
    parameters, in the layout the program takes them."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, K, hd = c["num_attention_heads"], c["num_key_value_heads"], \
        c["head_dim"]
    E, f = c["num_experts"], c["moe_intermediate_size"]
    fs, V = c["shared_expert_intermediate_size"], c["vocab_size"]
    return {
        "embedding": ((V, d), d), "lm_head": ((d, V), d),
        "final_norm.scale": ((d,), None),
        "scanned.ln1.scale": ((L, d), None),
        "scanned.attn.wq": ((L, d, H, hd), d),
        "scanned.attn.wk": ((L, d, K, hd), d),
        "scanned.attn.wv": ((L, d, K, hd), d),
        "scanned.attn.wo": ((L, H, hd, d), H * hd),
        "scanned.ln2.scale": ((L, d), None),
        "scanned.moe.router": ((L, d, E), d),
        "scanned.moe.w_gate": ((L, E, d, f), d),
        "scanned.moe.w_up": ((L, E, d, f), d),
        "scanned.moe.w_down": ((L, E, f, d), f),
        "scanned.moe.shared.wi_gate": ((L, d, fs), d),
        "scanned.moe.shared.wi_up": ((L, d, fs), d),
        "scanned.moe.shared.wo": ((L, fs, d), fs),
        "scanned.moe.shared.gate": ((L, d, 1), d),
    }


def draw_weights(c: dict, gen, dtype) -> dict:
    """Every parameter from ``gen`` on its device in ``dtype``, one draw a
    leaf: N(0, 1 / fan-in), norms 1.  A nested dict as the program takes
    it."""
    import torch
    tree = {}
    for path, (shape, fan_in) in weight_specs(c).items():
        if fan_in is None:
            t = torch.ones(shape, dtype=dtype, device=gen.device)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device,
                            dtype=dtype).mul_(1.0 / math.sqrt(fan_in))
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = v
    return out


def build(cfg: dict, ctx, decode_margin: int):
    """(model, weights) of the configuration on the run's device: the
    program's ``Model`` and the harness's weights, checked against the
    program's parameter shapes."""
    import torch
    from repro_torch.models.model import Model
    prog = cfg["program"]
    mc = model_config(cfg)
    dt = getattr(torch, prog["param_dtype"])
    model = Model(mc, impl="kernel", param_dtype=dt,
                  act_dtype=getattr(torch, prog["act_dtype"]),
                  decode_margin=decode_margin, device=ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed["torch"])
    weights = draw_weights(sizes(cfg), gen, dt)
    want = {k: tuple(v.shape) for k, v in flat(model.param_shapes()).items()}
    got = {k: tuple(v.shape) for k, v in flat(weights).items()}
    if want != got:
        raise ValueError(f"weight layout differs from the program's: "
                         f"{sorted(set(want.items()) ^ set(got.items()))}")
    return model, weights


def prompts(cfg: dict, ctx, rows: int, length: int):
    """``rows`` prompts of ``length`` tokens from the seed (the order-2
    Markov chain), int32 on the device."""
    import torch
    from data.synthetic import TokenStream
    toks = TokenStream(cfg["vocab_size"], seed=ctx.seed["numpy"]).batch(
        rows, length)["tokens"]
    return torch.as_tensor(toks, device=ctx.device)


@contextlib.contextmanager
def moe_spans(routes=None):
    """Each call of the MoE FFN (``transformer.apply_moe``: route,
    dispatch, experts, combine and the shared experts) inside a
    ``pb.moe`` range; with ``routes`` (a ``Routes``), each routed call's
    expert picks appended to it while its ``recording`` is set."""
    import torch
    from repro_torch.models import moe, transformer
    apply_moe, route = transformer.apply_moe, moe._route

    def spanned(*a, **k):
        with torch.profiler.record_function(MOE_SPAN):
            return apply_moe(*a, **k)

    def recorded(*a, **k):
        out = route(*a, **k)
        if routes is not None and routes.recording:
            routes.append(out[1])
        return out

    with mock.patch.object(transformer, "apply_moe", spanned), \
            mock.patch.object(moe, "_route", recorded):
        yield


class Routes(list):
    """Expert picks recorded while ``recording`` is set."""
    recording = False

    def distinct(self) -> float:
        """Distinct experts picked, summed over the recorded calls."""
        return float(sum(int(t.unique().numel()) for t in self))
