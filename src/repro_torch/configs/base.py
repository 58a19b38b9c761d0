"""Config system: architecture configs, input shapes, and the registry.

A copy of the JAX package's ``configs/base.py`` (plain dataclasses).
Every assigned architecture has one module in ``repro_torch.configs`` exporting
``CONFIG`` (the full, paper-exact configuration) and ``SMOKE_CONFIG`` (a
reduced variant of the same family: <=2 layers, d_model<=512, <=4 experts)
used by CPU smoke tests.  In the port the full ``recurrentgemma-9b``
config runs on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description consumed by ``repro_torch.models.model.build_model``."""

    name: str
    arch_type: str                 # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    citation: str = ""

    # --- attention options -------------------------------------------------
    sliding_window: int = 0        # 0 = full attention
    local_window: int = 0          # window for 'local' layers in hybrid stacks
    qk_norm: bool = False
    rope_fraction: float = 1.0     # chatglm applies RoPE to half the head dim
    rope_theta: float = 10000.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # --- encoder-decoder ----------------------------------------------------
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    decoder_len_ratio: int = 8     # tgt_len = seq_len // ratio for enc-dec

    # --- hybrid / ssm -------------------------------------------------------
    # per-layer block kinds, cycled over num_layers.  '' -> all 'attn'.
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rglru','rglru','local_attn')
    rglru_conv_width: int = 4
    slstm_heads: int = 0           # xlstm

    # --- frontends (stubs; embeddings provided by input_specs) --------------
    frontend: str = ""             # '' | 'vision' | 'audio'
    num_prefix_embeds: int = 0     # VLM: number of patch embeddings per sample

    # --- misc ----------------------------------------------------------------
    act: str = "silu"
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    loss_chunk: int = 512          # chunked cross-entropy block

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind of length num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def homogeneous(self) -> bool:
        kinds = set(self.layer_kinds)
        return len(kinds) == 1 and kinds == {"attn"} and not self.encoder_decoder

    @property
    def subquadratic(self) -> bool:
        """True if serving memory is bounded (windowed or recurrent)."""
        kinds = set(self.layer_kinds)
        if kinds <= {"rglru", "local_attn", "slstm", "mlstm"}:
            return True
        return self.sliding_window > 0 and kinds == {"attn"}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "mixtral-8x7b",
    "internvl2-26b",
    "stablelm-1.6b",
    "whisper-base",
    "recurrentgemma-9b",
    "qwen2-moe-a2.7b",
    "qwen3-32b",
    "xlstm-125m",
    "chatglm3-6b",
    "mistral-large-123b",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """Load CONFIG or SMOKE_CONFIG for an architecture id (or module name)."""
    norm = _module_name(arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{norm}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is part of the matrix; reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (full-attn arch)"
    return True, ""


def all_pairs():
    """Yield (arch_id, shape_name, applicable, reason) for the 10x4 matrix."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shp in INPUT_SHAPES.items():
            ok, reason = shape_applicable(cfg, shp)
            yield arch, sname, ok, reason
