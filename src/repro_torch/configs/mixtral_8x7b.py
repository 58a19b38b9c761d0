"""Mixtral 8x7B — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
sliding window 4096.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    citation="arXiv:2401.04088",
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x7b-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
    sliding_window=64,
    citation="arXiv:2401.04088",
)
