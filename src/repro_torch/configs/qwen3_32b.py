"""Qwen3-32B — dense decoder with qk-norm and GQA.

[hf:Qwen/Qwen3-8B (family)]  64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    citation="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-32b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    qk_norm=True,
    head_dim=32,
    citation="hf:Qwen/Qwen3-8B",
)
