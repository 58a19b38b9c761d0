"""ChatGLM3-6B — dense decoder, partial (2d/half-dim) RoPE, GQA kv=2.

[arXiv:2406.12793]  28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    citation="arXiv:2406.12793",
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-6b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    rope_fraction=0.5,
    citation="arXiv:2406.12793",
)
