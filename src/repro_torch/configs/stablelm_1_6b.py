"""StableLM-2 1.6B — dense decoder.

[hf:stabilityai/stablelm-2-1_6b]  24L d_model=2048 32H (kv=32, i.e. MHA)
d_ff=5632 vocab=100352.  Partial RoPE (25%) per the model card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_fraction=0.25,
    citation="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-1.6b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    rope_fraction=0.25,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
