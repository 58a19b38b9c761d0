"""Mistral-Large-2407 (123B) — large dense decoder.

[hf:mistralai/Mistral-Large-Instruct-2407]  88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    arch_type="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE_CONFIG = ModelConfig(
    name="mistral-large-123b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)
