"""Qwen1.5-MoE-A2.7B — fine-grained MoE: 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B]  24L d_model=2048 16H (MHA kv=16) d_ff=1408
(per routed expert) vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
    num_shared_experts=1,
    moe_d_ff=128,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
