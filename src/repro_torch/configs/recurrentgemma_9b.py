"""RecurrentGemma-9B — hybrid: RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427]  38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Block pattern: two recurrent (RG-LRU) blocks per one local-attention block,
local window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    act="gelu",
    citation="arXiv:2402.19427",
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-9b-smoke",
    arch_type="hybrid",
    num_layers=3,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=64,
    act="gelu",
    citation="arXiv:2402.19427",
)
