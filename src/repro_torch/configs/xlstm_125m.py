"""xLSTM-125M — sLSTM + mLSTM recurrent blocks (attention-free).

[arXiv:2405.04517]  12L d_model=768 4H (kv=4) d_ff=0 (projection factors
internal to the blocks) vocab=50304.  Alternating mLSTM/sLSTM pattern.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    slstm_heads=4,
    act="gelu",
    norm_type="layernorm",
    citation="arXiv:2405.04517",
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-125m-smoke",
    arch_type="ssm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_pattern=("mlstm", "slstm"),
    slstm_heads=4,
    act="gelu",
    norm_type="layernorm",
    citation="arXiv:2405.04517",
)
