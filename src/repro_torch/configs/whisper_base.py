"""Whisper-base — encoder-decoder ASR transformer; conv frontend is a STUB.

[arXiv:2212.04356]  6L (x2: encoder+decoder) d_model=512 8H (MHA kv=8)
d_ff=2048 vocab=51865.  input_specs() provides mel-frame embeddings
(batch, seq, d_model) for the encoder; we implement the transformer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,               # decoder layers
    num_encoder_layers=6,
    encoder_decoder=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    frontend="audio",
    act="gelu",
    norm_type="layernorm",
    rope_fraction=0.0,          # sinusoidal/learned abs positions
    decoder_len_ratio=8,
    citation="arXiv:2212.04356",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-base-smoke",
    arch_type="audio",
    num_layers=2,
    num_encoder_layers=2,
    encoder_decoder=True,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    frontend="audio",
    act="gelu",
    norm_type="layernorm",
    rope_fraction=0.0,
    decoder_len_ratio=8,
    citation="arXiv:2212.04356",
)
