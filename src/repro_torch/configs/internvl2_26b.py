"""InternVL2-26B — VLM: InternViT vision encoder (stub) + InternLM2 backbone.

[arXiv:2404.16821]  48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision frontend is a STUB per the brief: input_specs() provides patch
embeddings (num_prefix_embeds, d_model); we implement the language backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    num_prefix_embeds=256,
    citation="arXiv:2404.16821",
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-26b-smoke",
    arch_type="vlm",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    frontend="vision",
    num_prefix_embeds=16,
    citation="arXiv:2404.16821",
)
