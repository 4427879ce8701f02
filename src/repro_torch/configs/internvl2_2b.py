"""internvl2-2b [vlm] — InternViT + InternLM2 backbone.
[arXiv:2404.16821; hf]

The vision frontend is a STUB: ``input_specs()`` provides precomputed ViT
patch embeddings (batch, num_patches, d_model) prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    num_patches=256,
    rope_theta=1_000_000.0,
    optimizer="adamw",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_patches=8,
    )
