"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,          # MQA in local-attention layers
    head_dim=256,            # 16*256 == 4096
    d_ff=12288,
    vocab_size=256000,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, block_pattern=("R", "R", "L")),
    window=2048,
    layer_pattern=("R", "R", "L"),   # 2 recurrent : 1 local attention
    mlp_act="geglu",
    tie_embeddings=True,
    optimizer="adamw",
    subquadratic=True,       # bounded window + O(1) recurrent state
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256, window=32,
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
    )
