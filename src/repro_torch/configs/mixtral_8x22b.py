"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,            # 48*128 == 6144
    d_ff=16384,
    vocab_size=32768,
    moe=MoEConfig(num_experts=8, top_k=2),
    window=4096,             # sliding-window attention (per assignment)
    layer_pattern=("L",),    # every layer windowed
    rope_theta=1_000_000.0,
    optimizer="adafactor",
    subquadratic=True,       # SWA: rolling KV cache bounded by window
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=32,
        moe=MoEConfig(num_experts=4, top_k=2),
    )
