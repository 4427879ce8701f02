"""arctic-480b [moe] — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,            # 56 % 16 != 0 -> SP-attention fallback (DESIGN.md §6)
    num_kv_heads=8,
    head_dim=128,            # 56*128 == 7168
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    layer_pattern=("G",),
    rope_theta=10_000.0,
    optimizer="adafactor",   # AdamW state would not fit 16GB/chip (DESIGN.md §6)
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
        head_dim=8, d_ff=96, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, dense_residual=True),
    )
