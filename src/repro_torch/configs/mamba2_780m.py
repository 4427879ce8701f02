"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                  # no separate FFN; SSD block only
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=128),
    optimizer="adamw",
    subquadratic=True,       # O(1)-state decode
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    )
