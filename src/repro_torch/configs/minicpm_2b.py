"""minicpm-2b [dense] — WSD schedule (arch=llama-like). [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,            # MHA; 36 % 16 != 0 -> SP-attention fallback
    num_kv_heads=36,
    head_dim=64,             # 36*64 == 2304
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    optimizer="adamw",       # with WSD learning-rate schedule (optim/schedule.py)
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=48, num_heads=6, num_kv_heads=6,
        head_dim=8, d_ff=96, vocab_size=256,
    )
