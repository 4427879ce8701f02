"""gemma2-2b [dense] — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,            # 8*256 != d_model (Gemma2 uses explicit head_dim)
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    layer_pattern=("L", "G"),     # alternating local / global
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_act="geglu",
    post_block_norm=True,
    tie_embeddings=True,
    optimizer="adamw",
    # Half the layers are windowed; global layers decode O(S) with a
    # seq-sharded cache -> long_500k runs, flagged partially-full-attention
    # in DESIGN.md §5.
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=32,
    )
