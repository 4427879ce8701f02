"""whisper-base [audio] — enc-dec, conv frontend (stub).
[arXiv:2212.04356; unverified]

The modality frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, encoder_seq, d_model) in place of the mel
spectrogram + conv stem.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_act="gelu",
    rope_theta=10_000.0,     # (whisper uses learned abs pos; RoPE is our stand-in)
    optimizer="adamw",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, encoder_seq=16, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    )
