"""Small LM configs for the end-to-end CPU-runnable examples.

LM100M is the '~100M-param model trained for a few hundred steps' deliverable
(llama-style dense transformer); LM16M is the quick-smoke variant used by
tests and the quickstart example.
"""
from repro_torch.configs.base import ModelConfig

LM100M = ModelConfig(
    name="lm100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=8192,
    tie_embeddings=True,
    optimizer="adamw",
)   # ~92M params

LM16M = ModelConfig(
    name="lm16m",
    family="dense",
    num_layers=6,
    d_model=320,
    num_heads=8,
    num_kv_heads=4,
    head_dim=40,
    d_ff=896,
    vocab_size=4096,
    tie_embeddings=True,
    optimizer="adamw",
)

SMALL_CONFIGS = {"lm100m": LM100M, "lm16m": LM16M}
