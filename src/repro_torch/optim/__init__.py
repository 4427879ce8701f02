"""Optimizers and learning-rate schedules (counterpart of
``repro/optim``): the reference's functional, optax-like API over the
port's parameter trees.  ``adafactor`` comes with LM training."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant,
    cosine,
    linear_warmup,
    step_decay,
    wsd,
)
