"""Optimizers and learning-rate schedules (counterpart of
``repro/optim``): the reference's functional, optax-like API over the
port's parameter trees."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    sgd,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant,
    cosine,
    linear_warmup,
    step_decay,
    wsd,
)
