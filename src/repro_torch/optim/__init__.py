"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    make_optimizer,
    pulse_sgd,
    sgd,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
