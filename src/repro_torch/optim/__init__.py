"""Optimizers and learning-rate schedules (port of ``repro/optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, Shards, clip_by_global_norm, global_norm, make_optimizer,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
