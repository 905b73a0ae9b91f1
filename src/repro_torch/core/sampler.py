"""Index samplers of Algorithm 1 (port of ``repro/core/sampler.py``'s
``sample_uniform`` and ``epoch_plan``).

Both draw from an explicit ``torch.Generator``, on the generator's device.
They cannot reproduce the JAX package's threefry draws, so every consumer
(``dsekl.step_serial``, ``trainer.SerialPlan``, ``solver.fit``) also
accepts an explicit index plan: that is how the tests feed both packages
the same indices.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def sample_uniform(gen: torch.Generator, n: int, size: int,
                   device=None) -> Tensor:
    """Alg. 1: ``size`` iid uniform int64 indices in [0, n), with
    replacement, drawn on ``device`` (default: the generator's)."""
    return torch.randint(0, n, (size,), generator=gen,
                         device=device if device is not None else gen.device)


def epoch_plan(gen: torch.Generator, n: int, n_grad: int, n_expand: int,
               steps: int) -> Tuple[Tensor, Tensor]:
    """A whole Alg.-1 epoch's index plan, drawn in two bulk calls on the
    generator's device: ``(idx_i (steps, n_grad), idx_j (steps,
    n_expand))``, iid uniform in [0, n) with replacement."""
    idx_i = torch.randint(0, n, (steps, n_grad), generator=gen,
                          device=gen.device)
    idx_j = torch.randint(0, n, (steps, n_expand), generator=gen,
                          device=gen.device)
    return idx_i, idx_j
