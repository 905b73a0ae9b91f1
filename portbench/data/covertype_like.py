"""UCI Covertype's stand-in (581,012 x 54 at the published shape): a
frozen copy of the port's ``make_covertype_like``, so that a change to
the program cannot change the benchmark's data.  10 continuous features
and 44 binary ones (p = 0.15), a nonlinear boundary, classes ~57 / 43;
drawn in bulk on ``device`` from one generator seeded with ``seed``."""
from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def make(n: int, d: int, *, seed: int, device) -> Tuple[Tensor, Tensor]:
    """``(x (n, d), y (n,))``, float32, y in {-1, +1} (0 where the score is
    exactly 0, as ``sign``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dev = g.device
    x_cont = torch.randn((n, 10), generator=g, device=dev)
    x_bin = (torch.rand((n, d - 10), generator=g, device=dev) < 0.15).float()
    x = torch.cat([x_cont, x_bin], dim=1)
    w1 = torch.randn((d,), generator=g, device=dev)
    score = (torch.tanh(x @ w1 / math.sqrt(d)) + 0.5 * torch.sin(2.0 * x[:, 0])
             + 0.25 * x[:, 1] * x[:, 2] + 0.18)
    return x, torch.sign(score)
