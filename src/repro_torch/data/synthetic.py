"""Deterministic synthetic data (port of ``repro/data/synthetic.py``'s
``make_covertype_like``).

The generator is a ``torch.Generator`` seeded from ``seed`` on the target
device, so the data is made in bulk where it is used.  Its values differ
from the JAX package's (``jax.random`` and torch draw different numbers);
the construction is the same.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def make_covertype_like(n: int = 100_000, d: int = 54, *, seed: int = 0,
                        device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Covertype stand-in: D=54 features (10 continuous, the rest 0/1 with
    p=0.15), a nonlinear decision boundary, classes ~57/43.  Returns
    float32 ``(x (n, d), y (n,))`` with y in {-1, +1} (0 where the score
    is exactly 0, as ``sign``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    x_cont = torch.randn((n, 10), generator=g, device=dev)
    x_bin = (torch.rand((n, d - 10), generator=g, device=dev) < 0.15).float()
    x = torch.cat([x_cont, x_bin], dim=1)
    w1 = torch.randn((d,), generator=g, device=dev)
    score = (torch.tanh(x @ w1 / math.sqrt(d)) + 0.5 * torch.sin(2.0 * x[:, 0])
             + 0.25 * x[:, 1] * x[:, 2] + 0.18)
    return x, torch.sign(score)
