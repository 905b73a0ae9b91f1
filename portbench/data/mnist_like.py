"""MNIST's stand-in at the published shape (70,000 x 784): pixel values
in [0, 1], about 19% of them non-zero, and a binary task.

Ten stroke templates (each pixel on with p = 0.16) stand for the ten
digits; an image is its digit's template with 5% of its pixels flipped,
the lit ones at intensity 0.5 + 0.5 U(0, 1).  The label is +1 for the
even digits and -1 for the odd ones.  Drawn in bulk on ``device`` from
one generator seeded with ``seed``; rows are made in chunks so that the
(rows, 784) draws stay a few hundred MB."""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

TEMPLATE_ON = 0.16
FLIP = 0.05
CHUNK = 1 << 15


def make(n: int, d: int, *, seed: int, device) -> Tuple[Tensor, Tensor]:
    """``(x (n, d), y (n,))``, float32, y in {-1, +1}."""
    g = torch.Generator(device=device).manual_seed(seed)
    dev = g.device
    templates = torch.rand((10, d), generator=g, device=dev) < TEMPLATE_ON
    digit = torch.randint(0, 10, (n,), generator=g, device=dev)
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        flip = torch.rand((hi - lo, d), generator=g, device=dev) < FLIP
        lit = templates[digit[lo:hi]] ^ flip
        level = 0.5 + 0.5 * torch.rand((hi - lo, d), generator=g, device=dev)
        x[lo:hi] = torch.where(lit, level, torch.zeros_like(level))
    y = torch.where(digit % 2 == 0, 1.0, -1.0)
    return x, y
