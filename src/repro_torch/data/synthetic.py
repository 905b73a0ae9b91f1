"""Deterministic synthetic data sets for the paper's experiments (port of
``repro/data/synthetic.py``).

The paper's libsvm / UCI sets are stood in for by synthetic generators
with matched (N, D, balance); the XOR construction follows the paper's
Fig. 1.  Each generator draws from a ``torch.Generator`` seeded from
``seed`` on the target device, so the data is made in bulk where it is
used.  The values differ from the JAX package's (``jax.random`` and torch
draw different numbers); the constructions, shapes, dtypes and label
rules are the same.  ``train_test_split`` also takes an explicit
permutation, which is how the tests give both packages the same split.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _xor(g: torch.Generator, n: int, noise: float) -> Tuple[Tensor, Tensor]:
    dev = g.device
    centers_pos = torch.tensor([[1.0, 1.0], [-1.0, -1.0]], device=dev)
    centers_neg = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], device=dev)
    which = (torch.rand((n,), generator=g, device=dev) < 0.5).long()
    labels = torch.rand((n,), generator=g, device=dev) < 0.5
    centers = torch.where(labels[:, None], centers_pos[which],
                          centers_neg[which])
    x = centers + noise * torch.randn((n, 2), generator=g, device=dev)
    y = torch.where(labels, 1.0, -1.0)
    return x, y


def make_xor(n: int, noise: float = 0.2, *, seed: int = 0,
             device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Paper Fig. 1: class +1 ~ N(+-[1, 1], noise), class -1 ~ N(+-[1, -1],
    noise); float32 ``(x (n, 2), y (n,))``, y in {-1, +1}."""
    return _xor(_generator(seed, device), n, noise)


def make_two_moons(n: int, noise: float = 0.15, *, seed: int = 0,
                   device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Two interleaved half circles, ``n // 2`` rows each, shuffled;
    float32 ``(x (2 * (n // 2), 2), y)``, y in {-1, +1}."""
    g = _generator(seed, device)
    dev = g.device
    half = n // 2
    t = torch.linspace(0, math.pi, half, device=dev)
    x_pos = torch.stack([torch.cos(t), torch.sin(t)], dim=1)
    x_neg = torch.stack([1.0 - torch.cos(t), 0.5 - torch.sin(t)], dim=1)
    x = torch.cat([x_pos, x_neg]) + noise * torch.randn(
        (2 * half, 2), generator=g, device=dev)
    y = torch.cat([torch.ones(half, device=dev),
                   -torch.ones(half, device=dev)])
    perm = torch.randperm(2 * half, generator=g, device=dev)
    return x[perm], y[perm]


def _blobs(g: torch.Generator, n: int, d: int, sep: float
           ) -> Tuple[Tensor, Tensor]:
    dev = g.device
    y = torch.where(torch.rand((n,), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    mu = (sep / 2.0) * torch.ones((d,), device=dev) / math.sqrt(d)
    x = y[:, None] * mu[None, :] + torch.randn((n, d), generator=g,
                                               device=dev)
    return x, y


def make_gaussian_blobs(n: int, d: int, sep: float = 2.0, *, seed: int = 0,
                        device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Two spherical Gaussians at +-(sep / 2) e / sqrt(d) with unit noise,
    a linearly separable-ish set; float32, y in {-1, +1}."""
    return _blobs(_generator(seed, device), n, d, sep)


def _nonlinear(g: torch.Generator, n: int, d: int, freq: float
               ) -> Tuple[Tensor, Tensor]:
    dev = g.device
    x = torch.randn((n, d), generator=g, device=dev)
    w = torch.randn((d,), generator=g, device=dev)
    score = torch.sin(freq * (x @ w) / math.sqrt(d)) \
        + 0.3 * torch.cos(x[:, 0])
    return x, torch.sign(score + 1e-6)


def make_nonlinear(n: int, d: int, freq: float = 2.0, *, seed: int = 0,
                   device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Label = sign(sin(freq x.w / sqrt(d)) + 0.3 cos(x_0) + 1e-6), a
    smooth nonlinear boundary; float32."""
    return _nonlinear(_generator(seed, device), n, d, freq)


def make_covertype_like(n: int = 100_000, d: int = 54, *, seed: int = 0,
                        device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Covertype stand-in: D=54 features (10 continuous, the rest 0/1 with
    p=0.15), a nonlinear decision boundary, classes ~57/43.  Returns
    float32 ``(x (n, d), y (n,))`` with y in {-1, +1} (0 where the score
    is exactly 0, as ``sign``)."""
    g = _generator(seed, device)
    dev = g.device
    x_cont = torch.randn((n, 10), generator=g, device=dev)
    x_bin = (torch.rand((n, d - 10), generator=g, device=dev) < 0.15).float()
    x = torch.cat([x_cont, x_bin], dim=1)
    w1 = torch.randn((d,), generator=g, device=dev)
    score = (torch.tanh(x @ w1 / math.sqrt(d)) + 0.5 * torch.sin(2.0 * x[:, 0])
             + 0.25 * x[:, 1] * x[:, 2] + 0.18)
    return x, torch.sign(score)


# Stand-ins for the paper's Table 1 (matched N, D), as in the JAX package.
_TABLE1_SPECS: Dict[str, Tuple[int, int, str]] = {
    # name: (N capped at 1000 as in §4.1, D, generator)
    "mnist_like": (1000, 784, "blobs"),
    "diabetes_like": (768, 8, "nonlinear"),
    "breast_cancer_like": (683, 10, "blobs"),
    "mushrooms_like": (1000, 112, "blobs"),
    "sonar_like": (208, 60, "nonlinear"),
    "skin_like": (1000, 3, "nonlinear"),
    "madelon_like": (1000, 500, "xor_highdim"),
}


def _xor_highdim(g: torch.Generator, n: int, d: int
                 ) -> Tuple[Tensor, Tensor]:
    """Madelon-style: the XOR of two informative dims beside d - 2 noise
    dims of scale 0.5."""
    x2, y = _xor(g, n, 0.2)
    noise = torch.randn((n, d - 2), generator=g, device=g.device) * 0.5
    return torch.cat([x2, noise], dim=1), y


def make_benchmark_suite(seed: int = 0, device: DeviceLike = None
                         ) -> Dict[str, Tuple[Tensor, Tensor]]:
    """The Table-1 stand-in suite; set i is drawn from seed ``seed * 1000
    + i``.  The blobs' separation grows with sqrt(d) (3 + 0.25 sqrt(d)):
    the within-class diameter grows ~sqrt(2d) with unit noise, so a fixed
    separation would vanish for an RBF kernel in high dimension."""
    out = {}
    for i, (name, (n, d, kind)) in enumerate(_TABLE1_SPECS.items()):
        g = _generator(seed * 1000 + i, device)
        if kind == "blobs":
            out[name] = _blobs(g, n, d, 3.0 + 0.25 * float(np.sqrt(d)))
        elif kind == "nonlinear":
            out[name] = _nonlinear(g, n, d, 2.0)
        else:
            out[name] = _xor_highdim(g, n, d)
    return out


def train_test_split(x, y, test_frac: float = 0.5, *, seed: int = 0,
                     perm=None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(x_train, y_train, x_test, y_test)``: the first ``int(n *
    test_frac)`` entries of a permutation of [0, n) are the test rows, the
    rest the training rows.  The permutation is ``perm`` when given (a
    tensor or an array), else drawn from ``seed`` on ``x``'s device."""
    # Arrays are copied: a read-only one (a JAX array's view) cannot back
    # a tensor.
    x, y = (a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a)) for a in (x, y))
    n = int(x.shape[0])
    if perm is None:
        g = torch.Generator(device=x.device).manual_seed(seed)
        perm = torch.randperm(n, generator=g, device=x.device)
    else:
        if not isinstance(perm, torch.Tensor):
            perm = torch.from_numpy(np.array(perm))
        perm = perm.to(device=x.device, dtype=torch.int64)
        if tuple(perm.shape) != (n,):
            raise ValueError(f"perm must be ({n},); got {tuple(perm.shape)}")
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]
