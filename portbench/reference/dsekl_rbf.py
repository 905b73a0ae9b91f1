"""Plain reference of DSEKL with the RBF kernel, in PyTorch and float32
with TF32 off: serving ``f(q) = sum_j k(q, x_j) alpha_j`` and Algorithm 1
(the paper's doubly stochastic step: hinge loss, an L2 term ``lam``,
AdaGrad), with the epochs' index plans drawn again from the fit's seed.

It imports nothing of the program.  ``tf32=True`` is the control: the
same arithmetic with the cross term's operands rounded to TF32 (10
mantissa bits, round to nearest even), which is what a TF32 tensor-core
GEMM multiplies; the contractions with alpha and v, matrix-vector
products, stay float32 as they would on the card.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Sequence, Tuple

import torch

Tensor = torch.Tensor


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Float32 products in full float32 on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def round_tf32(t: Tensor) -> Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even;
    still a float32 tensor."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def scale_gamma(x: Tensor, chunk: int = 1 << 16) -> float:
    """The "scale" rule: gamma = 1 / (D var(x)), var over every entry,
    accumulated in float64 in chunks of rows."""
    n, d = x.shape
    s = torch.zeros((), dtype=torch.float64, device=x.device)
    s2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, n, chunk):
        blk = x[lo:lo + chunk].double()
        s += blk.sum()
        s2 += (blk * blk).sum()
    m = float(s) / (n * d)
    var = float(s2) / (n * d) - m * m
    return 1.0 / (d * var)


def rbf(q: Tensor, x: Tensor, gamma: float, tf32: bool = False) -> Tensor:
    """``K[a, b] = exp(-gamma |q_a - x_b|^2)`` by the expanded square,
    clamped at 0."""
    qn = (q * q).sum(1)
    xn = (x * x).sum(1)
    if tf32:
        q, x = round_tf32(q), round_tf32(x)
    d2 = qn[:, None] + xn[None, :] - 2.0 * (q @ x.T)
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def decision(q: Tensor, x_sv: Tensor, a_sv: Tensor, gamma: float, *,
             tf32: bool = False, block: int = 1 << 14) -> Tensor:
    """``f(q) = K(q, x_sv) @ a_sv`` over blocks of support rows."""
    f = torch.zeros((q.shape[0],), dtype=torch.float32, device=q.device)
    with no_tf32():
        for lo in range(0, x_sv.shape[0], block):
            k = rbf(q, x_sv[lo:lo + block], gamma, tf32)
            f += k @ a_sv[lo:lo + block]
    return f


def support(alpha: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The rows with a non-zero coefficient, and those coefficients."""
    keep = alpha != 0
    return x[keep], alpha[keep]


class Epoch(NamedTuple):
    alpha: Tensor           # after the epoch
    accum: Tensor           # AdaGrad's accumulator after the epoch (init 1)
    delta: float            # |alpha after - alpha before|


def draw_plans(seed: int, device, n: int, n_grad: int, n_expand: int,
               steps: int, epochs: Sequence[int]) -> List[Tuple[Tensor, Tensor]]:
    """The fit's epoch plans drawn again from its generator's seed: epoch
    e's (1-based) is the e-th draw of ``steps`` rows of ``n_grad`` indices
    of I and then ``steps`` rows of ``n_expand`` of J, uniform over [0, n)
    with replacement, from one generator on ``device``.  Returns the plans
    of ``epochs``, in that order; the others are drawn and dropped."""
    g = torch.Generator(device=device).manual_seed(seed)
    drawn = {}
    for e in range(1, max(epochs) + 1):
        idx_i = torch.randint(0, n, (steps, n_grad), generator=g,
                              device=device)
        idx_j = torch.randint(0, n, (steps, n_expand), generator=g,
                              device=device)
        if e in epochs:
            drawn[e] = (idx_i, idx_j)
    return [drawn[e] for e in epochs]


def fit_epoch(x: Tensor, y: Tensor, gamma: float,
              plan: Tuple[Tensor, Tensor], alpha: Tensor, accum: Tensor, *,
              lam: float, lr0: float, tf32: bool = False) -> Epoch:
    """One epoch of Algorithm 1 on ``plan`` from the state ``alpha``,
    ``accum`` (AdaGrad's accumulator; a fit starts at alpha 0, accum 1):
    each step ``f_I = K_IJ alpha_J``, ``v = dhinge/df = -y`` where ``y f <
    1`` (else 0), ``g = K_IJ^T v + lam alpha_J``, then AdaGrad over J with
    duplicates summed: ``accum_J += g^2`` first, ``alpha_J -= lr0 g /
    sqrt(accum_J)``."""
    idx_i, idx_j = plan
    before = alpha
    with no_tf32():
        for t in range(idx_i.shape[0]):
            i, j = idx_i[t], idx_j[t]
            k = rbf(x[i], x[j], gamma, tf32)
            a_j = alpha[j]
            f = k @ a_j
            yi = y[i]
            v = torch.where(yi * f < 1.0, -yi, torch.zeros_like(yi))
            g = k.T @ v + lam * a_j
            accum = accum.index_add(0, j, g * g)
            alpha = alpha.index_add(0, j, -lr0 * torch.rsqrt(accum[j]) * g)
    return Epoch(alpha, accum, float(torch.linalg.vector_norm(alpha - before)))
