"""The benchmark's count of the work, and the card's peaks.

The count reads the same work whatever implements it: products from the
shapes, each input read once and each output written once.  Products are
timed at the dense TF32 tensor-core rate whatever split or unit a kernel
uses (an fp32-accurate kernel built from TF32 products already reads past
the fp32 peak, so only this rate bounds every way of doing the work),
bytes at the card's HBM bandwidth, and a launch's bound is the larger of
the two times."""
from __future__ import annotations

import dataclasses

F32 = 4
I64 = 8


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    tf32_flops: float       # dense TF32 tensor-core FLOP/s
    hbm_bytes: float        # bytes/s


# NVIDIA's data sheet for the H100 SXM, dense rates at the full power
# limit; every cell runs on that card, and another card has no row.
H100_SXM = Peaks("NVIDIA H100 80GB HBM3", 494.5e12, 3.35e12)


def peaks_for(card: str) -> Peaks:
    if card != H100_SXM.name:
        raise ValueError(f"no peaks for the card {card!r}; the benchmark "
                         f"knows {H100_SXM.name!r}")
    return H100_SXM


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def bound_s(self, peaks: Peaks) -> float:
        return max(self.flops / peaks.tf32_flops, self.bytes / peaks.hbm_bytes)


def matvec(q: int, n_sv: int, d: int) -> Work:
    """``f = K(x_q, x_sv) @ alpha_sv`` for ``q`` query rows against the
    ``n_sv`` (unpadded) support rows of width ``d``: the cross term and
    the contraction with alpha; reads the queries, the support rows and
    alpha, writes f."""
    return Work(flops=2.0 * q * n_sv * d + 2.0 * q * n_sv,
                bytes=F32 * (q * d + n_sv * d + n_sv + q))


def train_step(n_i: int, n_j: int, d: int) -> Work:
    """One step's train pass on the sampled block: the cross term, then
    f_I = K alpha_J and g_J = K^T v; reads the rows of I and J, y_I,
    alpha_J and both index sets, writes f_I and g_J."""
    return Work(flops=2.0 * n_i * n_j * d + 4.0 * n_i * n_j,
                bytes=F32 * ((n_i + n_j) * d + n_i + n_j)
                + I64 * (n_i + n_j) + F32 * (n_i + n_j))
