"""The matvec wrappers' route choice and refusals, and the sm90 kernel's
numerics, on the CPU.

``block.select_matvec_route`` is a pure function of (kernel, D): the six
cross-term kinds with 1 <= D <= ``SM90_MAX_D`` go to the sm90 tensor-core
kernel (``csrc/dsekl_matvec_sm90.cu``), the Laplacian and wider D to the
fp32-core kernel (``csrc/dsekl_matvec.cu``).  Both wrappers take CUDA
tensors only and refuse CPU ones before they count a launch.

The sm90 kernel's arithmetic, emulated in plain torch (its 3xTF32 split of
the cross term, hi = tf32_rna(v), lo = tf32_rna(v - hi), and its RBF by
exp2f of the pre-scaled distance), is held against the JAX oracle
(``kernel_matvec`` with ``impl="ref"``) at the JAX suite's float32
tolerance, rtol 2e-4 and atol 1e-5 x max(1, |oracle|_inf), on
covertype-like data with gamma 1; one TF32 product misses it, which is why
the kernel splits.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dsekl import ops as jops
from repro_torch.kernels.dsekl import block, ops

CROSS = ["rbf", "linear", "polynomial", "sigmoid", "matern32", "matern52"]
LIMIT = block.SM90_MAX_D

ROUTE_CASES = (
    [(k, d, "sm90") for k in CROSS for d in (1, 3, 54, LIMIT)]
    + [("laplacian", d, "fp32") for d in (1, 3, 54, LIMIT, LIMIT + 1, 784)]
    + [(k, d, "fp32") for k in CROSS for d in (LIMIT + 1, 784)])


@pytest.mark.parametrize("kernel,d,route", ROUTE_CASES,
                         ids=[f"{k}-d{d}" for k, d, _ in ROUTE_CASES])
def test_route_is_a_function_of_kernel_and_width(kernel, d, route):
    assert block.select_matvec_route(kernel, d) == route
    assert block.select_matvec_route(kernel, d) == route   # no state
    assert route in block.MATVEC_ROUTES


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="no CUDA kernel"):
        block.select_matvec_route("cosine", 54)


def test_route_table_names_the_kernels():
    assert set(block.CROSS_TERM_KINDS) == set(CROSS)
    assert set(block.CROSS_TERM_KINDS) | {"laplacian"} == set(block.KINDS)
    assert LIMIT >= 64
    assert set(block.MATVEC_LIBS) == set(block.MATVEC_ROUTES)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("kernel,d", [("rbf", 54), ("linear", 3),
                                      ("laplacian", 54), ("rbf", 784)])
def test_wrappers_refuse_cpu_tensors_without_counting(kernel, d):
    """A CPU tensor raises before any launch is counted, on both wrappers,
    on either route, and through ``impl="cuda"``."""
    rng = np.random.default_rng(d)
    x, z = (rng.standard_normal((n, d)).astype(np.float32) for n in (5, 9))
    a, v = rng.standard_normal(9).astype(np.float32), \
        rng.standard_normal(5).astype(np.float32)
    x, z, a, v = _t(x, z, a, v)
    fns = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
    before = [(f.launches, dict(f.launches_by_route)) for f in fns]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        block.kernel_matvec_cuda(x, z, a, kernel_name=kernel)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        block.kernel_vecmat_cuda(x, z, v, kernel_name=kernel)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.kernel_matvec(x, z, a, kernel_name=kernel, kernel_params=(),
                          impl="cuda")
    assert [(f.launches, f.launches_by_route) for f in fns] == before


@pytest.mark.parametrize("fn", ["kernel_matvec_cuda", "kernel_vecmat_cuda"])
def test_route_counters_cover_every_route(fn):
    assert set(getattr(block, fn).launches_by_route) == set(
        block.MATVEC_ROUTES)


# ---------------------------------------------------------------------------
# The sm90 kernel's numerics, emulated.
# ---------------------------------------------------------------------------

def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: cvt.rna.tf32.f32.  Adding half of the dropped 13 bits'
    range to the magnitude's bit pattern and clearing them does it."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _cross_3xtf32(xi, xj):
    """The kernel's cross term: x_lo z_hi + x_hi z_lo, then + x_hi z_hi."""
    xh, zh = tf32_rna(xi), tf32_rna(xj)
    xl, zl = tf32_rna(xi - xh), tf32_rna(xj - zh)
    return (xl @ zh.T + xh @ zl.T) + xh @ zh.T


def _cross_1xtf32(xi, xj):
    """One TF32 product: both operands rounded once."""
    return tf32_rna(xi) @ tf32_rna(xj).T


def _rbf_exp2(xi, xj, *, gamma=1.0):
    """The kernel's RBF: exp2f of the clamped distance times
    f32(-gamma log2(e))."""
    scale = torch.tensor(-gamma * math.log2(math.e), dtype=torch.float32)
    return torch.exp2(scale * block._sq_dists_tile(xi, xj))


def _emulated(monkeypatch, cross, x, z, a, kernel, params):
    """The plain version with the kernel's cross term (and RBF) in place
    of float32's: the same tile functions, the kernel's numerics."""
    monkeypatch.setattr(block, "_cross_term", cross)
    monkeypatch.setitem(block.TILE_FNS, "rbf", _rbf_exp2)
    return block.kernel_matvec_plain(x, z, a, kernel_name=kernel,
                                     params=params, block=256)


def covertype_like(n: int, d: int, rng) -> np.ndarray:
    """``make_covertype_like``'s features in numpy: the first min(10, d)
    standard normal, the rest 0/1 with p = 0.15 (|x|^2 ~ 16.6 at d 54)."""
    n_cont = min(10, d)
    return np.concatenate(
        [rng.standard_normal((n, n_cont)),
         (rng.random((n, d - n_cont)) < 0.15).astype(np.float64)],
        axis=1).astype(np.float32)


# gamma 1 where the kernel has one; every other parameter its default.
GAMMA1 = {"rbf": {"gamma": 1.0}, "linear": {},
          "polynomial": {"gamma": 1.0}, "sigmoid": {"gamma": 1.0},
          "matern32": {}, "matern52": {}}


def _case(kernel, d, seed=0):
    """96 queries near support rows (a served query's neighbours are what
    its decision value sums: the continuous features of a random support
    row jittered by 0.3 sd) and 700 support rows, covertype-like."""
    rng = np.random.default_rng(seed + d)
    z = covertype_like(700, d, rng)
    x = z[rng.choice(700, 96, replace=False)].copy()
    x[:, :min(10, d)] += 0.3 * rng.standard_normal((96, min(10, d)))
    a = rng.standard_normal(700).astype(np.float32)
    params = GAMMA1[kernel]
    want = np.asarray(jops.kernel_matvec(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(a), kernel_name=kernel,
        kernel_params=tuple(params.items()), impl="ref"))
    return _t(x, z, a), params, want


def _misses(got, want) -> int:
    """Entries outside rtol 2e-4, atol 1e-5 x max(1, |want|_inf)."""
    got = got.double().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    return int((np.abs(got - want) > atol + 2e-4 * np.abs(want)).sum())


@pytest.mark.parametrize("d", [3, 54])
@pytest.mark.parametrize("kernel", CROSS)
def test_3xtf32_numerics_meet_the_float32_tolerance(monkeypatch, kernel, d):
    (x, z, a), params, want = _case(kernel, d)
    got = _emulated(monkeypatch, _cross_3xtf32, x, z, a, kernel, params)
    assert bool(torch.isfinite(got).all())
    assert _misses(got, want) == 0


@pytest.mark.parametrize("d", [3, 54])
def test_one_tf32_product_misses_the_tolerance_for_rbf(monkeypatch, d):
    """Why the kernel splits: with one TF32 product the squared distance
    errs ~1e-3 relative, and most RBF sums miss the float32 check."""
    (x, z, a), params, want = _case("rbf", d)
    got = _emulated(monkeypatch, _cross_1xtf32, x, z, a, "rbf", params)
    assert _misses(got, want) > want.size // 4


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10                                 # TF32 ulp at 1.0
    v = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 0.0, -0.0], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 0.0, -0.0]
    assert tf32_rna(v).tolist() == want
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32_rna(x)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
