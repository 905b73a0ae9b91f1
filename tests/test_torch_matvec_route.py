"""The matvec wrappers' route choice and refusals, and the sm90 kernels'
numerics, on the CPU.

``block.select_matvec_route`` is a pure function of (kernel, D): the six
cross-term kinds with 1 <= D <= ``SM90_MAX_D`` go to the sm90 tensor-core
kernel (``csrc/dsekl_matvec_sm90.cu``), the same kinds at wider D to the
sm90_wide one (``csrc/dsekl_matvec_sm90_wide.cu``, a loop over D), the
Laplacian at every D to the fp32-core kernel (``csrc/dsekl_matvec.cu``).
Each route's C entry points, as ``block._MATVEC_ENTRIES`` names them, are
in its source with the arguments the wrappers pass.  The wrappers take
CUDA tensors only and refuse CPU ones before they count a launch.

The tensor-core kernels' arithmetic, emulated in plain torch (the 3xTF32
split of the cross term, hi = tf32_rna(v), lo = tf32_rna(v - hi); the RBF
by exp2f of the pre-scaled distance; the sm90_wide kernel's sum over
32-feature slabs, each slab's three products added into the float32
total), is held against the JAX oracle
(``kernel_matvec`` with ``impl="ref"``) at the JAX suite's float32
tolerance, rtol 2e-4 and atol 1e-5 x max(1, |oracle|_inf), on
covertype-like data with gamma 1; one TF32 product misses it, which is why
the kernels split.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dsekl import ops as jops
from repro_torch.kernels.dsekl import block, ops

CROSS = ["rbf", "linear", "polynomial", "sigmoid", "matern32", "matern52"]
LIMIT = block.SM90_MAX_D

WIDE = (LIMIT + 1, 784, 1536)       # MNIST's D, lm-readout's decision

ROUTE_CASES = (
    [(k, d, "sm90") for k in CROSS for d in (1, 3, 54, LIMIT)]
    + [("laplacian", d, "fp32") for d in (1, 3, 54, LIMIT) + WIDE]
    + [(k, d, "sm90_wide") for k in CROSS for d in WIDE])


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


CSRC = pathlib.Path(block.__file__).parent / "csrc"
# Arguments of each C entry point as the wrappers call it: the launch (x, z,
# a, out, scratch, I, J, D, kind, six kernel scalars, n_split,
# tiles_per_split, stream), blocks an SM (kind [, D]), the error text
# (code), the scratch size (I, J, D, n_split).
ENTRY_FIELDS = ("launch", "blocks_per_sm", "error_string", "scratch_floats")


@pytest.mark.parametrize("field", ENTRY_FIELDS)
@pytest.mark.parametrize("route", block.MATVEC_ROUTES)
def test_route_entry_points_are_in_its_source(route, field):
    """``_MATVEC_ENTRIES[route]``'s C function is defined in the route's
    source with as many arguments as the wrappers pass; a library without
    a scratch sizer has none, and its scratch is n_split I + I + J."""
    e = block._MATVEC_ENTRIES[route]
    src = (CSRC / f"{block.MATVEC_LIBS[route]}.cu").read_text()
    name = getattr(e, field)
    if name is None:
        assert field == "scratch_floats"
        assert "scratch_floats" not in src
        return
    defs = re.findall(
        r"^(?:int|long long|const char\*)\s+" + name + r"\(([^)]*)\)",
        src, re.M)
    assert len(defs) == 1, name
    n_args = len([a for a in defs[0].split(",") if a.strip()])
    want = {"launch": 18, "blocks_per_sm": 1 + e.per_sm_takes_d,
            "error_string": 1, "scratch_floats": 4}[field]
    assert n_args == want, (name, defs[0])


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
        block.MATVEC_ROUTES) == {"sm90", "sm90_wide", "fp32"}


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


def _cross_3xtf32_slabs(xi, xj, slab=32):
    """The sm90_wide kernel's cross term: for each 32-feature slab, x_lo
    z_hi, x_hi z_lo and x_hi z_hi summed in turn, then added into the
    float32 total."""
    acc = torch.zeros((xi.shape[0], xj.shape[0]), dtype=torch.float32)
    for k in range(0, xi.shape[1], slab):
        xs, zs = xi[:, k:k + slab], xj[:, k:k + slab]
        xh, zh = tf32_rna(xs), tf32_rna(zs)
        xl, zl = tf32_rna(xs - xh), tf32_rna(zs - zh)
        acc = acc + ((xl @ zh.T + xh @ zl.T) + xh @ zh.T)
    return acc


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


def _kernel_cross(d):
    """The 3xTF32 cross term of the route that takes width ``d``."""
    return _cross_3xtf32 if d <= LIMIT else _cross_3xtf32_slabs


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


@pytest.mark.parametrize("d", [3, 54, 784, 1536])
@pytest.mark.parametrize("kernel", CROSS)
def test_3xtf32_numerics_meet_the_float32_tolerance(monkeypatch, kernel, d):
    (x, z, a), params, want = _case(kernel, d)
    got = _emulated(monkeypatch, _kernel_cross(d), x, z, a, kernel, params)
    assert bool(torch.isfinite(got).all())
    assert _misses(got, want) == 0


@pytest.mark.parametrize("d", [3, 54, 784, 1536])
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
