"""The port's serving op vs the JAX package's, on the same numpy inputs.

* ``block.kernel_matvec_plain`` (the plain version beside the CUDA kernel)
  vs JAX ``block.kernel_matvec_pallas`` in interpret mode;
* ``ops.kernel_matvec`` / ``kernel_matvec_tiled`` / ``kernel_block`` and
  ``core.dsekl.decision_function`` (both methods) vs JAX ``impl="ref"``
  and ``impl="pallas_interpret"``;

for the seven registry kernels at ragged shapes, at the JAX suite's float32
tolerance (rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf)).  The CUDA kernel
itself runs only on the card: tests/test_torch_cuda.py holds it against
this plain version there, and ``chip_smoke.py`` does at full size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsekl as jdsekl
from repro.kernels.dsekl import block as jblock
from repro.kernels.dsekl import ops as jops
from repro_torch.core import dsekl as tdsekl
from repro_torch.kernels.dsekl import block as tblock
from repro_torch.kernels.dsekl import ops as tops

KERNEL_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 1.0), ("degree", 2))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
IDS = [k for k, _ in KERNEL_CASES]
# Ragged on purpose: not multiples of any tile size.
SHAPES = [(8, 8, 2), (37, 130, 7)]
POLY_NEG = ("polynomial", (("gamma", 0.5), ("coef0", 0.0), ("degree", 3)))


def _tols(*refs):
    scale = max(1.0, *(float(np.abs(r).max()) for r in refs))
    return 2e-4, 1e-5 * scale


def _data(shape, seed=0):
    i, j, d = shape
    rng = np.random.default_rng(seed + 1000 * i + j)
    f32 = np.float32
    return (rng.standard_normal((i, d)).astype(f32),
            rng.standard_normal((j, d)).astype(f32),
            rng.standard_normal(j).astype(f32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    rtol, atol = _tols(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES + [POLY_NEG],
                         ids=IDS + ["polynomial-neg-odd"])
def test_plain_version_matches_pallas_interpret(kernel, params, shape):
    """The plain version beside the CUDA kernel computes what the TPU
    kernel computes (block sizes chosen so the Pallas grid is multi-tile
    and ragged)."""
    x, z, a = _data(shape)
    want = jblock.kernel_matvec_pallas(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(a), kernel_name=kernel,
        params=dict(params), block_i=8, block_j=128, interpret=True)
    got = tblock.kernel_matvec_plain(*_t(x, z, a), kernel_name=kernel,
                                     params=dict(params), block=64)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_kernel_matvec_matches_jax(kernel, params, impl):
    x, z, a = _data(SHAPES[1], seed=1)
    want = jops.kernel_matvec(jnp.asarray(x), jnp.asarray(z), jnp.asarray(a),
                              kernel_name=kernel, kernel_params=params,
                              impl=impl)
    got = tops.kernel_matvec(*_t(x, z, a), kernel_name=kernel,
                             kernel_params=params, impl="ref")
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_kernel_matvec_tiled_matches_jax(kernel, params, impl):
    x, z, a = _data(SHAPES[1], seed=2)
    kw = dict(kernel_name=kernel, kernel_params=params, z_block=32)
    want = jops.kernel_matvec_tiled(jnp.asarray(x), jnp.asarray(z),
                                    jnp.asarray(a), impl=impl, **kw)
    got = tops.kernel_matvec_tiled(*_t(x, z, a), impl="auto", **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kernel,params", KERNEL_CASES + [POLY_NEG],
                         ids=IDS + ["polynomial-neg-odd"])
def test_kernel_block_matches_jax(kernel, params):
    x, z, _ = _data(SHAPES[1], seed=3)
    want = jops.kernel_block(jnp.asarray(x), jnp.asarray(z),
                             kernel_name=kernel, kernel_params=params)
    got = tops.kernel_block(*_t(x, z), kernel_name=kernel,
                            kernel_params=params)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("method", ["stream", "ref"])
@pytest.mark.parametrize("kernel,params", [KERNEL_CASES[0], KERNEL_CASES[1],
                                           KERNEL_CASES[5]],
                         ids=["rbf", "laplacian", "matern32"])
def test_decision_function_matches_jax(kernel, params, method, impl):
    """Both methods, with a ragged final chunk (147 rows, chunk 32)."""
    x_te, x_tr, alpha = _data((29, 147, 5), seed=4)
    jcfg = jdsekl.DSEKLConfig(kernel=kernel, kernel_params=params, impl=impl)
    tcfg = tdsekl.DSEKLConfig(kernel=kernel, kernel_params=params, impl="ref")
    want = jdsekl.decision_function(jcfg, jnp.asarray(alpha),
                                    jnp.asarray(x_tr), jnp.asarray(x_te),
                                    chunk=32, method=method)
    got = tdsekl.decision_function(tcfg, *_t(alpha, x_tr, x_te), chunk=32,
                                   method=method)
    _close(got.numpy(), want)


def test_decision_function_ref_pads_only_ragged_multi_chunk():
    """A single short chunk is not padded; a ragged tail of several is."""
    x_te, x_tr, alpha = _data((5, 20, 3), seed=5)
    cfg = tdsekl.DSEKLConfig(impl="ref")
    calls = []
    orig = tops.kernel_matvec

    def spy(x, z, a, **kw):
        calls.append(z.shape[0])
        return orig(x, z, a, **kw)

    tops.kernel_matvec = spy
    try:
        tdsekl.decision_function_ref(cfg, *_t(alpha, x_tr, x_te), chunk=32)
        tdsekl.decision_function_ref(cfg, *_t(alpha, x_tr, x_te), chunk=8)
    finally:
        tops.kernel_matvec = orig
    assert calls == [20, 8, 8, 8]


def test_predict_labels_and_truncate_match_jax():
    f = np.array([-1.5, 0.0, 2.0, -0.0, 1e-9], np.float32)
    np.testing.assert_array_equal(
        tdsekl.predict_labels(torch.from_numpy(f)).numpy(),
        np.asarray(jdsekl.predict_labels(jnp.asarray(f))))
    _, x, alpha = _data((1, 40, 3), seed=6)
    alpha[::3] = 0.0
    alpha[1] = 1e-9                                  # below the 1e-8 tol
    ja, jx = jdsekl.truncate(jnp.asarray(alpha), jnp.asarray(x))
    ta, tx = tdsekl.truncate(*_t(alpha, x))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(
        tdsekl.support_vectors(torch.from_numpy(alpha)).numpy(),
        np.asarray(jdsekl.support_vectors(jnp.asarray(alpha))))


def test_resolve_impl():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tops.resolve_impl("auto", "rbf", cpu) == "ref"
    assert tops.resolve_impl("auto", "rbf", cuda) == "cuda"
    assert tops.resolve_impl("ref", "rbf", cuda) == "ref"
    with pytest.raises(ValueError):
        tops.resolve_impl("pallas", "rbf", cpu)
    with pytest.raises(ValueError):            # no silent fallback to ref
        tops.resolve_impl("auto", "cosine", cuda)


def test_resolve_impl_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IMPL", "ref")
    assert tops.resolve_impl("auto", "rbf", torch.device("cuda")) == "ref"
    monkeypatch.setenv("REPRO_TORCH_IMPL", "pallas")
    with pytest.raises(ValueError):
        tops.resolve_impl("auto", "rbf", torch.device("cpu"))
    monkeypatch.setenv("REPRO_IMPL", "pallas_interpret")   # the JAX leg's
    monkeypatch.delenv("REPRO_TORCH_IMPL")
    assert tops.resolve_impl("auto", "rbf", torch.device("cpu")) == "ref"


@pytest.mark.parametrize("n_rows,n_cols,resident,want", [
    (1024, 282624, 396, (24, 184)),   # 16 row tiles -> 24 splits, one wave
    (1000, 5003, 528, (27, 3)),
    (64, 64, 528, (1, 1)),
    (5000, 64, 100, (1, 1)),          # more row tiles than resident blocks
    (10, 0, 528, (1, 0)),             # empty support set
])
def test_split_support(n_rows, n_cols, resident, want):
    n_split, per = tblock.split_support(n_rows, n_cols, resident)
    assert (n_split, per) == want
    col_tiles = -(-n_cols // 64)
    assert n_split * per >= col_tiles and (n_split - 1) * per < max(col_tiles, 1)
    assert n_split * -(-n_rows // 64) <= max(resident, -(-n_rows // 64))


def test_tile_params_defaults_and_unknown():
    assert tblock.tile_params("polynomial", {"degree": 2}) == {
        "gamma": 1.0, "coef0": 1.0, "degree": 2}
    assert tblock.tile_params("linear", None) == {}
    with pytest.raises(TypeError):
        tblock.tile_params("rbf", {"length_scale": 1.0})
    with pytest.raises(ValueError):
        tblock.tile_params("cosine", None)

