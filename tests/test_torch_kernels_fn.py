"""Port kernel registry (``repro_torch.core.kernels_fn``) vs the JAX one
(``repro.core.kernels_fn``): the seven kernels and ``sq_dists`` on the
same numpy inputs, at the JAX suite's float32 tolerance (rtol 2e-4, atol
1e-5 x max(1, |oracle|_inf), tests/test_dual_pass.py ``_tols``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_fn as jkf
from repro_torch.core import kernels_fn as tkf

KERNEL_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 1.0), ("degree", 2))),
    # Integral odd degree over negative bases (coef0 0): integer_pow.
    ("polynomial", (("gamma", 0.5), ("coef0", 0.0), ("degree", 3))),
    # Non-integral degree over positive bases: pow.
    ("polynomial", (("gamma", 0.1), ("coef0", 2.0), ("degree", 2.5))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
SHAPES = [(8, 8, 2), (37, 130, 7)]


def _tols(ref):
    return 2e-4, 1e-5 * max(1.0, float(np.abs(ref).max()))


def _data(shape, seed=0):
    n, m, d = shape
    rng = np.random.default_rng(seed + 1000 * n + m)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


def test_registry_matches_jax():
    assert list(tkf.KERNELS) == list(jkf.KERNELS)


@pytest.mark.parametrize("shape", SHAPES)
def test_sq_dists_matches_jax(shape):
    x, y = _data(shape)
    want = np.asarray(jkf.sq_dists(jnp.asarray(x), jnp.asarray(y)))
    got = tkf.sq_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    rtol, atol = _tols(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # The max(., 0) clamp: identical rows give exactly 0, never negative.
    same = tkf.sq_dists(torch.from_numpy(x), torch.from_numpy(x))
    assert bool((same >= 0).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(KERNEL_CASES)])
def test_kernel_matches_jax(kernel, params, shape):
    x, y = _data(shape, seed=len(params))
    want = np.asarray(jkf.get_kernel(kernel, **dict(params))(
        jnp.asarray(x), jnp.asarray(y)))
    got = tkf.get_kernel(kernel, **dict(params))(
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    rtol, atol = _tols(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_matern_self_distance_epsilon():
    """The +1e-12 inside the Matérn kernels keeps k(x, x) finite and 1."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    for name in ("matern32", "matern52"):
        k = tkf.get_kernel(name)(x, x)
        np.testing.assert_allclose(torch.diagonal(k).numpy(), 1.0, atol=1e-5)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        tkf.get_kernel("cosine")
