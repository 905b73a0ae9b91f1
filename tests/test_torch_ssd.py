"""The port's SSD op on its plain path (``impl="ref"``, the sequential
recurrence) against the JAX package's ``ssd_chunked`` with ``impl="ref"``
and ``impl="pallas_interpret"`` (the TPU kernel run in interpret mode) and
against ``models/ssm.ssd`` (the XLA chunked scan the JAX model runs), on
the dims of ``tests/test_kernels_models.py`` plus a length no chunk
divides.  Inputs are made with numpy from a seed and handed to both.

Tolerance: the JAX suite's own, rtol 1e-4 and atol 1e-4 (float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_chunked as jax_ssd_chunked
from repro.models.ssm import ssd as jax_ssd_xla
from repro_torch.kernels.ssd import ssd_chunked

TOL = dict(rtol=1e-4, atol=1e-4)
DIMS = [
    # (b, s, nh, hd, g, n, chunk)
    (2, 64, 4, 16, 2, 8, 16),
    (1, 128, 2, 32, 1, 16, 32),
    (2, 64, 4, 16, 4, 8, 64),
    (1, 96, 4, 64, 1, 16, 32),
]


def _inputs(dims, seed=0):
    b, s, nh, hd, g, n = dims[:6]
    rng = np.random.default_rng(seed + sum(dims))
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    bmat = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cmat = rng.standard_normal((b, s, g, n)).astype(np.float32)
    arrs = (x, dt, a, bmat, cmat)
    return [jnp.asarray(v) for v in arrs], [torch.from_numpy(v) for v in arrs]


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_ref_matches_jax_ref_pallas_and_xla(dims):
    chunk = dims[6]
    jin, tin = _inputs(dims)
    y, final = ssd_chunked(*tin, chunk=chunk, impl="ref")
    b, s, nh, hd, g, n = dims[:6]
    assert y.shape == (b, s, nh, hd) and final.shape == (b, nh, hd, n)
    assert y.dtype == final.dtype == torch.float32
    for impl in ("ref", "pallas_interpret"):
        wy, wf = jax_ssd_chunked(*jin, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(wf), **TOL)
    wy, wf = jax_ssd_xla(*jin, jnp.zeros((b, nh, hd, n)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(wf), **TOL)


def test_ragged_length_matches_jax():
    """S = 72 with chunk 32: the kernel runs a partial last chunk, the XLA
    scan halves the chunk to 8; both are the recurrence."""
    dims = (2, 72, 4, 16, 2, 8, 32)
    jin, tin = _inputs(dims)
    y, final = ssd_chunked(*tin, chunk=32, impl="ref")
    wy, wf = jax_ssd_chunked(*jin, impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(wf), **TOL)
    b, s, nh, hd, g, n = dims[:6]
    wy, wf = jax_ssd_xla(*jin, jnp.zeros((b, nh, hd, n)), 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(wf), **TOL)


def test_cuda_impl_on_cpu_tensors_raises():
    from repro_torch.kernels.ssd import kernel
    _, tin = _inputs(DIMS[0])
    before = kernel.ssd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_chunked(*tin, impl="cuda")
    assert kernel.ssd_cuda.launches == before
