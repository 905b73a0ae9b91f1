"""The port's flash-attention op on its plain path (``impl="ref"``)
against the JAX package's ``flash_attention`` with ``impl="ref"`` and
``impl="pallas_interpret"`` (the TPU kernel run in interpret mode), on the
shapes of ``tests/test_kernels_models.py::test_flash_attention_matches_ref``
plus ragged lengths and ``window=0``.  Inputs are made with numpy from a
seed and handed to both.

Tolerances are the JAX suite's own: 2e-6 in float32 and 3e-2 in bfloat16
(against the kernel); the two plain versions agree to 2e-6 in float32 and
to one bfloat16 rounding of the output (8e-3 relative) in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attn import flash_attention

SHAPES = [
    # (b, s, t, h, kv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, 1 << 30),
    (1, 256, 256, 2, 2, 32, True, 64),
    (2, 128, 256, 4, 1, 64, False, 1 << 30),
    (1, 128, 128, 2, 2, 128, True, 1 << 30),
    (2, 24, 24, 4, 1, 16, True, 16),          # ragged: the CPU model's S
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed=0):
    b, s, t, h, kv, d = shape[:6]
    rng = np.random.default_rng(seed + s + t + h)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_ref_and_pallas_interpret(shape, dtype):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (q, k, v) = _inputs(shape, dtype)
    got = flash_attention(q, k, v, causal=causal, window=window, impl="ref")
    assert got.dtype == q.dtype and got.shape == q.shape
    want_ref = jax_flash(jq, jk, jv, causal=causal, window=window, impl="ref")
    want_pal = jax_flash(jq, jk, jv, causal=causal, window=window,
                         impl="pallas_interpret")
    ref_tol = 2e-6 if dtype == "float32" else 8e-3
    pal_tol = 2e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want_ref), rtol=ref_tol,
                               atol=ref_tol)
    np.testing.assert_allclose(_np(got), _np(want_pal), rtol=pal_tol,
                               atol=pal_tol)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_jax_ref(causal):
    """S = T = 200: no 128-block divides it, so only the JAX oracle takes
    it; the port's kernel masks the tail instead."""
    shape = (1, 200, 200, 4, 2, 64, causal, 64)
    (jq, jk, jv), (q, k, v) = _inputs(shape, "float32")
    got = flash_attention(q, k, v, causal=causal, window=64, impl="ref")
    want = jax_flash(jq, jk, jv, causal=causal, window=64, impl="ref")
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_window_zero_matches_jax_and_gives_mean_v(causal):
    """window=0 leaves a causal row no valid key: the TPU kernel's -1e30
    scores give it the mean of v over all T keys (not 0)."""
    shape = (2, 128, 128, 4, 2, 32, causal, 0)
    (jq, jk, jv), (q, k, v) = _inputs(shape, "float32")
    got = flash_attention(q, k, v, causal=causal, window=0, impl="ref")
    for impl in ("ref", "pallas_interpret"):
        want = jax_flash(jq, jk, jv, causal=causal, window=0, impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-6)
    mean_v = torch.repeat_interleave(v, 2, dim=2).mean(dim=1)   # (B,H,D)
    if causal:          # every row is fully masked
        rows = got
    else:               # only the last query row (no key after it) is
        rows = got[:, -1:]
    np.testing.assert_allclose(
        rows.numpy(), mean_v[:, None].expand_as(rows).numpy(),
        rtol=1e-6, atol=1e-6)


def test_cuda_impl_on_cpu_tensors_raises():
    from repro_torch.kernels.flash_attn import kernel
    _, (q, k, v) = _inputs(SHAPES[0], "float32")
    before = kernel.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, k, v, impl="cuda")
    assert kernel.flash_attention_cuda.launches == before
