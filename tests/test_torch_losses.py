"""The port's losses vs the JAX package's, on the same numpy inputs.

``value`` and ``grad_f`` of all four losses at the JAX suite's float32
tolerance (rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf)), on decision values
that include the hinge kink y*f == 1 exactly (where both subgradients must
be exactly 0) and labels y == 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

NAMES = sorted(jl.LOSSES)


def _inputs():
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.standard_normal(40) * 3,
                        [1.0, -1.0, 0.5, 2.0, 0.0, 1.0, 40.0, -40.0]])
    y = np.concatenate([np.sign(rng.standard_normal(40)),
                        [1.0, -1.0, 2.0, 0.5, 1.0, 0.0, -1.0, 1.0]])
    return f.astype(np.float32), y.astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name):
    f, y = _inputs()
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    tf, ty = torch.from_numpy(f), torch.from_numpy(y)
    _close(tloss.value(tf, ty), jloss.value(jnp.asarray(f), jnp.asarray(y)))
    _close(tloss.grad_f(tf, ty), jloss.grad_f(jnp.asarray(f), jnp.asarray(y)))
    assert tloss.binary_labels == jloss.binary_labels


@pytest.mark.parametrize("name", ["hinge", "squared_hinge"])
def test_hinge_kink_is_exactly_zero(name):
    """At y*f == 1 exactly the hinge subgradient is 0 (strict <), and so is
    the squared hinge's gradient; a y == 0 label gives 0 for both."""
    f = np.array([1.0, -1.0, 0.5, 3.0], np.float32)
    y = np.array([1.0, -1.0, 2.0, 0.0], np.float32)
    got = tl.get_loss(name).grad_f(torch.from_numpy(f), torch.from_numpy(y))
    want = np.asarray(jl.get_loss(name).grad_f(jnp.asarray(f), jnp.asarray(y)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.abs().any()


def test_registry_and_codes():
    assert list(tl.LOSSES) == list(jl.LOSSES)
    # The CUDA train pass's enum Loss (csrc/dsekl_train.cu).
    assert tl.LOSS_CODES == {"hinge": 0, "squared_hinge": 1, "square": 2,
                             "logistic": 3}
    with pytest.raises(ValueError):
        tl.get_loss("huber")
