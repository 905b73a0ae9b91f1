"""The port's doubly stochastic kernel PCA (``repro_torch.core.kpca``)
against the JAX package's, on the CPU, from numpy inputs made from a seed
(n 256, d 8, r 4, |J| 64).

JAX draws the initial subspace and each step's J from keys.  The tests
start both packages from JAX's v0 (``convert.kpca_state_from_jax``) and
replay each step's J with JAX's ``sampler.sample_uniform`` on the key
``fit`` gives that step (``fold_in(key, i + 1)``).

Tolerance: the JAX suite's float32 one, rtol 2e-4, atol 1e-5 x
max(1, |oracle|_inf), column by column (both packages fix the QR's signs
by sign(diag(R))), and the subspaces' principal-angle cosines within 1e-5
of 1.  Each gate also checks that the atol sits at least 100x below the
median |value| it compares.  The JAX side runs its matvec through its
plain reference (``impl="ref"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kpca as jk
from repro.core import sampler as jsampler
from repro_torch import convert
from repro_torch.core import kpca as tk

N, D, R, NE = 256, 8, 4, 64
RTOL, ATOL = 2e-4, 1e-5
KW = dict(n_components=R, n_grad=NE, n_expand=NE, kernel="rbf",
          kernel_params=(("gamma", 0.25),), lr0=0.5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, rng.standard_normal((100, D)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(data):
    """JAX's v0 and its state after each of 3 steps, with their J."""
    x, _ = data
    jcfg = jk.KPCAConfig(impl="ref", **KW)
    key = jax.random.PRNGKey(0)
    state = jk.init_state(jax.random.fold_in(key, 0), N, jcfg)
    states, plans = [state], []
    for i in range(3):
        k = jax.random.fold_in(key, i + 1)
        plans.append(np.array(jsampler.sample_uniform(k, N, NE)))
        state = jk.step(jcfg, state, jnp.asarray(x), k)
        states.append(state)
    return jcfg, states, plans


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    med = float(np.median(np.abs(want)))
    assert med >= 100 * atol, (
        f"median |ref| {med:.3e} is not 100x the atol {atol:.3e}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _cosines(a, b):
    """Principal-angle cosines between the column spans of a and b."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_block_action_matches_jax(data, jax_run):
    x, _ = data
    jcfg, states, plans = jax_run
    idx = plans[0]
    v = np.asarray(states[0].v)
    want = jk._block_action(jcfg, jnp.asarray(x), jnp.asarray(x[idx]),
                            jnp.asarray(v[idx]), N)
    got = tk._block_action(tk.KPCAConfig(**KW), torch.from_numpy(x),
                           torch.from_numpy(x[idx]),
                           torch.from_numpy(v[idx]), N)
    _close(got.numpy(), want)


def test_three_steps_match_jax(data, jax_run):
    x, _ = data
    jcfg, states, plans = jax_run
    cfg = tk.KPCAConfig(**KW)
    state = convert.kpca_state_from_jax(states[0], device="cpu")
    tx = torch.from_numpy(x)
    for i, idx in enumerate(plans):
        state = tk.step(cfg, state, tx, torch.from_numpy(idx))
        want = np.asarray(states[i + 1].v)
        assert int(state.step) == i + 1
        _close(state.v.numpy(), want)
        np.testing.assert_allclose(_cosines(state.v.numpy(), want), 1.0,
                                   atol=1e-5)
    gram = state.v.double().T @ state.v.double()
    np.testing.assert_allclose(gram.numpy(), np.eye(R), atol=1e-5)


def test_fit_on_plans_equals_the_steps(data, jax_run):
    x, _ = data
    _, states, plans = jax_run
    cfg = tk.KPCAConfig(**KW)
    tx = torch.from_numpy(x)
    v0 = torch.from_numpy(np.array(states[0].v))
    fitted = tk.fit(cfg, tx, None, 3, plans=plans, v0=v0)
    state = tk.init_state(None, N, cfg, "cpu", v0=v0)
    for idx in plans:
        state = tk.step(cfg, state, tx, torch.from_numpy(idx))
    assert torch.equal(fitted.v, state.v) and int(fitted.step) == 3
    drawn = tk.fit(cfg, tx, torch.Generator().manual_seed(0), 2)
    again = tk.fit(cfg, tx, torch.Generator().manual_seed(0), 2)
    assert torch.equal(drawn.v, again.v) and drawn.v.shape == (N, R)


@pytest.mark.parametrize("n_train", [N, 4096 + 100])
def test_transform_matches_jax(data, jax_run, n_train):
    """One chunk, and two (the second ragged) past 4,096 rows."""
    x, xq = data
    jcfg, states, _ = jax_run
    rng = np.random.default_rng(1)
    if n_train == N:
        xt, v = x, np.array(states[-1].v)
    else:
        xt = rng.standard_normal((n_train, D)).astype(np.float32)
        v = (rng.standard_normal((n_train, R)) / 64).astype(np.float32)
    want = jk.transform(jcfg, jk.KPCAState(jnp.asarray(v), jnp.int32(3)),
                        jnp.asarray(xt), jnp.asarray(xq))
    tstate = tk.KPCAState(torch.from_numpy(v), torch.tensor(3))
    got = tk.transform(tk.KPCAConfig(**KW), tstate, torch.from_numpy(xt),
                       torch.from_numpy(xq))
    _close(got.numpy(), want)
