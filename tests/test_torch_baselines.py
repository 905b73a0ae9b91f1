"""The port's baselines (``repro_torch.core.baselines``: RKS, EmpFix, the
batch SVM) against the JAX package's, on the CPU, from numpy inputs made
from a seed (n 256, d 8).

JAX draws RKS's features, EmpFix's landmarks and each step's I from keys.
The tests build the JAX models, carry them across with
``convert.rks_from_jax`` / ``emp_fix_from_jax``, and replay each step's I
with JAX's own ``sampler.sample_uniform`` on the key the JAX step is given
(``fold_in(key, t)``), so both packages see the same numbers.

Tolerance: the JAX suite's float32 one, rtol 2e-4, atol 1e-5 x
max(1, |oracle|_inf).  Each gate also checks that the atol sits at least
100x below the median |value| it compares, so a zero or flipped answer
fails.  Trajectories run 16 steps of the smooth losses (square, logistic)
and 2 of hinge, whose subgradient flips on ulp-level differences at
y*f = 1.  The EmpFix step runs the JAX side through its plain reference
(``impl="ref"``; ``kernel_matvec_pallas`` is held to it by the JAX suite).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import sampler as jsampler
from repro.core.dsekl import DSEKLConfig as JConfig
from repro_torch import convert
from repro_torch.core import baselines as tb
from repro_torch.core.dsekl import DSEKLConfig

N, D, NG, N_FEAT, N_LAND = 256, 8, 32, 64, 32
GAMMA = 0.25
RTOL, ATOL = 2e-4, 1e-5


def _cfgs(loss, **kw):
    base = dict(n_grad=NG, n_expand=N_LAND, kernel="rbf",
                kernel_params=(("gamma", GAMMA),), loss=loss, lam=1e-3,
                lr0=0.5)
    base.update(kw)
    return JConfig(impl="ref", **base), DSEKLConfig(**base)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                 -1.0).astype(np.float32)
    return x, y


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    med = float(np.median(np.abs(want)))
    assert med >= 100 * atol, (
        f"median |ref| {med:.3e} is not 100x the atol {atol:.3e}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _steps(loss):
    return 2 if loss == "hinge" else 16


def _keys(steps, seed=1):
    base = jax.random.PRNGKey(seed)
    return [jax.random.fold_in(base, t) for t in range(steps)]


def _idx(key):
    return torch.from_numpy(np.array(
        jsampler.sample_uniform(key, N, NG))).to(torch.int64)


@pytest.mark.parametrize("loss", ["square", "logistic", "hinge"])
def test_rks_trajectory_matches_jax(data, loss):
    x, y = data
    jcfg, tcfg = _cfgs(loss)
    jm = jb.rks_init(jax.random.PRNGKey(0), D, N_FEAT, GAMMA)
    tm = convert.rks_from_jax(jm, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for key in _keys(_steps(loss)):
        jm = jb.rks_step(jcfg, jm, jnp.asarray(x), jnp.asarray(y), key)
        tm = tb.rks_step(tcfg, tm, tx, ty, _idx(key))
    assert int(tm.step) == int(jm.step) == _steps(loss)
    _close(tm.weights.numpy(), jm.weights)
    _close(tb.rks_decision(tm, tx).numpy(), jb.rks_decision(jm,
                                                            jnp.asarray(x)))


def test_rks_features_match_jax(data):
    x, _ = data
    jm = jb.rks_init(jax.random.PRNGKey(3), D, N_FEAT, GAMMA)
    tm = convert.rks_from_jax(jm, device="cpu")
    _close(tb.rks_features(torch.from_numpy(x), tm.w_feat, tm.b_feat),
           jb.rks_features(jnp.asarray(x), jm.w_feat, jm.b_feat))


@pytest.mark.parametrize("loss", ["square", "logistic", "hinge"])
def test_emp_fix_trajectory_matches_jax(data, loss):
    x, y = data
    jcfg, tcfg = _cfgs(loss)
    jm = jb.emp_fix_init(jax.random.PRNGKey(0), jnp.asarray(x), N_LAND)
    tm = convert.emp_fix_from_jax(jm, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for key in _keys(_steps(loss)):
        jm = jb.emp_fix_step(jcfg, jm, jnp.asarray(x), jnp.asarray(y), key)
        tm = tb.emp_fix_step(tcfg, tm, tx, ty, _idx(key))
    assert int(tm.step) == int(jm.step)
    np.testing.assert_array_equal(tm.landmarks.numpy(), jm.landmarks)
    _close(tm.alpha.numpy(), jm.alpha)
    _close(tb.emp_fix_decision(tcfg, tm, tx).numpy(),
           jb.emp_fix_decision(jcfg, jm, jnp.asarray(x)))


def test_emp_fix_init_takes_indices_or_draws_distinct_rows(data):
    x, _ = data
    tx = torch.from_numpy(x)
    idx = np.random.default_rng(2).choice(N, N_LAND, replace=False)
    m = tb.emp_fix_init(None, tx, N_LAND, indices=torch.from_numpy(idx))
    np.testing.assert_array_equal(m.landmarks.numpy(), x[idx])
    assert m.alpha.shape == (N_LAND,) and not m.alpha.any()
    drawn = tb.emp_fix_init(torch.Generator().manual_seed(0), tx, N_LAND)
    rows = {tuple(r) for r in drawn.landmarks.numpy().tolist()}
    assert len(rows) == N_LAND
    again = tb.emp_fix_init(torch.Generator().manual_seed(0), tx, N_LAND)
    assert torch.equal(drawn.landmarks, again.landmarks)


def test_rks_init_shapes_and_ranges():
    m = tb.rks_init(torch.Generator().manual_seed(0), D, 4096, GAMMA,
                    device="cpu")
    assert m.w_feat.shape == (D, 4096) and m.b_feat.shape == (4096,)
    assert float(m.b_feat.min()) >= 0.0
    assert float(m.b_feat.max()) <= 2 * np.pi
    assert abs(float(m.w_feat.std()) - np.sqrt(2 * GAMMA)) < 0.02
    assert not m.weights.any() and int(m.step) == 0


@pytest.mark.parametrize("loss", ["square", "hinge"])
def test_batch_svm_matches_jax(data, loss):
    x, y = data
    jcfg, tcfg = _cfgs(loss)
    xs, ys = x[:128], y[:128]
    want = jb.batch_svm_fit(jcfg, jnp.asarray(xs), jnp.asarray(ys),
                            n_iters=20, lr0=0.5)
    got = tb.batch_svm_fit(tcfg, torch.from_numpy(xs), torch.from_numpy(ys),
                           n_iters=20, lr0=0.5)
    _close(got.numpy(), want)
    _close(tb.batch_svm_decision(tcfg, got, torch.from_numpy(xs),
                                 torch.from_numpy(x)).numpy(),
           jb.batch_svm_decision(jcfg, want, jnp.asarray(xs),
                                 jnp.asarray(x)))
