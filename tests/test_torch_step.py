"""Algorithm 1's step in the port vs the JAX package, on shared indices.

* ``grad_block`` and ``apply_update`` for every schedule (``inv_t``,
  ``inv_epoch``, ``const``, ``adagrad``), ``unbiased_scaling`` on and off,
  on the fused, two-pass and streamed gradient paths;
* a block whose J indices are deliberately duplicated: the scatter must
  add duplicates together as JAX's ``.at[idx].add`` does (and under
  adagrad, read the accumulated G_jj back for every duplicate);
* ``step_serial`` on the indices JAX's ``step_serial`` draws from its key.

Tolerance: the JAX suite's float32 one, rtol 2e-4, atol 1e-5 x max(1,
|oracle|_inf); step and epoch counters exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro_torch.core import dsekl as td

SCHEDULES = ["inv_t", "inv_epoch", "const", "adagrad"]
N, D, NG, NE = 40, 5, 9, 11


def _problem(seed=0, loss="hinge"):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((N, D)).astype(f32)
    if loss == "square":
        y = rng.standard_normal(N).astype(f32)
    else:
        y = np.where(rng.standard_normal(N) >= 0, 1.0, -1.0).astype(f32)
    alpha = (rng.standard_normal(N) * 0.3).astype(f32)
    accum = (1.0 + rng.random(N)).astype(f32)
    idx_i = rng.integers(0, N, NG)
    idx_j = rng.integers(0, N, NE)
    return x, y, alpha, accum, idx_i, idx_j


def _states(alpha, accum, step=6, epoch=2):
    js = jd.DSEKLState(jnp.asarray(alpha), jnp.asarray(accum),
                       jnp.asarray(step, jnp.int32),
                       jnp.asarray(epoch, jnp.int32))
    ts = td.DSEKLState(torch.from_numpy(alpha.copy()),
                       torch.from_numpy(accum.copy()),
                       torch.tensor(step, dtype=torch.int32),
                       torch.tensor(epoch, dtype=torch.int32))
    return js, ts


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=1e-5 * scale)


def _same_state(ts, js):
    _close(ts.alpha, js.alpha)
    _close(ts.accum, js.accum)
    assert int(ts.step) == int(js.step)
    assert int(ts.epoch) == int(js.epoch)


def _cfgs(**kw):
    base = dict(n_grad=NG, n_expand=NE, kernel="rbf",
                kernel_params=(("gamma", 0.5),), lam=0.01, lr0=0.7)
    base.update(kw)
    return jd.DSEKLConfig(impl="ref", **base), td.DSEKLConfig(**base)


@pytest.mark.parametrize("unbiased", [False, True], ids=["plain", "unbiased"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_grad_block_and_apply_update_match_jax(schedule, unbiased):
    x, y, alpha, accum, idx_i, idx_j = _problem(seed=1)
    jcfg, tcfg = _cfgs(schedule=schedule, unbiased_scaling=unbiased)
    blocks = (x[idx_i], y[idx_i], x[idx_j], alpha[idx_j])
    n = jd.scale_n(jcfg, N)
    assert td.scale_n(tcfg, N) == n
    jg = jd.grad_block(jcfg, *[jnp.asarray(b) for b in blocks], n)
    tg = td.grad_block(tcfg, *[torch.from_numpy(b) for b in blocks], n)
    _close(tg, jg)
    js, ts = _states(alpha, accum)
    js = jd.apply_update(jcfg, js, jnp.asarray(idx_j), jg)
    ts = td.apply_update(tcfg, ts, torch.from_numpy(idx_j), tg)
    _same_state(ts, js)


@pytest.mark.parametrize("path", ["two_pass", "stream"])
def test_grad_block_paths_match_jax(path):
    """The two-pass matvec + vecmat body and the streamed ref pass."""
    x, y, alpha, _, idx_i, idx_j = _problem(seed=2, loss="square")
    kw = dict(loss="square", unbiased_scaling=True)
    if path == "two_pass":
        kw["fuse_dual_pass"] = False
    else:
        kw["stream_row_block"] = 4
    jcfg, tcfg = _cfgs(**kw)
    blocks = (x[idx_i], y[idx_i], x[idx_j], alpha[idx_j])
    _close(td.grad_block(tcfg, *[torch.from_numpy(b) for b in blocks], N),
           jd.grad_block(jcfg, *[jnp.asarray(b) for b in blocks], N))


@pytest.mark.parametrize("schedule", ["adagrad", "inv_t"])
def test_duplicated_j_indices_accumulate_like_jax(schedule):
    """J is drawn with replacement: duplicate indices must add, as
    ``.at[idx].add`` does; ``alpha[idx] += g`` would keep one of them."""
    x, y, alpha, accum, idx_i, _ = _problem(seed=3)
    idx_j = np.array([3, 3, 5, 3, 7, 5, 0, 39, 39, 12, 3])
    jcfg, tcfg = _cfgs(schedule=schedule)
    blocks = (x[idx_i], y[idx_i], x[idx_j], alpha[idx_j])
    jg = jd.grad_block(jcfg, *[jnp.asarray(b) for b in blocks])
    tg = td.grad_block(tcfg, *[torch.from_numpy(b) for b in blocks])
    js, ts = _states(alpha, accum)
    js = jd.apply_update(jcfg, js, jnp.asarray(idx_j), jg)
    ts = td.apply_update(tcfg, ts, torch.from_numpy(idx_j), tg)
    _same_state(ts, js)
    # Index 3 is drawn four times: its update is the sum of four
    # gradient entries, not one of them.
    g = tg.numpy()
    summed = torch.from_numpy(alpha.copy()).index_add(
        0, torch.from_numpy(idx_j), torch.from_numpy(g))
    assert float(summed[3]) == pytest.approx(
        alpha[3] + g[[0, 1, 3, 10]].sum(), rel=1e-6)


@pytest.mark.parametrize("loss,schedule", [("hinge", "inv_t"),
                                           ("logistic", "adagrad"),
                                           ("square", "const")])
def test_step_serial_matches_jax_on_its_own_indices(loss, schedule):
    """JAX's step draws I and J from its key (``split`` then
    ``sample_uniform``); the port's step takes those very indices."""
    x, y, alpha, accum, _, _ = _problem(seed=4, loss=loss)
    jcfg, tcfg = _cfgs(schedule=schedule, loss=loss)
    key = jax.random.PRNGKey(7)
    ki, kj = jax.random.split(key)
    idx_i = np.array(jsampler.sample_uniform(ki, N, NG))
    idx_j = np.array(jsampler.sample_uniform(kj, N, NE))
    js, ts = _states(alpha, accum)
    js = jd.step_serial(jcfg, js, jnp.asarray(x), jnp.asarray(y), key)
    ts = td.step_serial(tcfg, ts, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(idx_i), torch.from_numpy(idx_j))
    _same_state(ts, js)


def test_lr_is_a_device_tensor_read_after_the_increment():
    _, tcfg = _cfgs(schedule="inv_t", lr0=2.0)
    _, ts = _states(np.zeros(N, np.float32), np.ones(N, np.float32), step=0)
    lr = td._lr(tcfg, ts._replace(step=ts.step + 1))
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    assert float(lr) == 2.0
    with pytest.raises(ValueError):
        td._lr(tcfg.replace(schedule="cosine"), ts)
