"""The port's serial ``fit`` vs the JAX package's, on JAX's own plans.

The port cannot draw threefry numbers, so the test draws each epoch's
index plan with JAX's key chain, exactly as ``trainer.fit_loop`` and
``_epoch_serial`` sample (per epoch ``key, sub = split(key)``, then
``sampler.epoch_plan(sub, n, n_grad, n_expand, steps)``), and hands the
plans to the port's ``fit(plans=...)``.

Trajectory tolerance: the op tolerance of the JAX suite, rtol 2e-4, atol
1e-5 x max(1, |oracle|_inf), on alpha and accum after 2 epochs of 16
steps.  Both sides are float32 on the CPU but sum in different orders
(XLA vs PyTorch products) and each step feeds alpha into the next step's
f; at these sizes that compounds to ~2e-7 absolute, far inside the
tolerance.  Smooth losses only (square, logistic): the hinge subgradient
flips on ulp-level differences at y*f == 1, so hinge runs 2 steps.
``val_error`` may differ by at most one flipped label (1/n_val): a
validation decision value within the tolerance of 0 may take either sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro.core import trainer as jtrainer
from repro.core.solver import fit as jfit
from repro_torch.core import dsekl as td
from repro_torch.core import trainer as ttrainer
from repro_torch.core.solver import error_rate, fit

D, NG, NE, N_VAL = 5, 4, 6, 32
RTOL, ATOL = 2e-4, 1e-5


def _problem(n, seed=0, loss="square"):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n + N_VAL, D)).astype(f32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                 -1.0).astype(f32)
    return x[:n], y[:n], x[n:], y[n:]


def jax_plans(key, n_epochs, n, n_grad=NG, n_expand=NE):
    steps = max(n // n_grad, 1)
    plans = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        i, j = jsampler.epoch_plan(sub, n, n_grad, n_expand, steps)
        plans.append((np.array(i), np.array(j)))
    return plans


def _cfgs(**kw):
    base = dict(n_grad=NG, n_expand=NE, kernel="rbf",
                kernel_params=(("gamma", 0.5),), lam=1e-3, lr0=0.5)
    base.update(kw)
    return jd.DSEKLConfig(impl="ref", **base), td.DSEKLConfig(**base)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


def _fit_both(jcfg, tcfg, n, n_epochs, seed=0, loss="square", **kw):
    x, y, xv, yv = _problem(n, seed, loss)
    key = jax.random.PRNGKey(seed)
    jres = jfit(jcfg, jnp.asarray(x), jnp.asarray(y), key,
                execution="serial", n_epochs=n_epochs, x_val=jnp.asarray(xv),
                y_val=jnp.asarray(yv), **kw)
    tres = fit(tcfg, x, y, plans=jax_plans(key, n_epochs, n),
               n_epochs=n_epochs, x_val=xv, y_val=yv, device="cpu", **kw)
    return jres, tres


@pytest.mark.parametrize("loss,schedule", [("square", "adagrad"),
                                           ("logistic", "inv_t"),
                                           ("square", "inv_epoch")])
def test_fit_trajectory_matches_jax(loss, schedule):
    jcfg, tcfg = _cfgs(loss=loss, schedule=schedule)
    jres, tres = _fit_both(jcfg, tcfg, 16 * NG, 2, loss=loss, tol=0.0)
    _close(tres.state.alpha, jres.state.alpha)
    _close(tres.state.accum, jres.state.accum)
    assert int(tres.state.step) == int(jres.state.step) == 32
    assert int(tres.state.epoch) == int(jres.state.epoch) == 2
    assert tres.epochs_run == jres.epochs_run == 2
    for th, jh in zip(tres.history, jres.history, strict=True):
        assert th["epoch"] == jh["epoch"]
        assert th["delta_alpha"] == pytest.approx(jh["delta_alpha"],
                                                  rel=RTOL)
        assert abs(th["val_error"] - jh["val_error"]) <= 1.0 / N_VAL + 1e-9


def test_fit_hinge_two_steps_matches_jax():
    jcfg, tcfg = _cfgs(loss="hinge", schedule="adagrad")
    jres, tres = _fit_both(jcfg, tcfg, 2 * NG, 1, loss="hinge", tol=0.0)
    _close(tres.state.alpha, jres.state.alpha)
    _close(tres.state.accum, jres.state.accum)
    assert int(tres.state.step) == int(jres.state.step) == 2


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_truncate_smallest_with_ties_matches_jax(frac):
    """Rank-based with a stable argsort: exactly k of the tied entries
    go, the earliest positions first."""
    alpha = np.array([0.0, 0.5, -0.5, 0.5, 0.2, -0.2, 0.0, 0.5, 1.0, 0.2],
                     np.float32)
    want = np.asarray(jtrainer._truncate_smallest(jnp.asarray(alpha), frac))
    got = ttrainer._truncate_smallest(torch.from_numpy(alpha), frac)
    np.testing.assert_array_equal(got.numpy(), want)


def test_truncation_inside_fit_matches_jax():
    jcfg, tcfg = _cfgs(loss="square", schedule="adagrad")
    jres, tres = _fit_both(jcfg, tcfg, 16 * NG, 2, tol=0.0,
                           truncate_every=1, truncate_frac=0.3)
    _close(tres.state.alpha, jres.state.alpha)
    assert int((tres.state.alpha == 0).sum()) == int(
        (np.asarray(jres.state.alpha) == 0).sum())


def test_eval_on_convergence_and_last_epoch():
    """The convergence epoch and the last epoch are evaluated even off the
    eval_every cadence."""
    _, tcfg = _cfgs(loss="square", schedule="adagrad")
    x, y, xv, yv = _problem(16 * NG)
    gen = torch.Generator().manual_seed(0)
    res = fit(tcfg, x, y, gen, n_epochs=5, tol=1e9, x_val=xv, y_val=yv,
              eval_every=3, device="cpu")
    assert res.converged and res.stop_reason == "converged"
    assert res.epochs_run == 1 and "val_error" in res.history[-1]
    assert res.epochs_to_tol == 1
    res = fit(tcfg, x, y, gen, n_epochs=3, tol=0.0, x_val=xv, y_val=yv,
              eval_every=2, device="cpu")
    assert ["val_error" in h for h in res.history] == [True, False, True]
    assert res.final_residual == res.history[-1]["delta_alpha"]


def test_fit_argument_errors():
    _, tcfg = _cfgs()
    x, y, xv, _ = _problem(16 * NG)
    with pytest.raises(TypeError, match="Generator"):
        fit(tcfg, x, y, n_epochs=1, device="cpu")
    with pytest.raises(TypeError, match="x_val without y_val"):
        fit(tcfg, x, y, torch.Generator(), n_epochs=1, x_val=xv,
            device="cpu")
    with pytest.raises(ValueError, match="plans holds"):
        fit(tcfg, x, y, plans=jax_plans(jax.random.PRNGKey(0), 1, len(x)),
            n_epochs=2, device="cpu")


@pytest.mark.parametrize("execution", ["parallel", "hosted", "mesh", "bcd"])
def test_unported_executions_raise(execution):
    """Every execution is ported now.  mesh (tests/test_torch_mesh*.py)
    trains on a world of one, with EigenPro or without, and leaves no
    world behind; ``make_plan("mesh")`` with arrays and no source raises
    JAX's "needs a DataSource".  parallel and hosted
    (tests/test_torch_parallel.py, test_torch_hosted.py) train with
    cfg.precondition_k > 0 (tests/test_torch_precond.py).  bcd
    (tests/test_torch_bcd.py) trains the square loss and refuses EigenPro
    in the JAX package's words."""
    _, tcfg = _cfgs()
    x, y, _, _ = _problem(16 * NG)
    pcfg = tcfg.replace(precondition_k=4, precondition_m=32)
    if execution == "mesh":
        import torch.distributed as dist
        from repro_torch.core import trainer
        for cfg in (tcfg, pcfg):
            res = fit(cfg, x, y, torch.Generator(), execution=execution,
                      n_epochs=1, device="cpu")
            assert not dist.is_initialized()
            assert int(res.state.step) == len(x) // NG
            assert bool(torch.isfinite(res.state.alpha).all())
            assert (res.precond is None) == (cfg is tcfg)
        with pytest.raises(ValueError, match="needs a DataSource"):
            trainer.make_plan(execution, tcfg, x=torch.from_numpy(x),
                              y=torch.from_numpy(y),
                              device=torch.device("cpu"))
        return
    if execution == "bcd":
        with pytest.raises(ValueError, match="stochastic step only"):
            fit(pcfg.replace(loss="square"), x, y, torch.Generator(),
                execution=execution, n_epochs=1, device="cpu")
        res = fit(tcfg.replace(loss="square"), x, y, torch.Generator(),
                  execution=execution, n_epochs=1, device="cpu")
        assert res.precond is None and int(res.state.step) == 1
        assert bool(torch.isfinite(res.state.alpha).all())
        return
    res = fit(pcfg, x, y, torch.Generator(), execution=execution,
              n_epochs=1, device="cpu")
    assert res.precond.k == 4 and res.precond.m == 32
    assert bool(torch.isfinite(res.state.alpha).all())


def test_eval_cache_on_and_off_agree():
    _, tcfg = _cfgs(loss="square", schedule="adagrad")
    x, y, xv, yv = _problem(16 * NG, seed=3)
    plans = jax_plans(jax.random.PRNGKey(3), 3, len(x))
    runs = [fit(tcfg, x, y, plans=plans, n_epochs=3, tol=0.0, x_val=xv,
                y_val=yv, eval_cache=cache, device="cpu")
            for cache in (True, False)]
    assert runs[0].val_cache is not None and runs[1].val_cache is None
    assert runs[0].val_cache["hits"] == 2       # epochs 2 and 3
    assert [h["val_error"] for h in runs[0].history] == [
        h["val_error"] for h in runs[1].history]
    assert error_rate(tcfg, runs[1].state.alpha, torch.from_numpy(x),
                      torch.from_numpy(xv), torch.from_numpy(yv)) == \
        runs[1].history[-1]["val_error"]


def test_generator_plans_are_reproducible():
    """Two fits from equally seeded generators draw the same plans."""
    _, tcfg = _cfgs(loss="square", schedule="adagrad")
    x, y, _, _ = _problem(16 * NG)
    a, b = (fit(tcfg, x, y, torch.Generator().manual_seed(5), n_epochs=2,
                tol=0.0, device="cpu") for _ in range(2))
    assert torch.equal(a.state.alpha, b.state.alpha)
    assert torch.equal(a.state.accum, b.state.accum)
