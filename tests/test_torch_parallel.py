"""Algorithm 2 in the port against the JAX package's, on JAX's own plans.

The port cannot draw threefry numbers, so the tests draw each epoch's
Alg.-2 plan with JAX's key chain, exactly as ``trainer.fit_loop`` and
``dsekl.epoch_parallel`` sample (per epoch ``key, sub = split(key)``, then
``sampler.parallel_epoch_plan(sub, n, n_grad, n_expand, n_workers)``), and
hand the plans to the port's ``fit(plans=..., algorithm="parallel")``.

Tolerance: the JAX suite's float32 one, rtol 2e-4, atol 1e-5 x max(1,
|oracle|_inf) (``tests/test_dual_pass.py::_tols``), for the block
gradient, the update and the 2-epoch trajectories (smooth losses: square,
logistic).  The hinge subgradient flips on ulp-level differences at
y*f == 1, so hinge runs 2 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro.core.solver import fit as jfit
from repro_torch.core import dsekl as td
from repro_torch.core import sampler as tsampler
from repro_torch.core.solver import fit
from repro_torch.kernels.dsekl import block as tblock

D, NG, NE, K, N_VAL = 5, 8, 6, 3, 32
RTOL, ATOL = 2e-4, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n + N_VAL, D)).astype(f32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                 -1.0).astype(f32)
    return x[:n], y[:n], x[n:], y[n:]


def jax_parallel_plans(key, n_epochs, n, n_grad=NG, n_expand=NE,
                       n_workers=K):
    plans = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        i, jk = jsampler.parallel_epoch_plan(sub, n, n_grad, n_expand,
                                             n_workers)
        plans.append((np.array(i), np.array(jk)))
    return plans


def _cfgs(**kw):
    base = dict(n_grad=NG, n_expand=NE, n_workers=K, kernel="rbf",
                kernel_params=(("gamma", 0.5),), lam=1e-3, lr0=0.5)
    base.update(kw)
    return jd.DSEKLConfig(impl="ref", **base), td.DSEKLConfig(**base)


# --- the block gradient and the update -----------------------------------

@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
@pytest.mark.parametrize("unbiased", [False, True],
                         ids=["unscaled", "unbiased"])
@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_grad_block_parallel_matches_jax(fuse, unbiased, loss):
    jcfg, tcfg = _cfgs(loss=loss, fuse_dual_pass=fuse,
                       unbiased_scaling=unbiased)
    rng = np.random.default_rng(1)
    f32 = np.float32
    xi = rng.standard_normal((NG, D)).astype(f32)
    yi = np.where(rng.standard_normal(NG) > 0, 1.0, -1.0).astype(f32)
    xjk = rng.standard_normal((K, NE, D)).astype(f32)
    ajk = rng.standard_normal((K, NE)).astype(f32)
    n = 500
    want_f, want_g = jd._grad_block_parallel_with_f(
        jcfg, *(jnp.asarray(a) for a in (xi, yi, xjk, ajk)), n)
    got_f, got_g = td._grad_block_parallel_with_f(
        tcfg, *(torch.from_numpy(a) for a in (xi, yi, xjk, ajk)), n)
    _close(got_f, want_f)
    _close(got_g, want_g)
    got = td.grad_block_parallel(
        tcfg, *(torch.from_numpy(a) for a in (xi, yi, xjk, ajk)), n)
    assert got.shape == (K * NE,) and torch.equal(got, got_g)


def test_fused_and_two_pass_agree():
    """The fused J union and the per-worker two-pass form compute one
    function."""
    _, fused = _cfgs(loss="square", unbiased_scaling=True)
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((NG, D)), rng.standard_normal(NG),
        rng.standard_normal((K, NE, D)), rng.standard_normal((K, NE)))]
    f1, g1 = td._grad_block_parallel_with_f(fused, *args, 77)
    f2, g2 = td._grad_block_parallel_with_f(
        fused.replace(fuse_dual_pass=False), *args, 77)
    _close(f1, f2.numpy())
    _close(g1, g2.numpy())


@pytest.mark.parametrize("schedule", ["adagrad", "inv_t"])
def test_apply_update_parallel_matches_jax(schedule):
    """Alg. 2's scatter; the accumulator moves only under adagrad."""
    jcfg, tcfg = _cfgs(schedule=schedule)
    rng = np.random.default_rng(3)
    n = 40
    alpha = rng.standard_normal(n).astype(np.float32)
    accum = (1.0 + rng.random(n)).astype(np.float32)
    flat_j = rng.permutation(n)[: K * NE]              # disjoint, as Alg. 2
    flat_g = rng.standard_normal(K * NE).astype(np.float32)
    jst = jd.DSEKLState(alpha=jnp.asarray(alpha), accum=jnp.asarray(accum),
                        step=jnp.asarray(4, jnp.int32),
                        epoch=jnp.asarray(1, jnp.int32))
    tst = td.DSEKLState(alpha=torch.from_numpy(alpha),
                        accum=torch.from_numpy(accum),
                        step=torch.tensor(4, dtype=torch.int32),
                        epoch=torch.tensor(1, dtype=torch.int32))
    want = jd.apply_update_parallel(jcfg, jst, jnp.asarray(flat_j),
                                    jnp.asarray(flat_g))
    got = td.apply_update_parallel(tcfg, tst, torch.from_numpy(flat_j),
                                   torch.from_numpy(flat_g))
    _close(got.alpha, want.alpha)
    _close(got.accum, want.accum)
    assert int(got.step) == int(want.step) == 5
    if schedule != "adagrad":
        assert torch.equal(got.accum, torch.from_numpy(accum))
    assert np.array_equal(alpha, tst.alpha.numpy())    # out of place


# --- the sampler -----------------------------------------------------------

@pytest.mark.parametrize("n,n_workers", [(100, 3), (100, 40), (50, 2)])
def test_parallel_epoch_plan_structure(n, n_workers):
    """Disjoint worker batches within a step, J cycled as (b * k + w) %
    n_j over one permutation, every index drawn at most once per
    partition; drawn on the generator's device."""
    gen = torch.Generator().manual_seed(n)
    i_b, jk = tsampler.parallel_epoch_plan(gen, n, NG, NE, n_workers)
    n_i, n_j = n // NG, n // NE
    k = min(n_workers, n_j)
    assert i_b.shape == (n_i, NG) and jk.shape == (n_i, k, NE)
    assert i_b.dtype == jk.dtype == torch.int64
    assert len(set(i_b.flatten().tolist())) == n_i * NG
    gen = torch.Generator().manual_seed(n)
    i_again, j_batches = tsampler.paired_epoch_batches(gen, n, NG, NE)
    assert torch.equal(i_again, i_b)
    for b in range(n_i):
        assert len(set(jk[b].flatten().tolist())) == k * NE
        for w in range(k):
            assert torch.equal(jk[b, w], j_batches[(b * k + w) % n_j])


def test_parallel_epoch_plan_is_empty_below_one_batch():
    gen = torch.Generator().manual_seed(0)
    i_b, jk = tsampler.parallel_epoch_plan(gen, NG - 1, NG, NE, K)
    assert i_b.shape == (0, NG) and jk.shape[0] == 0
    i_b, jk = tsampler.parallel_epoch_plan(gen, NE - 1, 2, NE, K)
    assert jk.shape == (i_b.shape[0], 0, NE)


# --- the fit -----------------------------------------------------------------

def _fit_both(jcfg, tcfg, n, n_epochs, seed=0, **kw):
    x, y, xv, yv = _problem(n, seed)
    key = jax.random.PRNGKey(seed)
    jres = jfit(jcfg, jnp.asarray(x), jnp.asarray(y), key,
                algorithm="parallel", n_epochs=n_epochs,
                x_val=jnp.asarray(xv), y_val=jnp.asarray(yv), **kw)
    tres = fit(tcfg, x, y, plans=jax_parallel_plans(key, n_epochs, n),
               algorithm="parallel", n_epochs=n_epochs, x_val=xv, y_val=yv,
               device="cpu", **kw)
    return jres, tres


@pytest.mark.parametrize("loss,schedule,fuse", [
    ("square", "adagrad", True), ("logistic", "inv_t", True),
    ("square", "inv_epoch", False)])
def test_parallel_fit_matches_jax(loss, schedule, fuse):
    jcfg, tcfg = _cfgs(loss=loss, schedule=schedule, fuse_dual_pass=fuse)
    n = 12 * NG
    jres, tres = _fit_both(jcfg, tcfg, n, 2, tol=0.0)
    _close(tres.state.alpha, jres.state.alpha)
    _close(tres.state.accum, jres.state.accum)
    assert int(tres.state.step) == int(jres.state.step) == 2 * (n // NG)
    assert int(tres.state.epoch) == int(jres.state.epoch) == 2
    for th, jh in zip(tres.history, jres.history, strict=True):
        assert th["delta_alpha"] == pytest.approx(jh["delta_alpha"],
                                                  rel=RTOL)
        assert abs(th["val_error"] - jh["val_error"]) <= 1.0 / N_VAL + 1e-9


def test_parallel_fit_hinge_two_steps_matches_jax():
    jcfg, tcfg = _cfgs(loss="hinge", schedule="adagrad")
    jres, tres = _fit_both(jcfg, tcfg, 2 * NG, 1, tol=0.0)
    _close(tres.state.alpha, jres.state.alpha)
    _close(tres.state.accum, jres.state.accum)
    assert int(tres.state.step) == int(jres.state.step) == 2


def test_dataset_smaller_than_a_batch_leaves_the_state():
    """N < n_grad: the epoch has no step; alpha and accum stay, the epoch
    is counted (as the JAX epoch scans over zero batches)."""
    _, tcfg = _cfgs()
    x, y, _, _ = _problem(NG - 1)
    res = fit(tcfg, x, y, torch.Generator().manual_seed(0),
              algorithm="parallel", n_epochs=2, tol=-1.0, device="cpu")
    assert torch.equal(res.state.alpha, torch.zeros(NG - 1))
    assert torch.equal(res.state.accum, torch.ones(NG - 1))
    assert int(res.state.step) == 0 and int(res.state.epoch) == 2


def test_parallel_plans_drawn_from_the_generator_are_reproducible():
    _, tcfg = _cfgs(loss="square", schedule="adagrad")
    x, y, _, _ = _problem(12 * NG)
    a, b = (fit(tcfg, x, y, torch.Generator().manual_seed(5),
                algorithm="parallel", n_epochs=2, tol=0.0, device="cpu")
            for _ in range(2))
    assert torch.equal(a.state.alpha, b.state.alpha)
    assert int(a.state.step) == 2 * 12


# --- the card's route, with counting stand-ins -----------------------------

def _counting(plain):
    def f(*args, **kw):
        f.launches += 1
        return plain(*args, **kw)
    f.launches = 0
    return f


@pytest.mark.parametrize("ne,budget,launched", [
    (400, None, {"train_pass_indexed_cuda"}),
    (1400, 0, {"kernel_matvec_cuda", "kernel_vecmat_cuda"}),
    (1400, None, {"train_pass_indexed_cuda"}),
    (400, 0, {"train_pass_indexed_cuda"}),
], ids=["one-train-pass", "over-budget", "one-train-pass-fp32",
        "one-train-pass-no-budget"])
def test_parallel_step_on_cuda_is_one_train_pass(monkeypatch, ne, budget,
                                                 launched):
    """On the CUDA backend an Alg.-2 step is ONE indexed train pass over
    the J union and lands where the ref step lands: 3 x 400 = 1,200
    columns on the sm90 route (K on chip: the stash budget does not bind
    it), 3 x 1,400 = 4,200 on the fp32 route, which above the stash budget
    falls back to matvec then vecmat."""
    stand_ins = {n: _counting(getattr(tblock, p)) for n, p in [
        ("kernel_matvec_cuda", "kernel_matvec_plain"),
        ("kernel_vecmat_cuda", "kernel_vecmat_plain"),
        ("dual_pass_cuda", "dual_pass_plain"),
        ("train_pass_cuda", "train_pass_plain"),
        ("train_pass_indexed_cuda", "train_pass_indexed_plain")]}
    for name, fn in stand_ins.items():
        monkeypatch.setattr(tblock, name, fn)
    if budget is not None:
        monkeypatch.setattr(tblock, "STASH_BUDGET", budget)
    n, ng = 1300 if ne == 400 else 4300, 64
    x, y, _, _ = _problem(n, seed=4)
    tcfg = td.DSEKLConfig(n_grad=ng, n_expand=ne, n_workers=K,
                          kernel_params=(("gamma", 0.5),), lam=1e-3,
                          loss="square", schedule="adagrad")
    assert tblock.select_train_route(ng, K * ne, D, "rbf") == (
        "sm90" if ne == 400 else "fp32")
    plans = [tuple(p.numpy() for p in tsampler.parallel_epoch_plan(
        torch.Generator().manual_seed(9), n, ng, ne, K))]
    steps = n // ng
    res = {impl: fit(tcfg.replace(impl=impl), x, y, plans=plans,
                     algorithm="parallel", n_epochs=1, tol=0.0,
                     device="cpu") for impl in ("cuda", "ref")}
    assert {k for k, f in stand_ins.items() if f.launches} == launched
    assert all(f.launches == steps for k, f in stand_ins.items()
               if k in launched)
    _close(res["cuda"].state.alpha, res["ref"].state.alpha.numpy())
    _close(res["cuda"].state.accum, res["ref"].state.accum.numpy())
