"""The port's block coordinate descent (``repro_torch.core.bcd``,
``trainer.BCDPlan``, ``fit(execution="bcd")``) against the JAX package's,
on the CPU, from numpy inputs made from a seed at JAX's own test sizes
(``tests/test_bcd.py``: n 256, d 8, |J| 64, row tiles of 32).

The port cannot draw threefry numbers, so each round's block J is drawn
with JAX's key chain, as ``repro.core.trainer.fit_loop`` draws it (per
round ``key, sub = split(key)``, then ``bcd.sample_block(sub, n, |J|)``),
and handed to the port's ``fit(plans=...)``.

Tolerances.
* The tiles (``acc_serial``, ``fupd_serial``): float32 GEMMs summed in
  another order, at the JAX suite's f32 tolerance, rtol 2e-4, atol 1e-5 x
  max|oracle|.
* The solve and the fits: a float32 Cholesky solve of A = G + lam*n*K_JJ
  + jitter*I loses up to ~cond(A) * u (u = 2^-24) of its input's relative
  accuracy, and XLA's and LAPACK's factorizations round differently.  The
  tests measure cond(A) in float64 at their shapes (~46 for the fits'
  rounds) and hold delta and alpha at atol = 32 * cond(A) * u * max|ref|
  (~1.8e-4 for alpha, max|alpha| ~2), rtol 0.  The observed gap is ~1e-6.
* Every such gate also checks that its limit sits at least 100x below
  the median |value| it compares (the held values are not near zero), so
  a zero or sign-flipped answer fails.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcd as jbcd
from repro.core import trainer as jtrainer
from repro.core.dsekl import DSEKLConfig as JConfig
from repro.core.solver import fit as jfit
from repro.data.source import InMemorySource as JInMemorySource
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import bcd as tbcd
from repro_torch.core import trainer as ttrainer
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.core.solver import fit
from repro_torch.data import HostSource, InMemorySource
from repro_torch.kernels.dsekl import ops as kops
from repro_torch.launch import train

N, D, J, RB, N_VAL, ROUNDS = 256, 8, 64, 32, 64, 3
GAMMA = (("gamma", 0.5),)
U = 2.0 ** -24
RTOL, ATOL = 2e-4, 1e-5


def _base(**kw):
    base = dict(n_grad=RB, n_expand=J, loss="square", lam=1e-3,
                kernel_params=GAMMA)
    base.update(kw)
    return base


def _cfgs(**kw):
    return JConfig(impl="ref", **_base(**kw)), DSEKLConfig(**_base(**kw))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N + N_VAL, D)).astype(np.float32)
    y = np.sign(rng.standard_normal(N + N_VAL)).astype(np.float32)
    return x[:N], y[:N], x[N:], y[N:]


def jax_plans(key, rounds, n=N, j=J):
    """Each round's J as JAX's fit_loop draws it."""
    plans = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        plans.append(jbcd.sample_block(sub, n, j))
    return plans


def _kmat(x):
    return kops.kernel_block(torch.from_numpy(x), torch.from_numpy(x),
                             kernel_params=GAMMA).double().numpy()


def _system(kmat, idx_j, lam, jitter):
    """A of a round on J in float64: K_J^T K_J + lam*n*K_JJ + jitter."""
    kj = kmat[:, idx_j]
    a = kj.T @ kj + lam * kmat.shape[0] * kmat[np.ix_(idx_j, idx_j)]
    return a + jitter * np.trace(a) / len(idx_j) * np.eye(len(idx_j))


def _biting(got, want, atol, rtol=0.0):
    """assert_allclose after checking the limit sits >= 100x below the
    median |value| compared."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    med = float(np.median(np.abs(want)))
    assert med >= 100 * atol, (
        f"median |ref| {med:.3e} is not 100x the atol {atol:.3e}: the "
        "comparison could not fail a wrong answer")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _cond_atol(cond, want):
    return 32 * cond * U * float(np.abs(want).max())


@pytest.fixture(scope="module")
def jax_fits(data):
    """JAX's 3-round BCD fits at bcd_shards 1 and 2, shared."""
    x, y, xv, yv = data
    key = jax.random.PRNGKey(0)
    out = {}
    for shards in (1, 2):
        jcfg, _ = _cfgs(bcd_shards=shards)
        out[shards] = jfit(jcfg, jnp.asarray(x), jnp.asarray(y), key,
                           execution="bcd", n_epochs=ROUNDS, tol=0.0,
                           x_val=jnp.asarray(xv), y_val=jnp.asarray(yv))
    return key, out


# ---------------------------------------------------------------------------
# Exactness.
# ---------------------------------------------------------------------------

def test_full_block_round_is_the_dense_solve(data):
    """|J| = n: one round solves the whole regularized system, alpha =
    (K + lam*n*I)^-1 y, held at the cond(A)-stated tolerance."""
    x, y, _, _ = data
    _, cfg = _cfgs(n_expand=N, bcd_jitter=0.0)
    res = fit(cfg, x, y, torch.Generator().manual_seed(0), execution="bcd",
              n_epochs=1, tol=0.0, device="cpu")
    kmat = _kmat(x)
    a_star = np.linalg.solve(kmat + cfg.lam * N * np.eye(N), y)
    cond = np.linalg.cond(_system(kmat, np.arange(N), cfg.lam, 0.0))
    assert cond < 1e4, cond
    _biting(res.state.alpha.numpy(), a_star, _cond_atol(cond, a_star))


def test_plan_residual_is_k_alpha(data):
    """After every round the plan's f equals K alpha (f only ever moves
    by K_{.,J} d)."""
    x, y, _, _ = data
    _, cfg = _cfgs()
    with ttrainer.BCDPlan(cfg, InMemorySource(x, y),
                          device=torch.device("cpu")) as plan:
        res = ttrainer.fit_loop(plan, torch.Generator().manual_seed(1),
                                n_epochs=4, tol=0.0)
        f_plan = plan._f.double().numpy()
    f_true = _kmat(x) @ res.state.alpha.double().numpy()
    _biting(f_plan, f_true, 1e-5 * float(np.abs(f_true).max()))


# ---------------------------------------------------------------------------
# The round's ops against JAX's, on the same tiles.
# ---------------------------------------------------------------------------

def _tile_inputs(data, seed=3):
    x, y, _, _ = data
    rng = np.random.default_rng(seed)
    idx_j = rng.choice(N, J, replace=False)
    f = rng.standard_normal(N).astype(np.float32)
    idx, mask = tbcd.row_plan(N - 16, 1, 64)     # a masked tail tile
    return x, y, idx_j, f, idx[0], mask


def test_acc_and_fupd_match_jax(data):
    """Two tiles folded into the accumulator (the second a masked tail),
    then the f update on the tail.  The rows are halved so that K is far
    from I (raw, the Gram's median entry sits below 100x its atol)."""
    jcfg, tcfg = _cfgs()
    x, y, idx_j, f, idx, mask = _tile_inputs(data)
    x = x * np.float32(0.5)
    assert mask[-1].min() == 0.0             # the tail's padding is held
    t = torch.from_numpy
    want = jnp.zeros((J, J + 1), jnp.float32)
    got = torch.zeros((J, J + 1))
    for b in (-2, -1):
        want = jbcd.acc_serial(
            jcfg, jnp.asarray(x[idx[b]]), jnp.asarray(y[idx[b]]),
            jnp.asarray(x[idx_j]), jnp.asarray(f),
            jnp.asarray(idx[b], jnp.int32), jnp.asarray(mask[b]), want)
        got = tbcd.acc_serial(tcfg, t(x[idx[b]]), t(y[idx[b]]),
                              t(x[idx_j]), t(f), t(idx[b]), t(mask[b]), got)
    want = np.asarray(want)
    _biting(got.numpy(), want, ATOL * float(np.abs(want).max()), RTOL)
    xi, xj = x[idx[-1]], x[idx_j]
    delta = np.random.default_rng(5).standard_normal(J).astype(np.float32)
    want = np.asarray(jbcd.fupd_serial(
        jcfg, jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(delta),
        jnp.asarray(f), jnp.asarray(idx[-1], jnp.int32),
        jnp.asarray(mask[-1])))
    got = tbcd.fupd_serial(tcfg, t(xi), t(xj), t(delta), t(f), t(idx[-1]),
                           t(mask[-1])).numpy()
    _biting(got, want, ATOL * float(np.abs(want).max()), RTOL)
    alpha = np.zeros(N, np.float32)
    np.testing.assert_array_equal(
        tbcd.scatter_alpha(t(alpha), t(idx_j), t(delta)).numpy(),
        np.asarray(jbcd.scatter_alpha(jnp.asarray(alpha),
                                      jnp.asarray(idx_j, jnp.int32),
                                      jnp.asarray(delta))))


def _round_system(data, cfg):
    """One round's host-combined (G, rhs) from JAX's own ops."""
    x, y, idx_j, f, _, _ = _tile_inputs(data)
    idx, mask = jbcd.row_plan(N, 1, RB)
    gb = jnp.zeros((J, J + 1), jnp.float32)
    for t in range(idx.shape[1]):
        gb = jbcd.acc_serial(cfg, jnp.asarray(x[idx[0, t]]),
                             jnp.asarray(y[idx[0, t]]),
                             jnp.asarray(x[idx_j]), jnp.asarray(f),
                             jnp.asarray(idx[0, t], jnp.int32),
                             jnp.asarray(mask[t]), gb)
    g, b = jbcd.split_gram(jbcd.combine_partials(np.asarray(gb)[None]))
    return x[idx_j], g, b - np.float32(cfg.lam * N) * f[idx_j], idx_j


def test_solve_block_matches_jax_at_the_first_rung(data):
    jcfg, tcfg = _cfgs()
    xj, g, rhs, idx_j = _round_system(data, jcfg)
    want, jmult = jbcd.solve_block(jcfg, xj, g, rhs, jcfg.lam * N)
    got, tmult = tbcd.solve_block(tcfg, torch.from_numpy(xj), g, rhs,
                                  tcfg.lam * N)
    assert jmult == tmult == 1.0
    cond = np.linalg.cond(_system(_kmat(data[0]), idx_j, tcfg.lam,
                                  tcfg.bcd_jitter))
    want = np.asarray(want)
    _biting(got.numpy(), want, _cond_atol(cond, want))


def test_solve_block_walks_the_ladder_as_jax(data):
    """An indefinite A whose lowest eigenvalue sits between the jitter of
    rungs 10 and 100 (by 3x each way): both packages stop at rung 100
    with the same delta; with no jitter at all both raise JAX's words."""
    jcfg, tcfg = _cfgs(bcd_jitter=1e-3)
    xj, g, rhs, idx_j = _round_system(data, jcfg)
    kjj = _kmat(xj)
    a = np.asarray(g, np.float64) + jcfg.lam * N * kjj
    w, v = np.linalg.eigh(a)
    w[0] = -np.sqrt(0.01 * 0.1) * np.trace(a) / J
    a = (v * w) @ v.T
    t = np.trace(a) / J
    lo = np.linalg.eigvalsh(a)[0]
    assert 0.01 * t * 3 <= -lo <= 0.1 * t / 3, (lo, t)
    g_bad = (a - jcfg.lam * N * kjj).astype(np.float32)
    want, jmult = jbcd.solve_block(jcfg, xj, g_bad, rhs, jcfg.lam * N)
    got, tmult = tbcd.solve_block(tcfg, torch.from_numpy(xj), g_bad, rhs,
                                  tcfg.lam * N)
    assert jmult == tmult == 100.0
    cond = np.linalg.cond(a + 0.1 * t * np.eye(J))
    want = np.asarray(want)
    _biting(got.numpy(), want, _cond_atol(cond, want))
    jcfg0, tcfg0 = _cfgs(bcd_jitter=0.0)
    with pytest.raises(RuntimeError) as jerr:
        jbcd.solve_block(jcfg0, xj, g_bad, rhs, jcfg.lam * N)
    with pytest.raises(RuntimeError) as terr:
        tbcd.solve_block(tcfg0, torch.from_numpy(xj), g_bad, rhs,
                         tcfg.lam * N)
    assert str(terr.value) == str(jerr.value)


def test_host_helpers_equal_jax():
    for n, shards, rb in ((256, 1, 32), (256, 2, 48), (250, 1, 64)):
        for a, b in zip(tbcd.row_plan(n, shards, rb),
                        jbcd.row_plan(n, shards, rb)):
            np.testing.assert_array_equal(a, b)
    parts = np.random.default_rng(0).standard_normal((3, 4, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(tbcd.combine_partials(parts),
                                  jbcd.combine_partials(parts))
    for a, b in zip(tbcd.split_gram(parts[0]), jbcd.split_gram(parts[0])):
        np.testing.assert_array_equal(a, b)
    jcfg, tcfg = _cfgs(bcd_block=0, bcd_row_block=0)
    assert tbcd.block_size(tcfg, 40) == jbcd.block_size(jcfg, 40) == 40
    assert tbcd.block_size(tcfg, N) == jbcd.block_size(jcfg, N) == J
    assert tbcd.row_block_size(tcfg) == jbcd.row_block_size(jcfg) == RB
    assert tbcd.kernel_tile_evals_per_round(N, J) == \
        jbcd.kernel_tile_evals_per_round(N, J)
    assert tbcd.JITTER_LADDER == jbcd.JITTER_LADDER
    blk = tbcd.sample_block(torch.Generator().manual_seed(0), N, J)
    assert blk.dtype == np.int64 and len(set(blk.tolist())) == J
    assert blk.min() >= 0 and blk.max() < N


# ---------------------------------------------------------------------------
# Fits against JAX's, on JAX's plans.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_fit_matches_jax_on_jax_plans(data, jax_fits, shards):
    x, y, xv, yv = data
    key, jres = jax_fits
    jres = jres[shards]
    _, tcfg = _cfgs(bcd_shards=shards)
    plans = jax_plans(key, ROUNDS)
    res = fit(tcfg, x, y, plans=plans, execution="bcd", n_epochs=ROUNDS,
              tol=0.0, x_val=xv, y_val=yv, device="cpu")
    kmat = _kmat(x)
    cond = max(np.linalg.cond(_system(kmat, p, tcfg.lam, tcfg.bcd_jitter))
               for p in plans)
    assert cond < 1e3, cond
    want = np.asarray(jres.state.alpha)
    _biting(res.state.alpha.numpy(), want, _cond_atol(cond, want))
    assert res.epochs_run == jres.epochs_run == ROUNDS
    assert int(res.state.step) == int(jres.state.step) == ROUNDS
    for a, b in zip(res.history, jres.history):
        assert abs(a["val_error"] - b["val_error"]) <= 1.0 / N_VAL
        np.testing.assert_allclose(a["delta_alpha"], b["delta_alpha"],
                                   rtol=32 * cond * U)
    blocks = -(-(N // shards) // RB)
    assert res.loader["steps"] == jres.loader["steps"] == \
        2 * shards * blocks * ROUNDS


# ---------------------------------------------------------------------------
# Placement and resume, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_hosted_prefetch_sync_and_memory_are_bit_identical(data, shards):
    x, y, xv, yv = data
    _, cfg = _cfgs(bcd_shards=shards)
    plans = jax_plans(jax.random.PRNGKey(1), ROUNDS)
    kw = dict(plans=plans, execution="bcd", n_epochs=ROUNDS, tol=0.0,
              x_val=xv, y_val=yv, device="cpu")
    runs = [fit(cfg, x, y, **kw),
            fit(cfg, HostSource(x, y), None, **kw),
            fit(cfg, HostSource(x, y), None, prefetch=False, **kw),
            fit(cfg, InMemorySource(torch.from_numpy(x), torch.from_numpy(y)),
                None, **kw)]
    trace = [[(h["delta_alpha"], h["val_error"]) for h in r.history]
             for r in runs]
    for r, t in zip(runs[1:], trace[1:]):
        assert torch.equal(r.state.alpha, runs[0].state.alpha)
        assert t == trace[0]


def test_resume_equals_uninterrupted_and_carries_the_residual(data,
                                                              tmp_path):
    x, y, xv, yv = data
    _, cfg = _cfgs()
    kw = dict(execution="bcd", tol=0.0, x_val=xv, y_val=yv, device="cpu")
    full = fit(cfg, x, y, torch.Generator().manual_seed(7), n_epochs=5,
               **kw)
    d = str(tmp_path / "ckpt")
    fit(cfg, x, y, torch.Generator().manual_seed(7), n_epochs=2,
        checkpoint_dir=d, **kw)
    _, flat, _ = CheckpointManager(d).restore(2)
    with ttrainer.BCDPlan(cfg, InMemorySource(x, y),
                          device=torch.device("cpu")) as plan:
        state = plan.place_state(flat)
        f_true = _kmat(x) @ state.alpha.double().numpy()
        assert flat["bcd_f"].shape == (N,)
        _biting(flat["bcd_f"], f_true, 1e-5 * float(np.abs(f_true).max()))
        np.testing.assert_array_equal(plan.snapshot_leaves(state)[
            "bcd_f"].numpy(), flat["bcd_f"])
    res = fit(cfg, x, y, torch.Generator().manual_seed(7), n_epochs=5,
              checkpoint_dir=d, resume=True, **kw)
    assert torch.equal(full.state.alpha, res.state.alpha)
    assert [h["delta_alpha"] for h in full.history] == \
        [h["delta_alpha"] for h in res.history]
    assert [h["val_error"] for h in full.history] == \
        [h["val_error"] for h in res.history]


def test_stochastic_plans_leave_no_residual_leaf(data, tmp_path):
    x, y, _, _ = data
    _, cfg = _cfgs()
    d = str(tmp_path / "ckpt")
    fit(cfg, x, y, torch.Generator(), n_epochs=1, checkpoint_dir=d,
        device="cpu")
    _, flat, _ = CheckpointManager(d).restore(1)
    assert "bcd_f" not in flat and "alpha" in flat


# ---------------------------------------------------------------------------
# Refusals, in JAX's words.
# ---------------------------------------------------------------------------

def _same_refusal(jcall, tcall, exc=ValueError):
    with pytest.raises(exc) as jerr:
        jcall()
    with pytest.raises(exc) as terr:
        tcall()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


def test_refusals_match_jax(data, tmp_path):
    x, y, _, _ = data
    xs, ys = x[:64], y[:64]
    jx, jy, key = jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0)
    gen, cpu = torch.Generator(), torch.device("cpu")

    def both(kw, fit_kw=None, n=64):
        jcfg, tcfg = _cfgs(n_grad=16, n_expand=16, **kw)
        fit_kw = fit_kw or {}
        return _same_refusal(
            lambda: jfit(jcfg, jx[:n], jy[:n], key, execution="bcd",
                         n_epochs=2, **fit_kw),
            lambda: fit(tcfg, xs[:n], ys[:n], gen, execution="bcd",
                        n_epochs=2, device="cpu", **fit_kw))

    assert "square" in both({"loss": "hinge"})
    assert "truncate" in both({}, {"truncate_every": 1})
    assert "precondition" in both({"precondition_k": 4})
    # An explicit rank or a built preconditioner is refused alike.
    _, tcfg = _cfgs(n_grad=16, n_expand=16)
    with pytest.raises(ValueError, match="stochastic step only"):
        fit(tcfg, xs, ys, gen, execution="bcd", n_epochs=1, precondition=4,
            device="cpu")
    with pytest.raises(ValueError, match="stochastic step only"):
        ttrainer.make_plan("bcd", tcfg, source=InMemorySource(xs, ys),
                           device=cpu, precond=object())
    jcfg, tcfg = _cfgs(n_grad=16, n_expand=16, bcd_shards=4)
    assert "divisible" in _same_refusal(
        lambda: jtrainer.BCDPlan(jcfg, JInMemorySource(jx[:62], jy[:62])),
        lambda: ttrainer.BCDPlan(tcfg, InMemorySource(xs[:62], ys[:62]),
                                 device=cpu))
    # A stochastic fit's checkpoint (no bcd_f), and one of another n.
    _, tcfg = _cfgs(n_grad=16, n_expand=16)
    jcfg, _ = _cfgs(n_grad=16, n_expand=16)
    dirs = {}
    for name, fitter in (("jax", lambda d: jfit(
            jcfg, jx, jy, key, n_epochs=1, checkpoint_dir=d)),
                         ("torch", lambda d: fit(
            tcfg, xs, ys, gen, n_epochs=1, checkpoint_dir=d,
            device="cpu"))):
        dirs[name] = str(tmp_path / name)
        fitter(dirs[name])
    assert "bcd_f" in _same_refusal(
        lambda: jfit(jcfg, jx, jy, key, execution="bcd", n_epochs=2,
                     checkpoint_dir=dirs["jax"], resume=True),
        lambda: fit(tcfg, xs, ys, gen, execution="bcd", n_epochs=2,
                    checkpoint_dir=dirs["torch"], resume=True,
                    device="cpu"))
    flat = {"alpha": np.zeros(32, np.float32),
            "bcd_f": np.zeros(32, np.float32)}
    jplan = jtrainer.BCDPlan(jcfg, JInMemorySource(jx, jy), prefetch=False)
    with ttrainer.BCDPlan(tcfg, InMemorySource(xs, ys), device=cpu) as tp:
        assert "row count" in _same_refusal(
            lambda: jplan.place_state(flat), lambda: tp.place_state(flat))
    jplan.close()


def test_plans_are_checked_and_consumed_in_order(data):
    x, y, _, _ = data
    _, cfg = _cfgs()
    with ttrainer.BCDPlan(cfg, HostSource(x, y),
                          device=torch.device("cpu")) as plan:
        with pytest.raises(ValueError, match=r"shape \(64,\)"):
            plan.check_plan(np.zeros((2, J), np.int64))
        state = plan.init_state()
        p1, p2 = jax_plans(jax.random.PRNGKey(0), 2)
        plan.plan_epoch(p1)
        plan.plan_epoch(p2)
        with pytest.raises(RuntimeError, match="order"):
            plan.run_epoch(state, p2)


def test_mesh_is_still_refused_naming_item_6(data):
    """Item 6's DSEKL half is ported: BCD and the stochastic step run on a
    mesh (tests/test_torch_mesh_fit.py drives the 4-rank worlds).  On a
    world of one the mesh BCD fit equals the serial fit bit for bit, a
    ``MeshPlan`` from ``make_plan`` tears its world down on close, and
    the launcher refuses no mesh mode any more (item 6 is ported whole):
    the LM path's ``--data-par 2`` asks for a (2, 1) mesh, which a world
    of one cannot hold."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    x, y, _, _ = data
    _, cfg = _cfgs()
    mesh = make_local_mesh(1, 1, backend="gloo", device="cpu")
    try:
        on_mesh = fit(cfg, x, y, torch.Generator().manual_seed(2),
                      execution="bcd", mesh=mesh, n_epochs=2, tol=0.0,
                      device="cpu")
    finally:
        mesh.close()
    serial = fit(cfg, x, y, torch.Generator().manual_seed(2),
                 execution="bcd", n_epochs=2, tol=0.0, device="cpu")
    assert torch.equal(on_mesh.state.alpha, serial.state.alpha)
    with ttrainer.make_plan("mesh", cfg, source=HostSource(x, y),
                            device=torch.device("cpu")) as plan:
        assert plan.name == "mesh" and dist.is_initialized()
    assert not dist.is_initialized()
    lm_mesh = train.parser().parse_args(["--data-par", "2", "--device",
                                         "cpu"])
    assert train.lm_refusal(lm_mesh) == ""
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        train.lm_ctx(lm_mesh)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_mode", ["memory", "mmap"])
def test_launcher_runs_bcd(tmp_path, capsys, data_mode):
    args = ["--dsekl", "--device", "cpu", "--n", "2048", "--epochs", "3",
            "--n-grad", "128", "--n-expand", "128", "--execution", "bcd",
            "--bcd-block", "256", "--bcd-row-block", "512",
            "--data", data_mode, "--mmap-dir", str(tmp_path)]
    out = train.train_dsekl(train.parser().parse_args(args))
    text = capsys.readouterr().out
    assert "[train-dsekl] block coordinate descent: |J|=256 per round" \
        in text
    assert "(bcd rounds, prefetch;" in text
    res, cfg = out["result"], out["cfg"]
    assert cfg.loss == "square" and cfg.bcd_block == 256
    assert cfg.bcd_row_block == 512 and int(res.state.step) == 3
    n_train = 2048 - 256
    assert res.loader["steps"] == 3 * 2 * -(-n_train // 512)
    assert int((res.state.alpha != 0).sum()) <= 3 * 256
    errs = [h["val_error"] for h in res.history]
    assert len(errs) == 3 and errs[-1] < 0.5
    assert (tmp_path / "manifest.json").is_file() == (data_mode == "mmap")


def test_launcher_refuses_precondition_with_bcd(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--dsekl", "--device", "cpu", "--execution", "bcd",
                    "--precondition-k", "8"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--precondition-k with --execution bcd" in err
    assert "stochastic step only" in err
    assert os.environ.get("REPRO_TORCH_IMPL", "auto") in ("auto", "ref")
