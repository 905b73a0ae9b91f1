"""EigenPro preconditioning in the port (``repro_torch/core/precond.py`` and
the correction in ``core/dsekl.py``) against the JAX package's
(``repro/core/precond.py``), on the same numpy inputs, and the port's own
contracts.

Tolerances:

* The float64 algebra (``precond.eigensystem``) fed JAX's exact K_PP and
  B: the eigenvalues, U and q within 1e-10 relative (it is the same numpy
  algebra; it agrees to the last bit here).
* The whole estimate from JAX's indices: K_PP and G are evaluated by each
  package in float32 and differ by a rounding (~1e-7 relative), which the
  pseudo-inverse and the m x m eigensolves amplify by the conditioning of
  the kept spectrum.  Measured on the CPU over the cases below: the top
  k + 1 eigenvalues within 3e-7 relative, q within 9e-7, and the
  correction operator U diag(q) U^T (no sign ambiguity) within 3e-6 of
  its largest entry.  Held at 1e-5 relative for the eigenvalues and q and
  1e-4 x max|op| for the operator: about 30x the readings, below the
  float32 step tolerance.
* The correction, the preconditioned gradients and the 2-epoch fits: the
  JAX suite's float32 tolerance, rtol 2e-4, atol 1e-5 x max(1,
  |oracle|_inf) (``tests/test_dual_pass.py::_tols``); smooth loss
  (square) for the fits.
* The port's own contracts (k = 0 against no preconditioning, hosted
  against in memory, resume against uninterrupted, source against array)
  are bit for bit on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed
from torch.overrides import TorchFunctionMode

from repro.core import dsekl as jd
from repro.core import precond as jp
from repro.core import sampler as jsampler
from repro.core.solver import fit as jfit
from repro.kernels.dsekl import ops as jops
from repro_torch import convert
from repro_torch.core import dsekl as td
from repro_torch.core import precond as tp
from repro_torch.core import sampler as tsampler
from repro_torch.core import solver as tsolver
from repro_torch.core.solver import fit
from repro_torch.data import HostSource, InMemorySource
from repro_torch.kernels.dsekl import block as tblock
from repro_torch.kernels.dsekl import ops as tops
from repro_torch.launch import train

N, D, NG, NE, K = 320, 5, 24, 16, 2
RTOL, ATOL = 2e-4, 1e-5
BASE = dict(n_grad=NG, n_expand=NE, kernel="rbf",
            kernel_params=(("gamma", 0.5),), lam=1e-4, schedule="adagrad")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _cfgs(**kw):
    base = dict(BASE, **kw)
    return jd.DSEKLConfig(impl="ref", **base), td.DSEKLConfig(**base)


def _data(n=N, seed=0, square=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    if square:
        y = (np.sin(2 * x[:, 0]) + 0.5 * x[:, 1]).astype(np.float32)
    else:
        y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                     -1.0).astype(np.float32)
    return x, y


def _jax_pre(jcfg, x, k=6, m=48, seed=11):
    return jp.estimate_preconditioner(jcfg, x, jax.random.PRNGKey(seed),
                                      k=k, m=m)


def _port_pre(tcfg, x, k=6, m=48, seed=11):
    return tp.estimate_preconditioner(
        tcfg, x, torch.Generator().manual_seed(seed), k=k, m=m,
        device="cpu")


# --- the estimate ------------------------------------------------------------

KERNELS = [("rbf", (("gamma", 0.5),)), ("matern52", (("length_scale", 1.5),)),
           ("laplacian", (("gamma", 0.3),))]


@pytest.mark.parametrize("k,m", [(6, 48), (16, 96)])
def test_eigensystem_matches_jax_on_identical_inputs(k, m):
    """JAX's own K_PP and B into the port's float64 algebra."""
    jcfg, _ = _cfgs()
    x, _ = _data()
    pre = _jax_pre(jcfg, x, k=k, m=m)
    rows = x[pre.indices]
    kpp = np.asarray(jops.kernel_block(
        jnp.asarray(rows), jnp.asarray(rows), kernel_name="rbf",
        kernel_params=(("gamma", 0.5),)), np.float64)
    b = jp._stream_gram(jcfg, x, rows, N)
    mu, u, q = tp.eigensystem(kpp, b, k, 0.95, N)
    assert mu.dtype == u.dtype == q.dtype == np.float64
    np.testing.assert_allclose(mu, pre.eigenvalues, rtol=1e-10, atol=0)
    np.testing.assert_allclose(u.astype(np.float32), pre.vectors,
                               rtol=1e-10, atol=1e-10 * np.abs(u).max())
    np.testing.assert_allclose(q.astype(np.float32), pre.damping,
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("kernel,params", KERNELS,
                         ids=[k for k, _ in KERNELS])
def test_estimate_from_jax_indices_matches_jax(kernel, params):
    jcfg, tcfg = _cfgs(kernel=kernel, kernel_params=params)
    x, _ = _data(seed=1)
    want = _jax_pre(jcfg, x, k=8, m=64)
    got = tp.estimate_preconditioner(tcfg, x, indices=want.indices, k=8,
                                     device="cpu")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.rows, want.rows)
    assert (got.k, got.m, got.n) == (want.k, want.m, want.n)
    assert got.damping_power == want.damping_power
    assert got.safety == want.safety
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got.damping, want.damping, rtol=1e-5, atol=0)

    def op(p):
        u = p.vectors.astype(np.float64)
        return (u * p.damping.astype(np.float64)) @ u.T

    ow = op(want)
    np.testing.assert_allclose(op(got), ow, rtol=0,
                               atol=1e-4 * np.abs(ow).max())
    assert abs(got.scale - want.scale) <= 1e-5 * want.scale
    assert got.step_size(NE) == pytest.approx(want.step_size(NE), rel=1e-5)


def test_estimate_is_deterministic_shaped_and_k0_is_none():
    _, tcfg = _cfgs()
    x, _ = _data()
    a, b = _port_pre(tcfg, x), _port_pre(tcfg, x)
    for f in ("indices", "rows", "vectors", "damping", "eigenvalues"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.k == 6 and a.m == 48 and a.rows.shape == (48, D)
    assert np.all(np.diff(a.indices) > 0)             # distinct, sorted
    s = a.eigenvalues
    assert np.all(s[:-1] >= s[1:]) and s[-1] > 0
    assert np.all(a.damping > 0) and a.n == N
    assert 0.0 < a.damped_top() < s[0] and a.scale > 1.0
    assert a.step_size(NE) > a.baseline_step_size(NE) > 0
    assert tp.estimate_preconditioner(tcfg, x, torch.Generator(), k=0) is None
    with pytest.raises(TypeError, match="Generator or explicit indices"):
        tp.estimate_preconditioner(tcfg, x, k=6, device="cpu")
    with pytest.raises(ValueError, match="k \\+ 2"):
        tp.estimate_preconditioner(tcfg, x[:5], torch.Generator(), k=6,
                                   device="cpu")
    # m = 0 is the auto size, min(N, max(4 (k + 1), 512)).
    assert _port_pre(tcfg, x, m=0).m == N


def test_estimate_on_a_source_equals_the_array():
    """A HostSource, an InMemorySource, a tensor and the array give the
    same preconditioner bit for bit: the same rows, chunks and path."""
    _, tcfg = _cfgs()
    x, y = _data(n=4096 + 300, seed=2)        # a second, ragged chunk
    want = _port_pre(tcfg, x, k=5, m=40)
    for data in (HostSource(x, y), InMemorySource(x, y), torch.from_numpy(x)):
        got = _port_pre(tcfg, data, k=5, m=40)
        for f in ("indices", "rows", "vectors", "damping", "eigenvalues"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_extra_roundtrip_and_from_jax_are_bit_exact(tmp_path):
    jcfg, tcfg = _cfgs()
    x, y = _data()
    a = _port_pre(tcfg, x)
    b = tp.EigenProPreconditioner.from_extra(
        json.loads(json.dumps(a.to_extra())))
    jpre = _jax_pre(jcfg, x)
    carried = [convert.preconditioner_from_jax(jpre),
               convert.preconditioner_from_jax(
                   json.loads(json.dumps(jpre.to_extra())))]
    # As a JAX checkpoint stores it: extra["precond"].
    d = str(tmp_path / "jax")
    jfit(jcfg, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1),
         n_epochs=1, tol=0.0, precondition=jpre, checkpoint_dir=d)
    _, _, extra = convert.read_jax_checkpoint(d)
    carried.append(convert.preconditioner_from_jax(extra["precond"]))
    for got, want in [(b, a)] + [(c, jpre) for c in carried]:
        for f in ("indices", "rows", "vectors", "damping", "eigenvalues"):
            w = np.asarray(getattr(want, f))
            g = getattr(got, f)
            assert g.dtype == {"indices": np.int64, "eigenvalues":
                               np.float64}.get(f, np.float32)
            np.testing.assert_array_equal(g, w)
        assert (got.n, got.damping_power, got.safety) == \
            (want.n, want.damping_power, want.safety)
    blk = a.block(torch.device("cpu"))
    assert blk.indices.dtype == torch.int64 and blk.rows.dtype == torch.float32
    assert torch.equal(blk.vectors, torch.from_numpy(a.vectors))


# --- the correction and the preconditioned gradients -------------------------

def _pc_pair(jcfg, x, k=6, m=48):
    jpre = _jax_pre(jcfg, x, k=k, m=m)
    return jpre.block(), convert.preconditioner_from_jax(jpre).block(
        torch.device("cpu"))


@pytest.mark.parametrize("jimpl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("n_i,j_union", [(24, 16), (83, 48)])
def test_precond_correction_matches_jax(jimpl, n_i, j_union):
    jcfg, tcfg = _cfgs()
    x, _ = _data()
    jpc, tpc = _pc_pair(jcfg, x)
    rng = np.random.default_rng(3)
    xi = x[rng.integers(0, N, n_i)]
    v = rng.standard_normal(n_i).astype(np.float32)
    want = jd.precond_correction(jcfg.replace(impl=jimpl), jnp.asarray(xi),
                                 jnp.asarray(v), jpc, j_union)
    got = td.precond_correction(tcfg, torch.from_numpy(xi),
                                torch.from_numpy(v), tpc, j_union)
    assert got.shape == (48,)
    _close(got, want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
@pytest.mark.parametrize("loss,unbiased", [("hinge", False),
                                           ("square", True),
                                           ("logistic", False)])
def test_grad_block_precond_matches_jax(fuse, loss, unbiased):
    jcfg, tcfg = _cfgs(loss=loss, fuse_dual_pass=fuse,
                       unbiased_scaling=unbiased)
    x, y = _data(square=loss == "square")
    jpc, tpc = _pc_pair(jcfg, x)
    rng = np.random.default_rng(4)
    ii, jj = rng.integers(0, N, NG), rng.integers(0, N, NE)
    aj = rng.standard_normal(NE).astype(np.float32)
    args = (x[ii], y[ii], x[jj], aj)
    wg, wd = jd.grad_block_precond(jcfg, *map(jnp.asarray, args), jpc, N)
    gg, gd = td.grad_block_precond(tcfg, *map(torch.from_numpy, args), tpc,
                                   N)
    _close(gg, wg)
    _close(gd, wd)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
@pytest.mark.parametrize("loss", ["hinge", "square"])
def test_grad_block_parallel_precond_matches_jax(fuse, loss):
    jcfg, tcfg = _cfgs(loss=loss, fuse_dual_pass=fuse, n_workers=K)
    x, y = _data(square=loss == "square")
    jpc, tpc = _pc_pair(jcfg, x)
    rng = np.random.default_rng(5)
    ii = rng.integers(0, N, NG)
    jk = rng.permutation(N)[:K * NE].reshape(K, NE)
    ajk = rng.standard_normal((K, NE)).astype(np.float32)
    args = (x[ii], y[ii], x[jk], ajk)
    wg, wd = jd.grad_block_parallel_precond(jcfg, *map(jnp.asarray, args),
                                            jpc, N)
    gg, gd = td.grad_block_parallel_precond(
        tcfg, *map(torch.from_numpy, args), tpc, N)
    _close(gg, wg)
    _close(gd, wd)


@pytest.mark.parametrize("schedule", ["adagrad", "inv_t", "const"])
@pytest.mark.parametrize("parallel", [False, True], ids=["alg1", "alg2"])
def test_apply_update_precond_matches_jax(schedule, parallel):
    jcfg, tcfg = _cfgs(schedule=schedule, lr0=0.3)
    rng = np.random.default_rng(6)
    alpha = rng.standard_normal(N).astype(np.float32)
    accum = (1.0 + rng.random(N)).astype(np.float32)
    idx_j = (rng.permutation(N)[:K * NE] if parallel
             else rng.integers(0, N, NE))
    g = rng.standard_normal(idx_j.shape[0]).astype(np.float32)
    idx_p = np.sort(rng.permutation(N)[:48])
    delta = rng.standard_normal(48).astype(np.float32)
    jst = jd.DSEKLState(alpha=jnp.asarray(alpha), accum=jnp.asarray(accum),
                        step=jnp.asarray(4, jnp.int32),
                        epoch=jnp.asarray(1, jnp.int32))
    tst = td.DSEKLState(alpha=torch.from_numpy(alpha),
                        accum=torch.from_numpy(accum),
                        step=torch.tensor(4, dtype=torch.int32),
                        epoch=torch.tensor(1, dtype=torch.int32))
    jfn = jd.apply_update_parallel_precond if parallel else \
        jd.apply_update_precond
    tfn = td.apply_update_parallel_precond if parallel else \
        td.apply_update_precond
    want = jfn(jcfg, jst, *map(jnp.asarray, (idx_j, g, idx_p, delta)))
    got = tfn(tcfg, tst, *map(torch.from_numpy, (idx_j, g, idx_p, delta)))
    _close(got.alpha, want.alpha)
    _close(got.accum, want.accum)
    assert int(got.step) == int(want.step) == 5
    assert np.array_equal(alpha, tst.alpha.numpy())        # out of place


# --- preconditioned fits on JAX's plans --------------------------------------

def _jax_plans(algorithm, key, n_epochs, n=N):
    plans = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        if algorithm == "serial":
            p = jsampler.epoch_plan(sub, n, NG, NE, max(n // NG, 1))
        else:
            p = jsampler.parallel_epoch_plan(sub, n, NG, NE, K)
        plans.append(tuple(np.array(a) for a in p))
    return plans


@pytest.mark.parametrize("schedule", ["const", "adagrad"])
@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_preconditioned_fit_matches_jax(algorithm, schedule):
    """Two epochs with a JAX-built preconditioner carried across, on JAX's
    plans; under const both fits take the auto step size."""
    # const runs the convergence protocol's unbiased N/|J| scaling.
    jcfg, tcfg = _cfgs(loss="square", schedule=schedule, lr0=0.5,
                       n_workers=K if algorithm == "parallel" else 1,
                       unbiased_scaling=schedule == "const")
    x, y = _data(square=True)
    jpre = _jax_pre(jcfg, x)
    key = jax.random.PRNGKey(3)
    want = jfit(jcfg, jnp.asarray(x), jnp.asarray(y), key,
                algorithm=algorithm, n_epochs=2, tol=0.0, precondition=jpre)
    got = fit(tcfg, x, y, plans=_jax_plans(algorithm, key, 2),
              algorithm=algorithm, n_epochs=2, tol=0.0,
              precondition=convert.preconditioner_from_jax(jpre),
              device="cpu")
    _close(got.state.alpha, want.state.alpha)
    _close(got.state.accum, want.state.accum)
    assert int(got.state.step) == int(want.state.step)
    plain = fit(tcfg, x, y, plans=_jax_plans(algorithm, key, 2),
                algorithm=algorithm, n_epochs=2, tol=0.0, device="cpu")
    assert not torch.equal(plain.state.alpha, got.state.alpha)


# --- the port's own contracts ------------------------------------------------

def _bitwise(a, b):
    for name in ("alpha", "accum", "step", "epoch"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), \
            name


def _plans(algorithm, n_epochs, seed=0, n=N):
    gen = torch.Generator().manual_seed(seed)
    if algorithm == "serial":
        return [tsampler.epoch_plan(gen, n, NG, NE, max(n // NG, 1))
                for _ in range(n_epochs)]
    return [tsampler.parallel_epoch_plan(gen, n, NG, NE, K)
            for _ in range(n_epochs)]


@pytest.mark.parametrize("execution", ["serial", "parallel", "hosted"])
def test_precondition_zero_is_bit_identical(execution):
    """precondition=0, cfg.precondition_k = 0 and no argument run the same
    fit, bit for bit, with the same generator draws."""
    _, tcfg = _cfgs(n_workers=K)
    x, y = _data()
    algorithm = "parallel" if execution == "parallel" else "serial"
    runs = []
    for kw in ({}, {"precondition": 0},
               {"precondition": None, "cfg": tcfg.replace(precondition_k=0)}):
        cfg = kw.pop("cfg", tcfg)
        data = (HostSource(x, y), None) if execution == "hosted" else (x, y)
        runs.append(fit(cfg, *data, torch.Generator().manual_seed(3),
                        execution=execution, algorithm=algorithm,
                        n_epochs=2, tol=0.0, device="cpu", **kw))
    for r in runs[1:]:
        _bitwise(runs[0], r)
        assert r.precond is None and r.estimate_s == 0.0


@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_hosted_equals_in_memory_with_precondition(algorithm):
    """Preconditioned: hosted prefetched == hosted inline == in memory,
    for Algorithm 1 and Algorithm 2, bit for bit; and the correction
    fired (the plain fit differs)."""
    _, tcfg = _cfgs(n_workers=K if algorithm == "parallel" else 1)
    x, y = _data()
    pre = _port_pre(tcfg, x)
    kw = dict(plans=_plans(algorithm, 3, seed=7), algorithm=algorithm,
              n_epochs=3, tol=0.0, device="cpu")
    mem = fit(tcfg, x, y, precondition=pre, **kw)
    for prefetch in (True, False):
        host = fit(tcfg, HostSource(x, y), None, prefetch=prefetch,
                   precondition=pre, **kw)
        _bitwise(mem, host)
    plain = fit(tcfg, x, y, **kw)
    assert not torch.equal(plain.state.alpha, mem.state.alpha)


@pytest.mark.parametrize("execution", ["serial", "hosted"])
def test_resumed_preconditioned_fit_is_bit_identical(tmp_path, execution):
    _, tcfg = _cfgs()
    x, y = _data()

    def data():
        return (HostSource(x, y), None) if execution == "hosted" else (x, y)

    kw = dict(execution=execution, tol=0.0, precondition=6, device="cpu")
    full = fit(tcfg, *data(), torch.Generator().manual_seed(5), n_epochs=4,
               **kw)
    d = str(tmp_path / "ckpt")
    first = fit(tcfg, *data(), torch.Generator().manual_seed(5), n_epochs=2,
                checkpoint_dir=d, **kw)
    assert first.estimate_s > 0.0
    # The resumed fit restores the preconditioner: another seed would
    # draw another subsample if it estimated again.
    res = fit(tcfg, *data(), torch.Generator().manual_seed(999), n_epochs=4,
              checkpoint_dir=d, resume=True, **kw)
    assert res.estimate_s == 0.0
    _bitwise(full, res)
    np.testing.assert_array_equal(res.precond.vectors, full.precond.vectors)


def test_snapshot_extra_carries_the_preconditioner_only_when_on(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    _, tcfg = _cfgs()
    x, y = _data()
    for k, d in ((4, tmp_path / "on"), (0, tmp_path / "off")):
        res = fit(tcfg, x, y, torch.Generator().manual_seed(6), n_epochs=1,
                  tol=0.0, precondition=k, checkpoint_dir=str(d),
                  device="cpu")
        mgr = CheckpointManager(str(d), keep=3)
        _, _, extra = mgr.restore(mgr.latest_valid_step())
        if k:
            pre = tp.EigenProPreconditioner.from_extra(extra["precond"])
            assert pre.k == 4
            np.testing.assert_array_equal(pre.vectors, res.precond.vectors)
        else:
            assert "precond" not in extra
            assert set(extra) == {"epoch", "history", "converged"}


def test_auto_lr_applies_under_const_only():
    _, tcfg = _cfgs()
    x, y = _data()
    pre = _port_pre(tcfg, x)
    plans = _plans("serial", 1, seed=8)
    kw = dict(plans=plans, n_epochs=1, tol=0.0, precondition=pre,
              device="cpu")
    const = tcfg.replace(schedule="const", lr0=1e-9)
    auto = fit(const, x, y, **kw)
    tiny = fit(const.replace(precondition_auto_lr=False), x, y, **kw)
    assert float(auto.state.alpha.abs().max()) > 100 * float(
        tiny.state.alpha.abs().max())
    # The auto rate is pre.step_size(n_expand): the same fit with that lr0
    # and the rule off is the same fit.
    manual = fit(const.replace(lr0=pre.step_size(NE),
                               precondition_auto_lr=False), x, y, **kw)
    _bitwise(auto, manual)
    # adagrad keeps its lr0.
    ada = tcfg.replace(lr0=1e-9)
    _bitwise(fit(ada, x, y, **kw),
             fit(ada.replace(precondition_auto_lr=False), x, y, **kw))
    # Algorithm 2's rule reads |J| = n_workers * n_expand.
    par = const.replace(n_workers=K)
    kw2 = dict(kw, plans=_plans("parallel", 1, seed=8), algorithm="parallel")
    _bitwise(fit(par, x, y, **kw2),
             fit(par.replace(lr0=pre.step_size(K * NE),
                             precondition_auto_lr=False), x, y, **kw2))


def test_preconditioned_and_plain_fits_draw_the_same_epochs():
    """The estimate draws from its own generator (seeded from the fit's
    and the tag), never from the fit's."""
    _, tcfg = _cfgs(precondition_m=48)
    x, y = _data()
    g_pre, g_plain = (torch.Generator().manual_seed(9) for _ in range(2))
    for gen, k in ((g_pre, 6), (g_plain, 0)):
        fit(tcfg, x, y, gen, n_epochs=2, tol=0.0, precondition=k,
            device="cpu")
    assert torch.equal(g_pre.get_state(), g_plain.get_state())
    est = tp.estimate_preconditioner(
        tcfg, x, tsolver._precond_generator(torch.Generator().manual_seed(9)),
        k=6, device="cpu")
    res = fit(tcfg, x, y, torch.Generator().manual_seed(9), n_epochs=1,
              tol=0.0, precondition=6, device="cpu")
    np.testing.assert_array_equal(res.precond.indices, est.indices)
    other = fit(tcfg, x, y, torch.Generator().manual_seed(10), n_epochs=1,
                tol=0.0, precondition=6, device="cpu")
    assert not np.array_equal(other.precond.indices, est.indices)


def test_fit_refusals_with_precondition():
    _, tcfg = _cfgs()
    x, y = _data()
    with pytest.raises(ValueError, match="EigenProPreconditioner"):
        fit(tcfg, x, y, plans=_plans("serial", 1), n_epochs=1,
            precondition=4, device="cpu")
    # The mesh (item 6's DSEKL half) is ported: EigenPro rides on its
    # step, here on a world of one, torn down after the fit.
    res = fit(tcfg.replace(precondition_k=4), x, y, torch.Generator(),
              execution="mesh", n_epochs=1, device="cpu")
    assert res.precond.k == 4 and bool(torch.isfinite(res.state.alpha).all())
    assert not torch.distributed.is_initialized()
    # BCD (item 5) is ported and refuses EigenPro in JAX's words.
    with pytest.raises(ValueError, match="EigenPro preconditioning applies "
                                         "to the stochastic step only"):
        fit(tcfg.replace(precondition_k=4, loss="square"), x, y,
            torch.Generator(), execution="bcd", n_epochs=1, device="cpu")


def test_launcher_trains_with_precondition_k(capsys):
    args = ["--dsekl", "--device", "cpu", "--n", "2048", "--epochs", "2",
            "--n-grad", "128", "--n-expand", "128"]
    out = train.train_dsekl(train.parser().parse_args(
        args + ["--precondition-k", "8"]))
    text = capsys.readouterr().out
    assert "[train-dsekl] EigenPro preconditioning: top-8 Nystrom " \
        "eigensystem" in text
    assert "[dsekl] EigenPro: k=8, m=512" in text
    res = out["result"]
    assert out["cfg"].precondition_k == 8 and res.precond.k == 8
    assert res.precond.n == out["x"].shape[0] and res.estimate_s > 0.0
    assert bool(torch.isfinite(res.state.alpha).all())
    assert len([h for h in res.history if "val_error" in h]) == 2
    plain = train.train_dsekl(train.parser().parse_args(args))["result"]
    assert int(plain.state.step) == int(res.state.step)
    assert not torch.equal(plain.state.alpha, res.state.alpha)
    # The launcher's command line takes it end to end.
    train.main(args + ["--precondition-k", "8"])
    assert "[dsekl] EigenPro: k=8, m=512" in capsys.readouterr().out


# --- the CUDA path, with counting stand-ins ----------------------------------

def _counting(plain):
    def f(*args, **kw):
        f.launches += 1
        with torch._C.DisableTorchFunction():
            return plain(*args, **kw)
    f.launches = 0
    return f


def _stand_ins(monkeypatch):
    stand_ins = {n: _counting(getattr(tblock, p)) for n, p in [
        ("kernel_matvec_cuda", "kernel_matvec_plain"),
        ("kernel_vecmat_cuda", "kernel_vecmat_plain"),
        ("dual_pass_cuda", "dual_pass_plain"),
        ("train_pass_cuda", "train_pass_plain"),
        ("train_pass_indexed_cuda", "train_pass_indexed_plain")]}
    for name, fn in stand_ins.items():
        monkeypatch.setattr(tblock, name, fn)
    return stand_ins


class _GatherWatch(TorchFunctionMode):
    """Records every gather (indexing, index_select, take, gather) by the
    tensor it reads."""

    def __init__(self, watched):
        super().__init__()
        self.watched = watched
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") in (
                "__getitem__", "index_select", "take", "gather")
                and args and isinstance(args[0], torch.Tensor)):
            self.seen.append(next((n for n, t in self.watched.items()
                                   if t() is args[0]), "other"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_preconditioned_step_on_cuda_is_one_train_pass_and_one_vecmat(
        monkeypatch, algorithm):
    """On the CUDA backend (stand-ins) a preconditioned step makes one
    indexed train-pass call and one vecmat call, gathers x and y at I and
    nothing else, and leaves the state of the ref step; the plain step
    makes the one train-pass call alone and gathers nothing."""
    stand_ins = _stand_ins(monkeypatch)
    n = 1500
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((n, D)) / np.sqrt(D)).astype(np.float32)
    y = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0).astype(np.float32)
    _, tcfg = _cfgs(loss="hinge", n_grad=83, n_expand=300, lr0=0.5,
                    n_workers=4 if algorithm == "parallel" else 1)
    pre = _port_pre(tcfg, x, k=8, m=64)
    pc = pre.block(torch.device("cpu"))
    if algorithm == "serial":
        plan = [(torch.from_numpy(rng.integers(0, n, 83)),
                 torch.from_numpy(rng.integers(0, n, 300))) for _ in range(3)]
        step = td.step_serial
    else:
        plan = [(torch.from_numpy(rng.integers(0, n, 83)),
                 torch.from_numpy(rng.permutation(n)[:1200].reshape(4, 300)))
                for _ in range(3)]
        step = td._parallel_inner
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    runs = {}
    for impl, p in (("cuda", pc), ("ref", pc), ("cuda", None)):
        for f in stand_ins.values():
            f.launches = 0
        st = td.init_state(n, device="cpu")
        current = {"x": lambda: tx, "y": lambda: ty}
        watch = _GatherWatch(current)
        with watch:
            for idx_i, idx_j in plan:
                current["alpha"] = lambda a=st.alpha: a
                st = step(tcfg.replace(impl=impl), st, tx, ty, idx_i, idx_j,
                          p)
        runs[impl, p is None] = (st, watch.seen,
                                 {k: f.launches for k, f in stand_ins.items()})
    st, seen, launches = runs["cuda", False]
    assert launches == {"kernel_matvec_cuda": 0, "kernel_vecmat_cuda": 3,
                        "dual_pass_cuda": 0, "train_pass_cuda": 0,
                        "train_pass_indexed_cuda": 3}
    # (the scatter's read of the adagrad accumulator is "other")
    assert sorted(n for n in seen if n != "other") == \
        ["x", "x", "x", "y", "y", "y"], seen
    ref = runs["ref", False][0]
    _close(st.alpha, ref.alpha)
    _close(st.accum, ref.accum)
    st0, seen0, launches0 = runs["cuda", True]
    assert launches0 == dict(launches, kernel_vecmat_cuda=0)
    assert not {"x", "y", "alpha"} & set(seen0), seen0
    assert not torch.equal(st0.alpha, st.alpha)


def test_correction_vecmat_runs_the_cuda_wrapper(monkeypatch):
    """``precond_correction`` on the CUDA backend calls the vecmat
    wrapper once, with the gradient rows and the subsample rows."""
    stand_ins = _stand_ins(monkeypatch)
    _, tcfg = _cfgs()
    x, _ = _data()
    pc = _port_pre(tcfg, x).block(torch.device("cpu"))
    xi = torch.from_numpy(x[:83])
    v = torch.linspace(-1.0, 1.0, 83)
    got = td.precond_correction(tcfg.replace(impl="cuda"), xi, v, pc, NE)
    want = td.precond_correction(tcfg.replace(impl="ref"), xi, v, pc, NE)
    assert stand_ins["kernel_vecmat_cuda"].launches == 1
    assert sum(f.launches for f in stand_ins.values()) == 1
    _close(got, want.numpy())
    assert tops.resolve_impl("auto", "rbf", xi.device) == "ref"
