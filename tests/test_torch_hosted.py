"""The port's hosted execution: either algorithm over a host-resident
``DataSource`` (``trainer.HostedPlan``), its streamed eval and its
launcher, against the port's own in-memory fits and the JAX package's
hosted fits.

* Hosted equals in-memory bit for bit on the CPU, for both algorithms,
  prefetched and inline (``tests/test_trainer_matrix.py``'s contract):
  the same plans gather the same rows into the same block cores.
* Hosted against JAX's hosted fit on JAX's plans: the JAX suite's float32
  tolerance, rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf), after 2 epochs
  of a smooth loss (square): sums in another order, fed back each step.
* ``decision_function_source`` against JAX's, the ragged tail padded with
  zero alpha, at the same tolerance.
* A resumed ``parallel`` or ``hosted`` fit equals the uninterrupted one
  bit for bit (the snapshot's generator state is taken before the plan
  of the next epoch is drawn ahead).
* ``resolve_execution`` / ``make_plan`` resolve and refuse as JAX's do.
* ``launch/train.py --data mmap --algorithm parallel --device cpu``.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed

from repro.core import dsekl as jd
from repro.core import trainer as jtrainer
from repro.core.solver import fit as jfit
from repro.data import source as jsource
from repro_torch.core import dsekl as td
from repro_torch.core import sampler as tsampler
from repro_torch.core import trainer as ttrainer
from repro_torch.core.solver import fit, train_epoch_hosted
from repro_torch.data import HostSource, InMemorySource

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, NG, NE, K = 200, 4, 16, 12, 3
RTOL, ATOL = 2e-4, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N + 40, D)).astype(np.float32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                 -1.0).astype(np.float32)
    return x[:N], y[:N], x[N:], y[N:]


def _cfg(algorithm="serial", **kw):
    base = dict(n_grad=NG, n_expand=NE, kernel="rbf",
                kernel_params=(("gamma", 0.5),), lam=1e-3, lr0=0.5,
                loss="square", schedule="adagrad",
                n_workers=K if algorithm == "parallel" else 1)
    base.update(kw)
    return td.DSEKLConfig(**base)


def _plans(algorithm, n_epochs, seed=0, n=N):
    gen = torch.Generator().manual_seed(seed)
    if algorithm == "serial":
        return [tsampler.epoch_plan(gen, n, NG, NE, max(n // NG, 1))
                for _ in range(n_epochs)]
    return [tsampler.parallel_epoch_plan(gen, n, NG, NE, K)
            for _ in range(n_epochs)]


def _bitwise(a, b):
    for name in ("alpha", "accum", "step", "epoch"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), \
            name


@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_hosted_equals_in_memory_bit_for_bit(data, algorithm):
    x, y, xv, yv = data
    cfg = _cfg(algorithm, loss="hinge")
    plans = _plans(algorithm, 3, seed=7)
    kw = dict(plans=plans, algorithm=algorithm, n_epochs=3, tol=0.0,
              x_val=xv, y_val=yv, device="cpu")
    mem = fit(cfg, x, y, **kw)
    host = fit(cfg, HostSource(x, y), None, **kw)
    sync = fit(cfg, HostSource(x, y), None, prefetch=False, **kw)
    raw = fit(cfg, x, y, execution="hosted", **kw)        # host mirror
    assert mem.loader is None
    for r in (host, sync, raw):
        _bitwise(mem, r)
        assert [h["val_error"] for h in r.history] == \
            [h["val_error"] for h in mem.history]
        assert r.loader["steps"] == 3 * len(plans[0][0])
    assert host.loader["gather_s"] > 0.0
    assert sync.loader["wait_s"] == sync.loader["gather_s"]
    # An InMemorySource trains in memory under "auto".
    src = fit(cfg, InMemorySource(x, y), None, **kw)
    _bitwise(mem, src)
    assert src.loader is None


def _jax_hosted(algorithm, cfg, x, y, xv, yv, key, n_epochs):
    jcfg = jd.DSEKLConfig(**{f: getattr(cfg, f) for f in (
        "n_grad", "n_expand", "kernel", "kernel_params", "loss", "lam",
        "lr0", "schedule", "n_workers")}, impl="ref")
    return jfit(jcfg, jsource.HostSource(x, y), None, key,
                algorithm=algorithm, n_epochs=n_epochs, tol=0.0,
                x_val=jnp.asarray(xv), y_val=jnp.asarray(yv))


def _jax_plans(algorithm, key, n_epochs, n=N):
    from repro.core import sampler as jsampler
    plans = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        if algorithm == "serial":
            p = jsampler.epoch_plan(sub, n, NG, NE, max(n // NG, 1))
        else:
            p = jsampler.parallel_epoch_plan(sub, n, NG, NE, K)
        plans.append(tuple(np.array(a) for a in p))
    return plans


@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_hosted_fit_matches_jax_hosted_fit(data, algorithm):
    x, y, xv, yv = data
    cfg = _cfg(algorithm)
    key = jax.random.PRNGKey(4)
    jres = _jax_hosted(algorithm, cfg, x, y, xv, yv, key, 2)
    tres = fit(cfg, HostSource(x, y), None,
               plans=_jax_plans(algorithm, key, 2), algorithm=algorithm,
               n_epochs=2, tol=0.0, x_val=xv, y_val=yv, device="cpu")
    _close(tres.state.alpha, jres.state.alpha)
    _close(tres.state.accum, jres.state.accum)
    assert int(tres.state.step) == int(jres.state.step)
    assert tres.loader["steps"] == jres.loader["steps"]
    for th, jh in zip(tres.history, jres.history, strict=True):
        assert abs(th["val_error"] - jh["val_error"]) <= 1.0 / len(yv) + 1e-9


@pytest.mark.parametrize("n,chunk", [(200, 64), (200, 256), (130, 130)])
def test_decision_function_source_matches_jax(data, n, chunk):
    x, y, xv, _ = data
    rng = np.random.default_rng(n)
    alpha = rng.standard_normal(N).astype(np.float32)
    cfg = _cfg()
    jcfg = jd.DSEKLConfig(kernel="rbf", kernel_params=(("gamma", 0.5),),
                          impl="ref")
    want = jd.decision_function_source(
        jcfg, jnp.asarray(alpha[:n]), jsource.HostSource(x[:n], y[:n]),
        jnp.asarray(xv), chunk=chunk)
    got = td.decision_function_source(
        cfg, torch.from_numpy(alpha[:n]), HostSource(x[:n], y[:n]),
        torch.from_numpy(xv), chunk=chunk)
    _close(got, want)
    on_device = td.decision_function_ref(
        cfg, torch.from_numpy(alpha[:n]), torch.from_numpy(x[:n]),
        torch.from_numpy(xv), chunk=chunk)
    assert torch.equal(got, on_device)


@pytest.mark.parametrize("execution", ["parallel", "hosted"])
def test_resume_equals_uninterrupted(data, tmp_path, execution):
    x, y, xv, yv = data
    cfg = _cfg("parallel", loss="hinge")
    args = (x, y) if execution == "parallel" else (HostSource(x, y), None)
    kw = dict(algorithm="parallel", tol=0.0, x_val=xv, y_val=yv,
              truncate_every=2, device="cpu")
    full = fit(cfg, *args, torch.Generator().manual_seed(3), n_epochs=4,
               **kw)
    d = str(tmp_path / execution)
    fit(cfg, *args, torch.Generator().manual_seed(3), n_epochs=2,
        checkpoint_dir=d, **kw)
    res = fit(cfg, *args, torch.Generator().manual_seed(999), n_epochs=4,
              checkpoint_dir=d, resume=True, **kw)
    _bitwise(full, res)
    strip = [{k: v for k, v in h.items() if k != "seconds"}
             for h in full.history]
    assert strip == [{k: v for k, v in h.items() if k != "seconds"}
                     for h in res.history]


def test_one_prefetcher_serves_the_fit(data, monkeypatch):
    """ONE BlockPrefetcher (one worker thread) serves every epoch, fed one
    epoch ahead; its counters accumulate, and a fit that converges early
    counts only the steps it ran."""
    x, y, _, _ = data
    made = []
    real = ttrainer.BlockPrefetcher

    class Counting(real):
        def __init__(self, *a, **kw):
            made.append(self)
            super().__init__(*a, **kw)

    monkeypatch.setattr(ttrainer, "BlockPrefetcher", Counting)
    cfg = _cfg()
    gen = torch.Generator().manual_seed(2)
    res = fit(cfg, HostSource(x, y), None, gen, n_epochs=3, tol=0.0,
              device="cpu")
    assert len(made) == 1 and not made[0]._thread.is_alive()
    assert res.loader["steps"] == 3 * (N // NG) and made[0].steps == 3 * 12
    res = fit(cfg, HostSource(x, y), None, gen, n_epochs=5, tol=1e9,
              device="cpu")
    assert res.converged and res.epochs_run == 1
    assert res.loader["steps"] == N // NG
    assert made[1].steps == 2 * (N // NG)          # one epoch planned ahead


def test_hosted_epochs_run_in_planned_order(data):
    x, y, _, _ = data
    cfg = _cfg("parallel")
    p1, p2 = _plans("parallel", 2, seed=5)
    with ttrainer.HostedPlan(cfg, HostSource(x, y), algorithm="parallel",
                             device=torch.device("cpu")) as plan:
        state = plan.init_state()
        plan.plan_epoch(p1)
        worker = plan._loader._thread
        plan.plan_epoch(p2)
        with pytest.raises(RuntimeError, match="order"):
            plan.run_epoch(state, p2)
        state = plan.run_epoch(state, p1)
        state = plan.run_epoch(state, p2)
        assert plan._loader._thread is worker
        assert plan.loader_stats()["steps"] == 2 * (N // NG)
    assert not worker.is_alive()
    one = train_epoch_hosted(cfg, td.init_state(N, device="cpu"),
                             HostSource(x, y), p1, algorithm="parallel",
                             device="cpu")
    ref = fit(cfg, x, y, plans=[p1], algorithm="parallel", n_epochs=1,
              tol=0.0, device="cpu")
    assert torch.equal(one.alpha, ref.state.alpha)


def test_hosted_parallel_below_one_batch(data):
    x, y, _, _ = data
    cfg = _cfg("parallel")
    res = fit(cfg, HostSource(x[: NG - 1], y[: NG - 1]), None,
              torch.Generator().manual_seed(0), algorithm="parallel",
              n_epochs=2, tol=-1.0, device="cpu")
    assert int(res.state.step) == 0 and int(res.state.epoch) == 2
    assert res.loader["steps"] == 0
    assert torch.equal(res.state.alpha, torch.zeros(NG - 1))


def test_resolution_and_refusals_match_jax(data):
    x, y, _, _ = data
    cfg = _cfg()
    jcfg = jd.DSEKLConfig()
    for ex, alg, hosted in [("auto", "serial", False),
                            ("auto", "parallel", False),
                            ("auto", "serial", True),
                            ("auto", "parallel", True),
                            ("serial", "parallel", True),
                            ("hosted", "serial", False), ("mesh", "serial",
                                                          False),
                            (None, "parallel", False)]:
        assert ttrainer.resolve_execution(ex, cfg, algorithm=alg,
                                          hosted_data=hosted) == \
            jtrainer.resolve_execution(ex, jcfg, algorithm=alg,
                                       hosted_data=hosted)
        # A mesh makes "auto" resolve to mesh in both packages.
        assert ttrainer.resolve_execution(ex, cfg, algorithm=alg,
                                          hosted_data=hosted,
                                          mesh=object()) == \
            jtrainer.resolve_execution(ex, jcfg, algorithm=alg,
                                       hosted_data=hosted, mesh=object())
    with pytest.raises(ValueError, match="unknown execution"):
        ttrainer.resolve_execution("banana", cfg)
    gen = torch.Generator()
    with pytest.raises(ValueError, match="out of core"):
        fit(cfg, HostSource(x, y), None, gen, execution="serial",
            n_epochs=1, device="cpu")
    with pytest.raises(TypeError, match="labels from the source"):
        fit(cfg, HostSource(x, y), y, gen, n_epochs=1, device="cpu")
    with pytest.raises(ValueError, match="needs a DataSource"):
        ttrainer.make_plan("hosted", cfg, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="device-resident"):
        ttrainer.make_plan("parallel", cfg, source=HostSource(x, y))
    with pytest.raises(ValueError, match="needs a DataSource"):
        ttrainer.make_plan("mesh", cfg, device=torch.device("cpu"))
    for args in ((x, y), (HostSource(x, y), None)):
        # The mesh (item 6's DSEKL half) is ported: a world of one trains
        # the same steps as Algorithm 1 and is torn down.
        res = fit(cfg, *args, gen, execution="mesh", n_epochs=1,
                  device="cpu")
        assert int(res.state.step) == N // NG and res.loader["steps"] == \
            N // NG
        assert not torch.distributed.is_initialized()
        # BCD (item 5) is ported: square loss only, in JAX's words.
        with pytest.raises(ValueError, match="set loss='square'"):
            fit(cfg.replace(loss="hinge"), *args, gen, execution="bcd",
                n_epochs=1, device="cpu")
        res = fit(cfg.replace(loss="square"), *args, gen, execution="bcd",
                  n_epochs=1, device="cpu")
        assert int(res.state.step) == 1 and res.loader["steps"] == 2 * (
            -(-N // NG))
    # EigenPro (item 4) is ported: a hosted fit takes it.
    res = fit(cfg.replace(precondition_k=2, precondition_m=16),
              HostSource(x, y), None, gen, n_epochs=1, device="cpu")
    assert res.precond.k == 2 and res.loader["steps"] == N // NG


def test_launcher_trains_parallel_from_a_memmap(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["--dsekl", "--device", "cpu", "--n", "4096", "--epochs", "2",
            "--n-grad", "256", "--n-expand", "128", "--data", "mmap",
            "--mmap-dir", str(tmp_path), "--algorithm", "parallel",
            "--workers", "4"]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(ln.startswith("[train-dsekl] mmap dataset: 4096 x 54")
               for ln in lines)
    assert sum(ln.startswith("[dsekl] epoch") and "val_err=" in ln
               for ln in lines) == 2
    summary = [ln for ln in lines if ln.startswith("[train-dsekl] 2 epochs")]
    assert summary and "parallel, prefetch" in summary[0]
    assert "host gather" in summary[0] and "hidden" in summary[0]
    assert (tmp_path / "manifest.json").is_file()
