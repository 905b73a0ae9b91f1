"""The port's online train-to-serve loop (``serving/online.py``) against
the JAX package's ``OnlineService``, and its own contracts, on the CPU.

* Parity: a JAX service and the port's on the same ring events, the port
  fed JAX's epoch plans (``plan_fn`` replays the service's
  ``jax.random.split`` chain through ``repro.core.sampler.epoch_plan``),
  square loss (no hinge flips), adagrad (so a rebuild's carry of accum
  counts as well as alpha's).  The publish logs are equal in every field
  but ``alpha_crc``; in each published alpha the rows that hold exactly 0
  (not yet reached by a step, or added by a rebuild) are 0 on both sides,
  and the rest agree at rtol 2e-4, atol 1e-5 x |ref|_inf, their median
  |ref| above 100x that atol (so a zero or flipped alpha cannot pass); at
  least one rebuild happens.
  The same from a JAX checkpoint carried over by
  ``convert.online_state_from_jax``.
* The port's concurrency soak: three writers submit and flush while the
  fit thread publishes and rebuilds; every ticket is answered once, and
  every response is bit-identical to a fresh engine built on its
  version's recorded ``(alpha, snapshot)``.
* A service stopped after 3 epochs and resumed from its checkpoint
  publishes the uninterrupted service's log and state, bit for bit.
* ``stats()`` / ``cache_info()`` are fresh snapshots; quotas survive a
  rebuild; a rebuild's warm-up keeps no tile; the service's refusals.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro.data import RingSource as JRingSource
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import OnlineService as JOnlineService
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.data import RingSource
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 OnlineService)

D, CAP, N0, FEED = 6, 384, 192, 32
RTOL, ATOL = 2e-4, 1e-5
FIELDS = dict(n_grad=32, n_expand=32, lam=1e-4, loss="square",
              schedule="adagrad", kernel="rbf",
              kernel_params=(("gamma", 0.5),), lr0=0.5)
CFG = DSEKLConfig(**FIELDS)
JCFG = jd.DSEKLConfig(**FIELDS, impl="ref")
ENGINE = dict(query_block=32, sv_block=64)


def _events(seed, m):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, D)).astype(np.float32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0, 1.0,
                 -1.0).astype(np.float32)
    return x, y


def _ring(cls=RingSource):
    ring = cls(CAP, D)
    ring.append(*_events(21, N0))
    return ring


def _feed(svc, epoch):
    svc.append(*_events((22, epoch), FEED))


def jax_plan_fn(key, cfg=CFG):
    """The JAX service's per-epoch chain ``key, sub = split(key)``, each
    sub's ``epoch_plan`` drawn on the snapshot the epoch trains."""
    subs = []

    def plan_fn(epoch, n):
        nonlocal key
        while len(subs) <= epoch:
            key, sub = jax.random.split(key)
            subs.append(sub)
        steps = max(n // cfg.n_grad, 1)
        return tuple(np.asarray(a) for a in jsampler.epoch_plan(
            subs[epoch], n, cfg.n_grad, cfg.n_expand, steps))

    return plan_fn


def _run(svc):
    svc.start()
    svc.join(timeout=300)
    assert svc.error is None, svc.error
    return svc


def _strip(log):
    return [{k: v for k, v in r.items() if k != "alpha_crc"} for r in log]


def _close_biting(got, want, what):
    """Rows no step has reached (and rows a rebuild added) hold exactly 0
    on both sides; the rest are held at the tolerance, their median |ref|
    above 100x the atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    zero = want == 0.0
    np.testing.assert_array_equal(got[zero], want[zero], err_msg=what)
    assert zero.mean() < 0.75, f"{what}: {zero.mean():.0%} of alpha is 0"
    held = want[~zero]
    atol = ATOL * float(np.abs(held).max())
    median = float(np.median(np.abs(held)))
    assert median > 100 * atol, f"{what}: median |ref| {median} too small"
    np.testing.assert_allclose(got[~zero], held, rtol=RTOL, atol=atol,
                               err_msg=what)


def _hold_published(tsvc, jsvc, after=-1):
    """Equal logs; every version published after ``after`` held."""
    assert _strip(tsvc.publish_log) == _strip(jsvc.publish_log)
    held = 0
    for entry in jsvc.publish_log:
        v = entry["version"]
        if v <= after:
            continue
        held += 1
        ja, jsnap = jsvc.published(v)
        ta, tsnap = tsvc.published(v)
        np.testing.assert_array_equal(tsnap.gather_x(slice(None)),
                                      jsnap.gather_x(slice(None)))
        assert (tsnap.high_water, tsnap.n) == (jsnap.high_water, jsnap.n)
        _close_biting(ta, ja, f"version {v} ({entry['kind']})")
    assert held >= 3


def test_publish_log_and_alphas_match_jax():
    key = jax.random.PRNGKey(0)
    kw = dict(rebuild_drift=0.3, max_epochs=8, record_models=True,
              ingest_hook=_feed)
    jsvc = _run(JOnlineService(JCFG, _ring(JRingSource), key=key,
                               engine_cfg=JEngineConfig(**ENGINE), **kw))
    tsvc = _run(OnlineService(CFG, _ring(), plan_fn=jax_plan_fn(key),
                              engine_cfg=EngineConfig(**ENGINE),
                              device="cpu", **kw))
    assert tsvc.rebuilds == jsvc.rebuilds >= 1
    assert {r["kind"] for r in tsvc.publish_log} == {"swap", "rebuild"}
    assert tsvc.source.total > CAP                 # the ring wrapped
    _hold_published(tsvc, jsvc)
    assert (tsvc.epoch, tsvc.version) == (jsvc.epoch, jsvc.version)
    ts, js = tsvc.stats(), jsvc.stats()
    for k in ("epoch", "version", "publishes", "rebuilds", "stream_total",
              "snapshot_hw", "staleness_mean", "staleness_max"):
        assert ts[k] == js[k], k


def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path):
    """Both services continue from the same JAX checkpoint after epoch 3:
    JAX's resumes it, the port's resumes its conversion."""
    key = jax.random.PRNGKey(1)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(rebuild_drift=0.3, ingest_hook=_feed)

    def jring():
        ring = _ring(JRingSource)
        for e in range(3):                         # the replayed stream
            _feed(ring, e)
        return ring

    _run(JOnlineService(JCFG, _ring(JRingSource), key=key, max_epochs=3,
                        checkpoint_dir=jdir,
                        engine_cfg=JEngineConfig(**ENGINE), **kw))
    _, flat, extra = convert.read_jax_checkpoint(jdir)
    tflat, textra = convert.online_state_from_jax(flat, extra)
    assert textra["epoch"] == 3 and tflat["gen_state"].size == 0
    CheckpointManager(tdir).save(3, tflat, extra=textra)

    jsvc = _run(JOnlineService(JCFG, jring(), key=key, max_epochs=6,
                               checkpoint_dir=jdir, resume=True,
                               record_models=True,
                               engine_cfg=JEngineConfig(**ENGINE), **kw))
    tring = _ring()
    for e in range(3):
        _feed(tring, e)
    tsvc = OnlineService(CFG, tring, plan_fn=jax_plan_fn(key), max_epochs=6,
                         checkpoint_dir=tdir, resume=True,
                         record_models=True, device="cpu",
                         engine_cfg=EngineConfig(**ENGINE), **kw)
    assert (tsvc.epoch, tsvc.version) == (3, extra["version"])
    np.testing.assert_array_equal(tsvc._state.alpha.numpy(), flat["alpha"])
    _run(tsvc)
    _hold_published(tsvc, jsvc, after=extra["version"])


@pytest.mark.parametrize("cache_blocks", [0, 4])
def test_soak_concurrent_serve_train(cache_blocks):
    ring = _ring()
    svc = OnlineService(
        CFG, ring, generator=torch.Generator().manual_seed(0),
        engine_cfg=EngineConfig(**ENGINE, cache_blocks=cache_blocks),
        rebuild_drift=0.3, max_epochs=8, record_models=True,
        ingest_hook=_feed, device="cpu")
    svc.start()
    sent, responses = {}, []
    lock = threading.Lock()

    def writer(wid):
        rng = np.random.default_rng(wid)
        it = 0
        while svc.running or it < 25:
            batch = rng.standard_normal(
                (int(rng.integers(1, 9)), D)).astype(np.float32)
            t = svc.submit(batch)
            with lock:
                sent[t] = batch
            out = svc.flush()
            with lock:
                responses.extend(out)
            it += 1

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    svc.join(timeout=300)
    assert svc.error is None, svc.error
    responses.extend(svc.flush())

    tickets = [r.ticket for r in responses]
    assert len(tickets) == len(set(tickets)), "a ticket was served twice"
    assert set(tickets) == set(sent), "tickets dropped or invented"
    assert svc.epoch == 8 and svc.rebuilds >= 1
    oracles = {}
    for r in responses:
        if r.version not in oracles:
            alpha, snap = svc.published(r.version)
            oracles[r.version] = DSEKLPredictionEngine(
                CFG, alpha, snap.gather_x(slice(None)),
                engine_cfg=svc.engine_cfg, alpha_version=r.version,
                device="cpu")
        assert torch.equal(r.f, oracles[r.version].predict(sent[r.ticket])), \
            f"ticket {r.ticket} differs from version {r.version}'s oracle"
    assert len(oracles) > 1, "the soak never saw a model swap"
    assert len(svc.epoch_seconds) == svc.epoch == sum(
        e["kind"] == "swap" for e in svc.publish_log)


def test_resumed_equals_uninterrupted(tmp_path):
    kw = dict(rebuild_drift=0.3, ingest_hook=_feed, device="cpu",
              engine_cfg=EngineConfig(**ENGINE))
    full = _run(OnlineService(CFG, _ring(),
                              generator=torch.Generator().manual_seed(4),
                              max_epochs=6,
                              checkpoint_dir=str(tmp_path / "full"), **kw))
    d = str(tmp_path / "cut")
    _run(OnlineService(CFG, _ring(), generator=torch.Generator().manual_seed(4),
                       max_epochs=3, checkpoint_dir=d, **kw))
    ring = _ring()
    for e in range(3):
        _feed(ring, e)
    res = _run(OnlineService(CFG, ring,
                             generator=torch.Generator().manual_seed(99),
                             max_epochs=6, checkpoint_dir=d, resume=True,
                             **kw))
    assert res.publish_log == full.publish_log      # alpha_crc included
    assert full.rebuilds >= 1
    for name in ("alpha", "accum", "step", "epoch"):
        assert torch.equal(getattr(res._state, name),
                           getattr(full._state, name)), name
    _, a, ea = CheckpointManager(str(tmp_path / "full")).restore()
    _, b, eb = CheckpointManager(d).restore()
    assert ea == eb
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshots_quotas_and_refusals():
    ring = _ring()
    svc = OnlineService(
        CFG, ring, generator=torch.Generator().manual_seed(2),
        engine_cfg=EngineConfig(**ENGINE, cache_blocks=4),
        rebuild_drift=0.1, max_epochs=3, ingest_hook=_feed, device="cpu")
    svc.set_cache_quota("q", 2)
    svc.submit(np.ones((3, D), np.float32))
    (r,) = svc.flush()
    assert r.ticket == 0 and r.version == 0 and r.f.shape == (3,)
    s = svc.stats()
    s["engine"]["cache"]["hits"] = -999
    s["epoch"] = -999
    c = svc.cache_info()
    c["owners"]["q"]["quota"] = -999
    assert svc.stats()["epoch"] == 0
    assert svc.cache_info()["owners"]["q"]["quota"] == 2
    _run(svc)
    assert svc.rebuilds >= 1
    assert svc.cache_info()["owners"]["q"]["quota"] == 2
    with pytest.raises(ValueError, match="query batch must be"):
        svc.submit(np.ones((2, D + 1), np.float32))
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
    with pytest.raises(TypeError, match="torch.Generator"):
        OnlineService(CFG, ring, device="cpu")
    with pytest.raises(ValueError, match="ring is empty"):
        OnlineService(CFG, RingSource(8, D),
                      generator=torch.Generator(), device="cpu")


def test_rebuild_warms_past_the_cache():
    """A rebuilt engine is warmed off the serving path without a tile: its
    cache is empty and its counters untouched at the flip."""
    svc = _run(OnlineService(
        CFG, _ring(), generator=torch.Generator().manual_seed(3),
        engine_cfg=EngineConfig(**ENGINE, cache_blocks=4),
        rebuild_drift=0.1, max_epochs=3, ingest_hook=_feed, device="cpu"))
    assert svc.rebuilds >= 1
    c = svc.cache_info()
    assert (c["size"], c["hits"], c["misses"], c["owners"]) == (0, 0, 0, {})


def test_service_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineService(CFG, _ring(), generator=torch.Generator())
