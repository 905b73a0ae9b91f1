"""The port's multi-tenant front door (``serving/tenancy.py``) against the
JAX package's, and its own contracts, on the CPU.

* Parity: the same submit sequence (three tenants of weights 2, 1, 1, one
  capped at 4 tickets with cache quota 0, one capped in queued rows; a
  model swap half way; pumps interleaved with submits; the engine's
  ``max_queue`` small enough that auto-flushes fire inside drains) through
  JAX's front door over a JAX engine and the port's over a port engine:
  the same drain order (tenant, ticket, version) in every pump, the same
  ``ShedResponse``s, the same ``stats()`` counters and per-owner cache
  counters, and scores within the float32 tolerance (rtol 2e-4, atol 1e-5
  x max(1, |oracle|_inf)), with QoS on and off.
* Weighted drains: two backlogged tenants of weights 2 and 1 drain rows
  2 : 1; QoS off serves a burst before a victim behind it, QoS on within
  one rotation.
* Concurrent writers against a pumper: every admitted ticket served once,
  sheds attributed to the capped tenant.
* Over a live ``OnlineService``: every tenant response bit-identical to a
  fresh engine built on its version's recorded model.
* The refusals in JAX's words.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dsekl import DSEKLConfig as JConfig
from repro.serving import DSEKLPredictionEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import QoSConfig as JQoS
from repro.serving import ShedResponse as JShed
from repro.serving import TenantConfig as JTenant
from repro.serving import TenantFrontDoor as JFrontDoor
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.data import RingSource
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 OnlineService, QoSConfig, ShedResponse,
                                 TenantConfig, TenantFrontDoor)

D, N_TRAIN = 5, 64
PARAMS = (("gamma", 0.7),)
EC = dict(query_block=16, sv_block=32, truncate_tol=-1.0, cache_blocks=8,
          max_queue=3)
TENANTS = {"gold": dict(weight=2.0), "standard": dict(),
           "batch": dict(max_tickets=4, cache_quota=0),
           "rows": dict(max_queued_rows=40, cache_quota=2)}


def _model(seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N_TRAIN, D)).astype(np.float32)
    a = (r.standard_normal(N_TRAIN) / N_TRAIN).astype(np.float32)
    return x, a


def _doors(qos_on):
    x, a = _model()
    t_eng = DSEKLPredictionEngine(
        DSEKLConfig(kernel_params=PARAMS, impl="ref"), a, x,
        engine_cfg=EngineConfig(**EC), device="cpu")
    j_eng = JEngine(JConfig(kernel_params=PARAMS, impl="ref"),
                    jnp.asarray(a), jnp.asarray(x),
                    engine_cfg=JEngineConfig(**EC))
    t = TenantFrontDoor(t_eng, {n: TenantConfig(**c)
                                for n, c in TENANTS.items()},
                        qos=QoSConfig(enabled=qos_on))
    j = JFrontDoor(j_eng, {n: JTenant(**c) for n, c in TENANTS.items()},
                   qos=JQoS(enabled=qos_on))
    return (t, t_eng), (j, j_eng), a


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


def _shed_fields(r):
    return (r.tenant, r.reason, r.occupancy, r.budget, r.rows)


@pytest.mark.parametrize("qos_on", [True, False], ids=["qos-on", "qos-off"])
def test_drain_order_sheds_and_counters_match_jax(qos_on):
    (t, t_eng), (j, j_eng), a = _doors(qos_on)
    rng = np.random.default_rng(1)
    names = list(TENANTS)
    pumps = sheds = 0
    for rnd in range(24):
        if rnd == 12:                                # a model swap
            t_eng.update_alpha(a * 2.0, version=1)
            j_eng.update_alpha(jnp.asarray(a * 2.0), version=1)
        for _ in range(int(rng.integers(2, 9))):
            name = names[int(rng.integers(0, len(names)))]
            if rnd % 6 == 5:
                name = "batch"                       # its burst
            b = rng.standard_normal((int(rng.integers(1, 21)), D)) \
                .astype(np.float32)
            got, want = t.submit(name, b), j.submit(name, b)
            if isinstance(want, JShed):
                assert isinstance(got, ShedResponse)
                assert _shed_fields(got) == _shed_fields(want)
                sheds += 1
            else:
                assert got == want
        for _ in range(int(rng.integers(0, 3))):
            tr, jr = t.pump(), j.pump()
            assert [(r.tenant, r.ticket, r.version) for r in tr] == \
                [(r.tenant, r.ticket, r.version) for r in jr]
            for x, y in zip(tr, jr):
                _close(x.f, y.f)
            pumps += bool(jr)
    tr, jr = t.flush(), j.flush()
    assert [(r.tenant, r.ticket, r.version) for r in tr] == \
        [(r.tenant, r.ticket, r.version) for r in jr]
    for x, y in zip(tr, jr):
        _close(x.f, y.f)
    assert pumps > 10 and (sheds > 0) == qos_on
    ts, js = t.stats(), j.stats()
    assert ts["tenants"] == js["tenants"]
    assert ts["qos"] == js["qos"] and ts["pumps"] == js["pumps"]
    tb, jb = ts["backend"], js["backend"]
    for k in ("serve_calls", "async_flushes", "alpha_version", "n_sv_padded"):
        assert tb[k] == jb[k], k
    tc, jc = t.cache_info(), j.cache_info()
    assert tc["owners"] == jc["owners"]
    for k in ("size", "hits", "misses", "evictions"):
        assert tc[k] == jc[k], k


def test_weighted_drain_and_fifo_against_a_burst():
    x, a = _model()
    rng = np.random.default_rng(2)

    def door(qos_on, tenants):
        eng = DSEKLPredictionEngine(
            DSEKLConfig(kernel_params=PARAMS, impl="ref"), a, x,
            engine_cfg=EngineConfig(**EC), device="cpu")
        return TenantFrontDoor(eng, tenants, qos=QoSConfig(enabled=qos_on))

    fd = door(True, {"light": TenantConfig(), "heavy": TenantConfig(2.0)})
    for _ in range(12):
        fd.submit("light", rng.standard_normal((16, D)).astype(np.float32))
        fd.submit("heavy", rng.standard_normal((16, D)).astype(np.float32))
    served = {"light": 0, "heavy": 0}
    for _ in range(6):                               # 3 full rotations
        for r in fd.pump():
            served[r.tenant] += r.f.shape[0]
    assert served["heavy"] == 2 * served["light"] > 0
    fd.flush()
    assert fd.pending == 0

    burst = [rng.standard_normal((16, D)).astype(np.float32)
             for _ in range(10)]
    waits = {}
    for qos_on in (True, False):
        fd = door(qos_on, {"victim": TenantConfig(),
                           "aggressor": TenantConfig()})
        for b in burst:
            fd.submit("aggressor", b)
        fd.submit("victim", burst[0][:4])
        n = 0
        while True:
            got = fd.pump()
            assert got
            n += 1
            if any(r.tenant == "victim" for r in got):
                break
        waits[qos_on] = n
    assert waits[True] <= 2 and waits[False] == 11


def test_concurrent_writers_exactly_once():
    x, a = _model()
    eng = DSEKLPredictionEngine(
        DSEKLConfig(kernel_params=PARAMS, impl="ref"), a, x,
        engine_cfg=EngineConfig(**EC), device="cpu")
    fd = TenantFrontDoor(eng, {"open": TenantConfig(max_tickets=10_000),
                               "bounded": TenantConfig(max_tickets=2)})
    admitted, sheds, lock = {}, [], threading.Lock()

    def writer(tenant, wid):
        rng = np.random.default_rng((wid, 99))
        for _ in range(40):
            b = rng.standard_normal((int(rng.integers(1, 9)), D)) \
                .astype(np.float32)
            r = fd.submit(tenant, b)
            with lock:
                if isinstance(r, ShedResponse):
                    sheds.append(r)
                else:
                    admitted[r] = tenant

    responses, stop = [], threading.Event()

    def pumper():
        while not stop.is_set() or fd.pending:
            responses.extend(fd.pump())

    pt = threading.Thread(target=pumper)
    pt.start()
    threads = [threading.Thread(target=writer, args=(t, i)) for i, t in
               enumerate(["open", "open", "bounded", "bounded"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    stop.set()
    pt.join(timeout=120)
    responses.extend(fd.flush())
    tickets = [r.ticket for r in responses]
    assert len(tickets) == len(set(tickets)) and set(tickets) == set(admitted)
    assert all(r.tenant == admitted[r.ticket] for r in responses)
    assert all(s.tenant == "bounded" for s in sheds)
    assert fd.stats()["tenants"]["bounded"]["shed"]["tickets"] == len(sheds)


def test_over_an_online_service_bit_identical_per_version():
    ring = RingSource(384, D)
    r0 = np.random.default_rng(7)
    ring.append(r0.standard_normal((192, D)).astype(np.float32),
                np.sign(r0.standard_normal(192)).astype(np.float32))

    def feed(svc, epoch):
        r = np.random.default_rng((8, epoch))
        svc.append(r.standard_normal((64, D)).astype(np.float32),
                   np.sign(r.standard_normal(64)).astype(np.float32))

    cfg = DSEKLConfig(n_grad=32, n_expand=32, lam=1e-4)
    svc = OnlineService(
        cfg, ring, generator=torch.Generator().manual_seed(0),
        engine_cfg=EngineConfig(query_block=32, sv_block=64, cache_blocks=4),
        rebuild_drift=0.3, max_epochs=6, record_models=True,
        ingest_hook=feed, device="cpu")
    fd = TenantFrontDoor(svc, {"a": TenantConfig(),
                               "b": TenantConfig(cache_quota=0)})
    rng = np.random.default_rng(9)
    sent, responses = {}, []
    svc.start()
    rounds = 0
    while svc.running or rounds < 10:
        for t in ("a", "b"):
            b = rng.standard_normal((int(rng.integers(1, 9)), D)) \
                .astype(np.float32)
            sent[fd.submit(t, b)] = (t, b)
        responses.extend(fd.flush())
        rounds += 1
    svc.join(timeout=300)
    assert svc.error is None, svc.error
    assert svc.rebuilds >= 1
    assert svc.cache_info()["owners"]["b"]["quota"] == 0
    tickets = [r.ticket for r in responses]
    assert len(tickets) == len(set(tickets)) and set(tickets) == set(sent)
    oracles = {}
    for r in responses:
        tenant, b = sent[r.ticket]
        key = (r.version, tenant)
        if key not in oracles:
            alpha, snap = svc.published(r.version)
            ec = svc.engine_cfg
            if tenant == "b":                        # the streaming path
                ec = EngineConfig(query_block=32, sv_block=64,
                                  truncate_tol=-1.0)
            oracles[key] = DSEKLPredictionEngine(
                cfg, alpha, snap.gather_x(slice(None)), engine_cfg=ec,
                alpha_version=r.version, device="cpu")
        assert torch.equal(r.f, oracles[key].predict(b)), r.ticket


def test_refusals_in_jax_words():
    (t, t_eng), (j, j_eng), _ = _doors(True)
    cases = [
        (lambda m: m.submit("nobody", np.zeros((2, D), np.float32)), None),
        (lambda m: m.submit("gold", np.zeros((2, D + 1), np.float32)), None),
    ]
    for call, _ in cases:
        with pytest.raises(Exception) as want:
            call(j)
        with pytest.raises(type(want.value)) as got:
            call(t)
        assert str(got.value) == str(want.value)
    for bad, jbad in [
        ((t_eng, {}), (j_eng, {})),
        ((t_eng, {"t": TenantConfig(weight=0.0)}),
         (j_eng, {"t": JTenant(weight=0.0)})),
        ((t_eng, {"t": TenantConfig(max_tickets=0)}),
         (j_eng, {"t": JTenant(max_tickets=0)})),
        ((object(), {"t": TenantConfig()}), (object(), {"t": JTenant()})),
        ((j_eng, {"t": TenantConfig()}), (t_eng, {"t": JTenant()})),
    ]:
        with pytest.raises(Exception) as want:
            JFrontDoor(*jbad)
        with pytest.raises(type(want.value)) as got:
            TenantFrontDoor(*bad)
        assert str(got.value).replace("repro_torch", "repro") == \
            str(want.value).replace("repro_torch", "repro")
