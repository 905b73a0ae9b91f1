"""Port prediction engine vs the JAX ``DSEKLPredictionEngine``, both on the
plain path (``impl="ref"``), built from the same numpy model.

Mirrors tests/test_prediction_engine.py and tests/test_engine_async_cache.py:
predictions of ``predict`` / ``flush`` / ``flush_async`` and the tagged
variants agree at the float32 tolerance (rtol 2e-4, atol 1e-5 x
max(1, |oracle|_inf)); tickets, alpha versions, serve calls, the geometry
and the cache's hit/miss/eviction and per-owner counters are equal
exactly.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dsekl import DSEKLConfig as JConfig
from repro.core.dsekl import init_state as jinit_state
from repro.core.solver import FitResult
from repro.serving import DSEKLPredictionEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.core import kernels_fn
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 engine_from_fit)

KERNEL_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 1.0), ("degree", 2))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
IDS = [k for k, _ in KERNEL_CASES]
N_TRAIN, N_QUERY, D = 147, 53, 6
QUERY_BLOCK, SV_BLOCK = 16, 32


def _model(seed=0, n=N_TRAIN, d=D, q=N_QUERY):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    alpha = rng.standard_normal(n).astype(np.float32)
    alpha *= rng.uniform(size=n) > 0.4                 # sparse support
    xq = rng.standard_normal((q, d)).astype(np.float32)
    return x, alpha, xq


def _pair(kernel="rbf", params=(("gamma", 0.7),), seed=0, **ec_kw):
    """(port engine, JAX engine, model) on the same inputs."""
    x, alpha, xq = _model(seed)
    kw = dict(query_block=QUERY_BLOCK, sv_block=SV_BLOCK)
    kw.update(ec_kw)
    t = DSEKLPredictionEngine(
        DSEKLConfig(kernel=kernel, kernel_params=params, impl="ref"),
        alpha, x, engine_cfg=EngineConfig(**kw), device="cpu")
    j = JEngine(JConfig(kernel=kernel, kernel_params=params, impl="ref"),
                jnp.asarray(alpha), jnp.asarray(x),
                engine_cfg=JEngineConfig(**kw))
    return t, j, (x, alpha, xq)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


def _same_counters(t, j):
    assert t.stats() == j.stats()


@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_predict_matches_jax_engine(kernel, params):
    t, j, (x, alpha, xq) = _pair(kernel, params)
    f_t = t.predict(xq)
    assert f_t.dtype == torch.float32 and f_t.device.type == "cpu"
    _close(f_t, j.predict(jnp.asarray(xq)))
    dense = kernels_fn.get_kernel(kernel, **dict(params))(
        torch.from_numpy(xq), torch.from_numpy(x)) @ torch.from_numpy(alpha)
    _close(f_t, dense)
    _same_counters(t, j)


def test_truncate_pad_geometry_matches_jax():
    t, j, (x, alpha, _) = _pair(seed=3)
    st = t.stats()
    assert st["n_sv"] == int((np.abs(alpha) > 1e-8).sum())
    assert st["n_sv_padded"] % t.sv_block == 0
    _same_counters(t, j)
    keep = DSEKLPredictionEngine(DSEKLConfig(impl="ref"), alpha, x,
                                 engine_cfg=EngineConfig(truncate_tol=-1.0),
                                 device="cpu")
    assert keep.n_sv == N_TRAIN


def test_all_zero_alpha_serves_zeros():
    x, alpha, xq = _model(seed=4)
    t = DSEKLPredictionEngine(DSEKLConfig(impl="ref"), np.zeros_like(alpha),
                              x, device="cpu")
    j = JEngine(JConfig(impl="ref"), jnp.zeros(N_TRAIN), jnp.asarray(x))
    assert t.n_sv == 0
    _same_counters(t, j)
    np.testing.assert_array_equal(t.predict(xq).numpy(), 0.0)
    j.predict(jnp.asarray(xq))
    _same_counters(t, j)


def test_micro_batch_front_door_matches_jax():
    """Tickets, auto-flush at max_queue, order and zero-row batches, with
    ``engine_from_fit`` taking a JAX FitResult."""
    x, alpha, xq = _model(seed=5)
    params = (("length_scale", 1.1),)
    res = FitResult(state=jinit_state(N_TRAIN)._replace(
        alpha=jnp.asarray(alpha)), history=[], converged=True, epochs_run=1)
    ec = dict(query_block=QUERY_BLOCK, sv_block=SV_BLOCK, max_queue=4)
    t = engine_from_fit(DSEKLConfig(kernel="matern32", kernel_params=params,
                                    impl="ref"), res, x,
                        engine_cfg=EngineConfig(**ec), device="cpu")
    j = JEngine(JConfig(kernel="matern32", kernel_params=params, impl="ref"),
                res.state.alpha, jnp.asarray(x),
                engine_cfg=JEngineConfig(**ec))
    sizes = [7, 19, 1, 26]
    batches, start = [], 0
    for s in sizes:
        batches.append(xq[start:start + s])
        start += s
    for eng, conv in ((t, lambda b: b), (j, jnp.asarray)):
        assert [eng.submit(conv(b)) for b in batches] == [0, 1, 2, 3]
        assert eng.queued == 4
        assert eng.submit(conv(xq[:2])) == 4       # auto-flushes the four
        assert eng.queued == 1
    outs_t, outs_j = t.flush(), j.flush()
    assert t.queued == 0 and t.flush() == []
    assert [int(o.shape[0]) for o in outs_t] == sizes + [2]
    for o_t, o_j in zip(outs_t, outs_j):
        _close(o_t, o_j)
    direct = t.predict(np.concatenate(batches + [xq[:2]]))
    np.testing.assert_allclose(torch.cat(outs_t).numpy(), direct.numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t.submit(np.zeros((3, D + 1), np.float32))
    assert t.predict(xq[:0]).shape == (0,)
    t.submit(xq[:0])
    t.submit(xq[:4])
    empty, four = t.flush()
    assert empty.shape == (0,) and four.shape == (4,)


def test_submit_copies_the_batch():
    """The queue holds a copy: a caller reusing its buffer after submit
    does not change what is served."""
    t, _, (_, _, xq) = _pair(seed=5)
    buf = xq[:8].copy()
    t.submit(buf)
    buf[:] = 0.0
    (f,) = t.flush()
    np.testing.assert_array_equal(f.numpy(), t.predict(xq[:8]).numpy())


@pytest.mark.parametrize("cache_blocks", [0, 8])
def test_flush_async_matches_flush_and_jax(cache_blocks):
    sizes = [7, 19, 1, 26]
    t_s, j_a, (_, _, xq) = _pair(cache_blocks=cache_blocks)
    t_a, _, _ = _pair(cache_blocks=cache_blocks)
    start = 0
    for s in sizes:
        for eng, b in ((t_s, xq[start:start + s]), (t_a, xq[start:start + s]),
                       (j_a, jnp.asarray(xq[start:start + s]))):
            eng.submit(b)
        start += s
    outs_s, outs_a, outs_j = t_s.flush(), t_a.flush_async(), j_a.flush_async()
    assert [o.shape for o in outs_a] == [o.shape for o in outs_s]
    for o_s, o_a, o_j in zip(outs_s, outs_a, outs_j):
        np.testing.assert_allclose(o_a.numpy(), o_s.numpy(), rtol=1e-6,
                                   atol=1e-6)
        _close(o_a, o_j)
    assert t_a.async_flushes == 1
    _same_counters(t_a, j_a)


def test_interleaved_submit_flush_orderings_match_jax():
    t, j, (_, _, xq) = _pair("matern32", (("length_scale", 1.1),), seed=2,
                             max_queue=2)
    chunks = [xq[0:5], xq[5:9], xq[9:30], xq[30:31], xq[31:49], xq[49:53]]
    got = {}
    for name, eng, conv in (("t", t, lambda b: b), ("j", j, jnp.asarray)):
        out = []
        assert eng.submit(conv(chunks[0])) == 0
        out.extend(eng.flush_async())
        assert eng.submit(conv(chunks[1])) == 0
        assert eng.submit(conv(chunks[2])) == 1
        assert eng.submit(conv(chunks[3])) == 2    # auto-flushes 1-2
        assert eng.queued == 1
        out.extend(eng.flush())
        assert eng.flush() == [] and eng.flush_async() == []
        assert eng.submit(conv(chunks[4])) == 0
        assert eng.submit(conv(chunks[5])) == 1
        out.extend(eng.flush_async())
        got[name] = out
    assert [int(o.shape[0]) for o in got["t"]] == [c.shape[0] for c in chunks]
    for o_t, o_j in zip(got["t"], got["j"]):
        _close(o_t, o_j)
    _same_counters(t, j)


def test_async_zero_row_and_empty_queue():
    t, _, (_, _, xq) = _pair(seed=3)
    assert t.flush_async() == []
    t.submit(xq[:0])
    t.submit(xq[:4])
    empty, four = t.flush_async()
    assert empty.shape == (0,) and four.shape == (4,)
    t.submit(xq[:0])
    (only_empty,) = t.flush_async()
    assert only_empty.shape == (0,)


# ---------------------------------------------------------------------------
# Kernel-map tile cache.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_cached_predictions_bit_identical(kernel, params):
    t, j, (_, _, xq) = _pair(kernel, params, seed=4, cache_blocks=8)
    fresh = t.predict(xq).numpy()
    j.predict(jnp.asarray(xq))
    assert t.cache_info() == j.cache_info()
    assert t.cache_info()["misses"] == -(-N_QUERY // QUERY_BLOCK)
    hit = t.predict(xq).numpy()
    j.predict(jnp.asarray(xq))
    assert (fresh == hit).all(), f"cache hit not bit-identical ({kernel})"
    assert t.serve_calls == t.cache_info()["misses"]
    t.submit(xq)
    j.submit(jnp.asarray(xq))
    (via_async,) = t.flush_async()
    j.flush_async()
    assert (fresh == via_async.numpy()).all()
    _same_counters(t, j)
    plain, _, _ = _pair(kernel, params, seed=4)
    _close(fresh, plain.predict(xq))


def test_cache_lru_eviction_and_counters_match_jax():
    t, j, (_, _, xq) = _pair(seed=5, cache_blocks=2)
    tiles = [xq[i * QUERY_BLOCK:(i + 1) * QUERY_BLOCK] for i in range(3)]
    tiles.append(np.random.default_rng(9).standard_normal(
        (QUERY_BLOCK, D)).astype(np.float32))
    for k in [0, 1, 2, 3, 3, 0, 3]:
        t.predict(tiles[k])
        j.predict(jnp.asarray(tiles[k]))
        assert t.cache_info() == j.cache_info()
    info = t.cache_info()
    assert (info["misses"], info["hits"], info["evictions"],
            info["size"]) == (5, 2, 3, 2)
    t.cache_clear()
    j.cache_clear()
    assert t.cache_info() == j.cache_info()
    assert t.cache_info()["size"] == 0 and t.cache_info()["capacity"] == 2


def test_cache_owner_quotas_match_jax():
    """Per-owner hit/miss/eviction/bypass/resident counters and quotas
    equal the JAX engine's exactly under the same traffic."""
    t, j, (_, _, xq) = _pair(seed=6, cache_blocks=3)
    rng = np.random.default_rng(10)
    tiles = [rng.standard_normal((QUERY_BLOCK, D)).astype(np.float32)
             for _ in range(6)]
    script = [("gold", 0), ("gold", 1), ("batch", 2), ("batch", 3),
              ("batch", 4), ("gold", 0), ("bulk", 5), ("bulk", 5),
              (None, 1), ("gold", 2), ("batch", 2)]
    for eng in (t, j):
        eng.set_cache_quota("batch", 1)
        eng.set_cache_quota("bulk", 0)
    for owner, k in script:
        for eng, conv in ((t, lambda a: a), (j, jnp.asarray)):
            eng.set_cache_owner(owner)
            eng.predict(conv(tiles[k]))
        assert t.cache_info() == j.cache_info(), (owner, k)
    owners = t.cache_info()["owners"]
    assert owners["bulk"]["bypasses"] == 2 and owners["bulk"]["resident"] == 0
    assert owners["batch"]["resident"] <= 1
    for eng in (t, j):
        eng.set_cache_quota("batch", None)
    assert t.cache_info() == j.cache_info()
    _same_counters(t, j)


# ---------------------------------------------------------------------------
# update_alpha and version tags.
# ---------------------------------------------------------------------------

def test_cache_survives_update_alpha():
    t, j, (x, alpha, xq) = _pair(params=(("gamma", 0.9),), seed=6,
                                 cache_blocks=8, truncate_tol=-1.0)
    assert t.n_sv == N_TRAIN
    t.predict(xq)
    misses = t.cache_info()["misses"]
    alpha2 = alpha * 2.0 + 0.1
    t.update_alpha(alpha2)
    j.update_alpha(jnp.asarray(alpha2))
    f2 = t.predict(xq)
    assert t.cache_info()["misses"] == misses
    assert t.alpha_version == j.alpha_version == 1
    dense2 = kernels_fn.get_kernel("rbf", gamma=0.9)(
        torch.from_numpy(xq), torch.from_numpy(x)) @ torch.from_numpy(alpha2)
    _close(f2, dense2)
    _close(f2, j.predict(jnp.asarray(xq)))


def test_update_alpha_requires_keep_all():
    t, _, (x, alpha, _) = _pair(seed=7)
    assert t.n_sv < N_TRAIN
    with pytest.raises(ValueError):
        t.update_alpha(alpha)
    keep, _, _ = _pair(seed=7, truncate_tol=-1.0)
    with pytest.raises(ValueError):
        keep.update_alpha(alpha[:-1])


def test_tagged_versions_match_jax():
    """Auto-flushed batches keep the version of the sweep that served them;
    explicit versions stamp through."""
    t, j, (_, alpha, xq) = _pair(seed=8, truncate_tol=-1.0, max_queue=2)
    b = xq[:4]
    tags = {}
    for name, eng, conv in (("t", t, lambda a: a), ("j", j, jnp.asarray)):
        eng.submit(conv(b))
        eng.submit(conv(b))
        eng.submit(conv(b))                     # auto-flush at version 0
        eng.update_alpha(conv(alpha * 2.0))
        eng.submit(conv(b))
        pairs = eng.flush_async_tagged()
        eng.update_alpha(conv(alpha * 3.0), version=7)
        eng.submit(conv(b))
        pairs += eng.flush_tagged()
        tags[name] = [v for _, v in pairs]
        if name == "t":
            outs_t = [f for f, _ in pairs]
        else:
            outs_j = [f for f, _ in pairs]
    assert tags["t"] == tags["j"] == [0, 0, 1, 1, 7]
    for o_t, o_j in zip(outs_t, outs_j):
        _close(o_t, o_j)


def test_update_alpha_mid_sweep_is_not_torn():
    """A swap landing inside a flush completes that sweep on the captured
    alpha; the next sweep serves the new version."""
    t, _, (x, alpha, xq) = _pair(seed=9, truncate_tol=-1.0)
    a1 = alpha + 1.0
    ref0 = t.predict(xq[:40]).numpy()
    fired = []
    orig = t._serve

    def hooked(xq_tile, a_sv):
        if not fired:
            fired.append(1)
            t.update_alpha(a1)
        return orig(xq_tile, a_sv)

    t._serve = hooked
    t.submit(xq[:40])                            # three query tiles
    ((f, v),) = t.flush_async_tagged()
    assert fired and v == 0
    np.testing.assert_array_equal(f.numpy(), ref0)
    t.submit(xq[:40])
    ((f1, v1),) = t.flush_async_tagged()
    assert v1 == 1
    _close(f1, t.predict(xq[:40]))


def test_update_alpha_concurrent_stress():
    """A publisher thread swapping between two models while the serving
    thread flushes: every result equals one model's answer, matching the
    version tag it carries (bounded to a few seconds)."""
    t, _, (x, alpha, xq) = _pair(seed=11, truncate_tol=-1.0)
    alphas = [alpha, -alpha]
    t.update_alpha(alphas[0], version=0)
    want = []
    for a in alphas:
        t.update_alpha(a, version=len(want))
        want.append(t.predict(xq[:20]).numpy())
    t.update_alpha(alphas[0], version=0)
    stop = threading.Event()

    def publish():
        v = 0
        while not stop.is_set():
            v += 1
            t.update_alpha(alphas[v % 2], version=v)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=publish)
    th.start()
    try:
        for _ in range(40):
            t.submit(xq[:20])
            ((f, v),) = t.flush_async_tagged()
            np.testing.assert_array_equal(f.numpy(), want[v % 2])
    finally:
        stop.set()
        th.join(timeout=10)
        sys.setswitchinterval(old)
    assert not th.is_alive()


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, alpha, _ = _model()
    with pytest.raises(RuntimeError):
        DSEKLPredictionEngine(DSEKLConfig(impl="ref"), alpha, x)
