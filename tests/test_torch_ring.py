"""The port's appendable ring (``data/source.py::RingSource`` /
``RingSnapshot``) against the JAX package's, on the same appends:

* windows, snapshots (rows, labels, version, high-water mark, base),
  wraps and live gathers equal JAX's bit for bit, over a seeded sequence
  of appends that wraps the ring several times;
* every refusal (an append larger than the ring, a bad shape, a read past
  the window or past a snapshot, ``local`` / ``split`` on a live ring,
  a strided slice) raises JAX's exception type with JAX's text;
* the memmap backing writes the same file names and bytes as JAX's;
* ``solver.fit`` over a live ring equals ``fit`` over its snapshot, with
  appends made after the fit started unable to reach it.
"""
import os

import numpy as np
import pytest
import torch

from repro.data import source as jsource
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.core.solver import fit
from repro_torch.data import RingSnapshot, RingSource

D = 6
CAP = 384


def _events(rng, m, d=D):
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = np.where(rng.standard_normal(m) >= 0, 1.0, -1.0).astype(np.float32)
    return x, y


def _same_view(got, want):
    assert (got.n, got.d) == (want.n, want.d)
    gx, gy = got.gather(slice(None))
    wx, wy = want.gather(slice(None))
    assert gx.dtype == wx.dtype == np.float32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


def _same_snapshot(got, want):
    assert isinstance(got, RingSnapshot)
    assert (got.version, got.high_water, got.base) == \
        (want.version, want.high_water, want.base)
    _same_view(got, want)


def test_windows_snapshots_and_wraps_equal_jax():
    rng = np.random.default_rng(0)
    port, ref = RingSource(CAP, D), jsource.RingSource(CAP, D)
    snaps = []
    for step in range(40):
        m = int(rng.integers(1, CAP // 3))
        x, y = _events(rng, m)
        assert port.append(x, y) == ref.append(x, y)
        assert (port.total, port.n, port.capacity, port.nbytes) == \
            (ref.total, ref.n, ref.capacity, ref.nbytes)
        _same_view(port, ref)
        idx = rng.integers(0, port.n, 17)
        np.testing.assert_array_equal(port.gather_x(idx), ref.gather_x(idx))
        for sl in (slice(3, 40), slice(-25, None), slice(None, -7),
                   slice(500, None)):
            np.testing.assert_array_equal(port.gather(sl)[0],
                                          ref.gather(sl)[0])
        if step % 3 == 0:
            snaps.append((port.snapshot(), ref.snapshot()))
    assert port.total > 3 * CAP                       # wrapped several times
    for got, want in snaps:                           # frozen after all that
        _same_snapshot(got, want)
    # Staging buffers work through the ring's gathers as through JAX's.
    idx = np.arange(port.n - 9, port.n)
    out_x = np.zeros((16, D), np.float32)
    out_y = np.zeros((16,), np.float32)
    gx, gy = port.gather(idx, out_x, out_y)
    wx, wy = ref.gather(idx)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert np.shares_memory(gx, out_x)


def _raises_like(port_call, jax_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_refusals_equal_jax():
    rng = np.random.default_rng(1)
    port, ref = RingSource(8, 3), jsource.RingSource(8, 3)
    x, y = _events(rng, 5, 3)
    port.append(x, y)
    ref.append(x, y)
    ps, js = port.snapshot(), ref.snapshot()
    big = _events(rng, 9, 3)
    wide = _events(rng, 2, 4)
    cases = [
        (lambda r: r.append(*big),),
        (lambda r: r.append(*wide),),
        (lambda r: r.append(big[0][:2], big[1][:3]),),
        (lambda r: r.gather(np.array([5])),),
        (lambda r: r.gather(np.array([-1])),),
        (lambda r: r.gather(slice(0, 4, 2)),),
        (lambda r: r.local(0, 2),),
        (lambda r: r.split(2),),
    ]
    for (call,) in cases:
        _raises_like(lambda: call(port), lambda: call(ref))
    _raises_like(lambda: ps.gather(np.array([5])),
                 lambda: js.gather(np.array([5])))
    _raises_like(lambda: RingSource(0, 3), lambda: jsource.RingSource(0, 3))
    _raises_like(lambda: RingSource(4, 2, x=np.zeros((3, 2), np.float32)),
                 lambda: jsource.RingSource(
                     4, 2, x=np.zeros((3, 2), np.float32)))


def test_memmap_backing_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    pd, jd = tmp_path / "port", tmp_path / "jax"
    port = RingSource.memmap(str(pd), 64, D)
    ref = jsource.RingSource.memmap(str(jd), 64, D)
    for _ in range(5):
        x, y = _events(rng, 29)
        port.append(x, y)
        ref.append(x, y)
    assert isinstance(port._x, np.memmap)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    port._x.flush()
    port._y.flush()
    ref._x.flush()
    ref._y.flush()
    for name in os.listdir(jd):
        assert (pd / name).read_bytes() == (jd / name).read_bytes(), name
    ps, js = port.snapshot(), ref.snapshot()
    _same_snapshot(ps, js)
    assert not isinstance(ps.gather_x(slice(None)), np.memmap)


def test_fit_over_a_live_ring_equals_fit_over_its_snapshot():
    rng = np.random.default_rng(3)
    ring = RingSource(256, 4)
    ring.append(*_events(rng, 200, 4))
    frozen = ring.snapshot()
    cfg = DSEKLConfig(n_grad=32, n_expand=32, lam=1e-4)
    kw = dict(n_epochs=2, tol=0.0, device="cpu")

    def appending(epoch, state):
        ring.append(*_events(rng, 40, 4))         # mid-fit, wraps the ring

    live = fit(cfg, ring, None, torch.Generator().manual_seed(5),
               callback=appending, **kw)
    assert ring.total == 280
    res = fit(cfg, frozen, None, torch.Generator().manual_seed(5), **kw)
    for name in ("alpha", "accum", "step", "epoch"):
        assert torch.equal(getattr(live.state, name),
                           getattr(res.state, name)), name
    assert live.state.alpha.shape == (200,)
