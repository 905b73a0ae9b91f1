"""The port's host-resident data plane (``repro_torch/data/source.py``)
against the JAX package's (``tests/test_data_source.py``).

``HostSource`` gathers (arrays and memmaps, row-range views, rows owned
and never views of the mapping), the memmap datasets (byte for byte the
JAX package's files), the manifest and ``ManifestSource``,
``split_holdout``, and the ``BlockPrefetcher`` on the CPU: plan order
across ``extend``, owned blocks, errors surfacing in ``get()``, and a
``close()`` that ends the worker whether it failed or is mid-stream.
Every wait in these tests is bounded (the prefetcher's own ``timeout``,
``close``'s join timeout)."""
import json
import time

import numpy as np
import pytest
import torch

from repro.data import source as jsource
from repro_torch.data import source as tsource
from repro_torch.data.source import (BlockPrefetcher, HostSource,
                                     InMemorySource, ManifestSource,
                                     SyncGather, make_memmap_dataset,
                                     open_memmap_dataset, read_manifest,
                                     split_holdout)

@pytest.fixture
def xy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((97, 5)).astype(np.float32)
    y = np.sign(rng.standard_normal(97)).astype(np.float32)
    return x, y


def _loader(src, plan_i, plan_j, **kw):
    return BlockPrefetcher(src, plan_i, plan_j, device="cpu", timeout=30.0,
                           **kw)


# --- HostSource ------------------------------------------------------------

def test_gather_indices_slices_and_out_buffers(xy):
    x, y = xy
    src = HostSource(x, y)
    assert (src.n, src.d, src.nbytes) == (97, 5, 4 * 97 * 6)
    idx = np.array([3, 96, 3, 0])
    xr, yr = src.gather(idx)
    np.testing.assert_array_equal(xr, x[idx])
    np.testing.assert_array_equal(yr, y[idx])
    xs, ys = src.gather(slice(10, 20))
    np.testing.assert_array_equal(xs, x[10:20])
    np.testing.assert_array_equal(ys, y[10:20])
    out_x, out_y = np.zeros((6, 5), np.float32), np.zeros(6, np.float32)
    xr, yr = src.gather(idx, out_x=out_x, out_y=out_y)
    assert np.shares_memory(xr, out_x) and xr.shape == (4, 5)
    np.testing.assert_array_equal(out_x[:4], x[idx])
    np.testing.assert_array_equal(out_y[:4], y[idx])
    np.testing.assert_array_equal(src.gather_x(idx), x[idx])


def test_views_split_and_bounds(xy):
    x, y = xy
    src = HostSource(x, y)
    v = src.local(10, 20)
    np.testing.assert_array_equal(v.gather(np.array([0, 19]))[0],
                                  x[[10, 29]])
    np.testing.assert_array_equal(v.local(5, 5).gather(np.array([0]))[0],
                                  x[[15]])
    parts = HostSource(x[:96], y[:96]).split(4)
    assert [p.n for p in parts] == [24] * 4
    shard = parts[1]
    np.testing.assert_array_equal(shard.gather(slice(0, 100))[0], x[24:48])
    np.testing.assert_array_equal(shard.gather(slice(-4, None))[0],
                                  x[44:48])
    with pytest.raises(IndexError):
        shard.gather(np.array([0, 24]))
    with pytest.raises(IndexError):
        shard.gather_x(np.array([-1]))
    with pytest.raises(ValueError):
        src.split(7)
    with pytest.raises(ValueError):
        src.local(90, 20)


def test_gathers_own_their_rows(tmp_path, xy):
    """Slice and index gathers are copies: later writes to the backing
    store (a memmap included) do not reach them, nor do tensors made from
    them with ``torch.from_numpy``."""
    x, y = xy
    mm_x = np.memmap(tmp_path / "x.f32", np.float32, mode="w+",
                     shape=(64, 5))
    mm_y = np.memmap(tmp_path / "y.f32", np.float32, mode="w+", shape=(64,))
    mm_x[:], mm_y[:] = x[:64], y[:64]
    for src in (HostSource(x.copy(), y.copy()), HostSource(mm_x, mm_y)):
        for idx in (slice(0, 4), np.arange(4)):
            xr, yr = src.gather(idx)
            t = torch.from_numpy(src.gather_x(idx))
            before = xr.copy()
            assert not np.shares_memory(xr, src._x)
            src._x[0:4] = -123.0
            src._y[0:4] = -123.0
            np.testing.assert_array_equal(xr, before)
            np.testing.assert_array_equal(t.numpy(), before)
            assert not (yr == -123.0).any()
            src._x[0:4], src._y[0:4] = x[0:4], y[0:4]


def test_non_f32_backing_converts(xy):
    x, y = xy
    src = HostSource(x.astype(np.float64), y.astype(np.int32))
    xr, yr = src.gather(np.array([0, 1]))
    assert xr.dtype == np.float32 and yr.dtype == np.float32
    out = np.zeros((2, 5), np.float32)
    src.gather_x(np.array([0, 1]), out=out)
    np.testing.assert_array_equal(out, x[[0, 1]])


def test_inmemory_source_mirrors_lazily(xy):
    x, y = xy
    src = InMemorySource(torch.from_numpy(x), torch.from_numpy(y))
    assert (src.n, src.d) == (97, 5) and not src._host_ready
    xr, _ = src.gather(np.array([5, 6]))
    assert src._host_ready
    np.testing.assert_array_equal(xr, x[[5, 6]])


# --- memmap datasets, manifests, the hold-out ------------------------------

@pytest.mark.parametrize("n,d,granule", [(256, 8, 100), (1000, 54, 8192)])
def test_memmap_files_equal_jax_byte_for_byte(tmp_path, n, d, granule):
    jsource.make_memmap_dataset(str(tmp_path / "jax"), n, d, seed=3,
                                granule=granule)
    src = make_memmap_dataset(str(tmp_path / "port"), n, d, seed=3,
                              granule=granule)
    for name in (f"x_{n}x{d}.f32", f"y_{n}.f32", "manifest.json"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    assert (src.n, src.d) == (n, d)
    again = open_memmap_dataset(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.gather(slice(0, n))[0],
                                  src.gather(slice(0, n))[0])
    assert set(np.unique(src.gather(slice(0, n))[1])) <= {-1.0, 1.0}


def test_manifest_source_round_trip_maps_per_range(tmp_path):
    make_memmap_dataset(str(tmp_path), 200, 6, seed=5, granule=64)
    meta = read_manifest(str(tmp_path))
    assert (meta["n"], meta["d"], meta["dtype"]) == (200, 6, "float32")
    assert meta == jsource.read_manifest(str(tmp_path))
    full_x, full_y = open_memmap_dataset(str(tmp_path)).gather(slice(0, 200))
    root = ManifestSource(str(tmp_path))
    assert (root.n, root.d) == (200, 6)
    shards = root.split(4)
    assert not root.mapped and not any(s.mapped for s in shards)
    for k, s in enumerate(shards):
        xs, ys = s.gather(np.arange(50))
        assert s.mapped and not root.mapped
        assert s._x.offset == 4 * 50 * k * 6 and s._x.shape == (50, 6)
        np.testing.assert_array_equal(xs, full_x[50 * k:50 * (k + 1)])
        np.testing.assert_array_equal(ys, full_y[50 * k:50 * (k + 1)])
    v = root.local(30, 100).local(20, 10)
    assert (v.global_offset, v.n) == (50, 10)
    np.testing.assert_array_equal(v.gather_x(np.arange(10)), full_x[50:60])
    with pytest.raises(ValueError, match="outside"):
        root.local(150, 100)


def test_broken_manifests_are_refused(tmp_path):
    make_memmap_dataset(str(tmp_path), 64, 4, seed=1)
    path = tmp_path / "manifest.json"
    meta = json.loads(path.read_text())
    del meta["x_file"]
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="missing 'x_file'"):
        read_manifest(str(tmp_path))
    meta["x_file"] = "x_64x4.f32"
    meta["dtype"] = "float64"
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="dtype"):
        ManifestSource(str(tmp_path))


@pytest.mark.parametrize("n", [5, 97, 40000])
def test_split_holdout_matches_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    train, xv, yv = split_holdout(HostSource(x, y))
    jtrain, jxv, jyv = jsource.split_holdout(jsource.HostSource(x, y))
    assert train.n == jtrain.n == n - xv.shape[0]
    np.testing.assert_array_equal(xv, jxv)
    np.testing.assert_array_equal(yv, jyv)
    assert not np.shares_memory(xv, x)          # owned, off the mapping
    with pytest.raises(IndexError):
        train.gather(np.array([train.n]))


# --- the prefetcher on the CPU ----------------------------------------------

def test_prefetcher_delivers_plan_order_across_extend(xy):
    x, y = xy
    src = HostSource(x, y)
    rng = np.random.default_rng(1)
    segments = [(rng.integers(0, 97, (s, 16)), rng.integers(0, 97, (s, 3, 4)))
                for s in (7, 0, 5)]
    with _loader(src, *segments[0]) as loader:
        worker = loader._thread
        for seg in segments[1:]:
            loader.extend(*seg)
        for plan_i, plan_j in segments:
            for t in range(plan_i.shape[0]):
                xi, yi, xj = loader.get()
                assert isinstance(xi, torch.Tensor) and xi.device.type == "cpu"
                np.testing.assert_array_equal(xi.numpy(), x[plan_i[t]])
                np.testing.assert_array_equal(yi.numpy(), y[plan_i[t]])
                np.testing.assert_array_equal(xj.numpy(),
                                              x[plan_j[t].reshape(-1)])
        assert loader._thread is worker
        with pytest.raises(RuntimeError, match="planned steps"):
            loader.get()
        st = loader.stats()
    assert st["steps"] == 12 and st["gather_s"] > 0.0 and st["wait_s"] >= 0
    assert not worker.is_alive()
    with pytest.raises(ValueError, match="widths"):
        with _loader(src, *segments[0]) as bad:
            bad.extend(np.zeros((2, 9), np.int64), np.zeros((2, 12), np.int64))


def test_prefetched_blocks_stay_valid(xy):
    """Blocks handed out own their memory: later steps never overwrite
    them (``torch.from_numpy`` aliases its array)."""
    x, y = xy
    src = HostSource(x, y)
    plan_i = np.stack([np.arange(t, t + 8) for t in range(6)])
    plan_j = np.tile(np.arange(8), (6, 1))
    with _loader(src, plan_i, plan_j) as loader:
        held = [loader.get() for _ in range(6)]
    for t, (xi, _, _) in enumerate(held):
        np.testing.assert_array_equal(xi.numpy(), x[plan_i[t]])


def test_sync_gather_equals_prefetcher(xy):
    x, y = xy
    src = HostSource(x, y)
    rng = np.random.default_rng(2)
    plan_i, plan_j = rng.integers(0, 97, (5, 8)), rng.integers(0, 97, (5, 8))
    with SyncGather(src, plan_i, plan_j, device="cpu") as s, \
            _loader(src, plan_i, plan_j) as p:
        for _ in range(5):
            for u, v in zip(s.get(), p.get()):
                assert torch.equal(u, v)
        assert s.stats()["wait_s"] == s.stats()["gather_s"] > 0.0


def test_worker_errors_surface_in_get(xy):
    x, y = xy

    class Exploding(HostSource):
        def gather(self, idx, out_x=None, out_y=None):
            raise RuntimeError("backing store went away")

    plan = np.zeros((3, 4), np.int64)
    with _loader(Exploding(x, y), plan, plan) as loader:
        with pytest.raises(RuntimeError, match="backing store"):
            loader.get()
        with pytest.raises(RuntimeError, match="ended without"):
            loader.get()                        # the worker is gone


def test_close_unblocks_a_failed_worker(xy):
    """A worker that fails while the ready queue is full must not hang
    ``close()``: its error hand-off respects the stop flag."""
    x, y = xy

    class ExplodesLate(HostSource):
        calls = 0

        def gather(self, idx, out_x=None, out_y=None):
            ExplodesLate.calls += 1
            if ExplodesLate.calls > 2:          # after depth=2 steps staged
                raise RuntimeError("boom")
            return super().gather(idx, out_x=out_x, out_y=out_y)

    plan = np.zeros((10, 8), np.int64)
    loader = _loader(ExplodesLate(x, y), plan, plan)
    deadline = time.perf_counter() + 10.0
    while ExplodesLate.calls < 3 and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert ExplodesLate.calls >= 3
    t0 = time.perf_counter()
    loader.close()
    assert time.perf_counter() - t0 < 5.0
    assert not loader._thread.is_alive()


def test_close_mid_stream_ends_the_worker(xy):
    x, y = xy
    plan = np.zeros((1000, 8), np.int64)
    loader = _loader(HostSource(x, y), plan, plan)
    loader.get()
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        loader.get()


def test_get_times_out_when_the_worker_stalls(xy):
    x, y = xy
    release = []

    class Stalls(HostSource):
        def gather(self, idx, out_x=None, out_y=None):
            while not release:
                time.sleep(0.01)
            return super().gather(idx, out_x=out_x, out_y=out_y)

    plan = np.zeros((2, 4), np.int64)
    loader = BlockPrefetcher(Stalls(x, y), plan, plan, device="cpu",
                             timeout=0.2)
    try:
        with pytest.raises(TimeoutError):
            loader.get()
    finally:
        release.append(True)
        loader.close()
    assert not loader._thread.is_alive()


def test_prefetcher_defaults_to_the_card(xy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = xy
    for loader in (BlockPrefetcher, tsource.SyncGather):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loader(HostSource(x, y))
