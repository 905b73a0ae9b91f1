"""Host-resident training data plane (port of ``repro/data/source.py``'s
``DataSource``, ``HostSource``, ``InMemorySource``, ``BlockPrefetcher``,
``SyncGather``, ``split_holdout``, the memmap datasets and
``ManifestSource``).

The doubly stochastic step only ever needs the sampled rows of I and J, so
the training set can stay on the host, or on disk, while the O(N) dual
vector lives on the card:

  * ``DataSource`` — the protocol the trainer gathers rows through: ``n``
    rows of dimension ``d``, ``gather(idx) -> (x_rows, y_rows)`` and
    ``gather_x(idx)`` as float32 numpy arrays.
  * ``HostSource`` — numpy / ``np.memmap`` backing.  Gathered rows are
    owned copies, never views of the mapping.  ``local(offset, length)``
    and ``split(n_shards)`` carve row-range views.
  * ``InMemorySource`` — wraps tensors; ``solver.fit`` trains on them in
    memory, and its host-side ``gather`` reads a lazily made host mirror.
  * ``BlockPrefetcher`` — a worker thread gathers step t+1's rows while the
    card runs step t.  On the card it gathers into pinned staging buffers
    and copies them to the device on a stream of its own (see the class);
    ``SyncGather`` is the same contract with every gather inline.
  * ``make_memmap_dataset`` / ``open_memmap_dataset`` / ``read_manifest``
    / ``ManifestSource`` — a synthetic float32 dataset on disk with a
    manifest, written from numpy's ``default_rng((seed, start))`` granule
    by granule: the same bytes as the JAX package writes.
  * ``RingSource`` / ``RingSnapshot`` — an appendable ring of labeled
    events and the frozen, owned copies of its window that online
    training replays (``serving/online.py``).
  * ``MeshPrefetcher`` / ``SyncMeshGather`` — the mesh fit's data plane:
    whole-mesh epoch plans in, and each rank gathers only its OWN blocks
    (its data shard's gradient rows, its model shard's expansion rows and
    their local indices).  The JAX loaders gather every shard's rows and
    place them by sharding from one controller.
"""
from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import List, Optional, Protocol, Tuple, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Index = Union[np.ndarray, slice]

# Seconds between the worker's and the consumer's checks of the stop flag
# while they wait on a queue.
_POLL_S = 0.05
# Steps the prefetcher stages ahead of the consumer (double buffering).
_DEPTH = 2


@runtime_checkable
class DataSource(Protocol):
    """What the training stack needs from a dataset: sized row access."""

    @property
    def n(self) -> int: ...

    @property
    def d(self) -> int: ...

    def gather(self, idx: Index,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]: ...

    def gather_x(self, idx: Index,
                 out: Optional[np.ndarray] = None) -> np.ndarray: ...


class HostSource:
    """Rows on host memory or disk (``np.ndarray`` / ``np.memmap``).

    ``offset``/``length`` make a zero-copy view over a row range: a view
    reads (and pages in) only its own rows.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, *,
                 offset: int = 0, length: Optional[int] = None):
        if x.ndim != 2 or y.ndim != 1 or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"x must be (n, d) and y (n,); got {x.shape} / {y.shape}")
        length = x.shape[0] - offset if length is None else length
        if offset < 0 or offset + length > x.shape[0]:
            raise ValueError(
                f"row range [{offset}, {offset + length}) outside "
                f"0..{x.shape[0]}")
        self._x, self._y = x, y
        self._offset, self._n = int(offset), int(length)

    @property
    def n(self) -> int:
        return self._n

    @property
    def d(self) -> int:
        return int(self._x.shape[1])

    @property
    def nbytes(self) -> int:
        """Bytes the rows of THIS view take as float32 (x and y): what a
        device-resident copy would cost."""
        return 4 * self._n * (self.d + 1)

    def _absolute(self, idx: Index) -> Index:
        if isinstance(idx, slice):
            # Numpy slice semantics relative to THIS view, clamped before
            # offsetting: a view never reads a neighbouring range's rows.
            if idx.step not in (None, 1):
                raise ValueError("strided row slices are not supported; "
                                 "gather an index array instead")
            start = idx.start or 0
            stop = self._n if idx.stop is None else idx.stop
            if start < 0:
                start += self._n
            if stop < 0:
                stop += self._n
            start = min(max(start, 0), self._n)
            stop = min(max(stop, 0), self._n)
            return slice(start + self._offset, stop + self._offset)
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= self._n):
            raise IndexError(
                f"indices outside the view's [0, {self._n}) row range")
        return idx + self._offset if self._offset else idx

    @staticmethod
    def _take(backing: np.ndarray, ai: Index,
              out: Optional[np.ndarray]) -> np.ndarray:
        """The rows ``ai`` of ``backing`` as float32: in ``out`` (a staging
        buffer) when given, else as a fresh OWNED array.  A slice of the
        backing store is a view (memmap included), so it is copied
        explicitly; an index array lands in ``out`` by one ``np.take``
        (its bounds are checked already, so ``mode="clip"`` keeps numpy
        from buffering the output)."""
        if out is None:
            if isinstance(ai, slice):
                return np.array(backing[ai], np.float32)
            return np.asarray(backing[ai], np.float32)
        if not isinstance(ai, slice) and backing.dtype == out.dtype:
            dst = out[: ai.shape[0]]
            np.take(backing, ai, axis=0, out=dst, mode="clip")
            return dst
        rows = backing[ai]
        out[: rows.shape[0]] = rows
        return out[: rows.shape[0]]

    def gather(self, idx: Index,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Copy the requested rows out of the backing store as float32,
        into ``out_*`` staging buffers when given, else into fresh arrays.
        For a memmap this is the disk (or page cache) read."""
        ai = self._absolute(idx)
        return self._take(self._x, ai, out_x), self._take(self._y, ai, out_y)

    def gather_x(self, idx: Index,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        """``gather`` for feature rows only (expansion blocks and the
        streamed eval never need the labels)."""
        return self._take(self._x, self._absolute(idx), out)

    def local(self, offset: int, length: int) -> "HostSource":
        """A view over rows [offset, offset + length) of THIS view."""
        return HostSource(self._x, self._y,
                          offset=self._offset + offset, length=length)

    def split(self, n_shards: int) -> List["HostSource"]:
        """Equal per-shard local views, row order kept (``n % n_shards``
        must be 0)."""
        if self._n % n_shards:
            raise ValueError(f"{self._n} rows do not split into {n_shards}")
        rows = self._n // n_shards
        return [self.local(s * rows, rows) for s in range(n_shards)]


class InMemorySource(HostSource):
    """A dataset held as tensors (on any device).

    ``solver.fit`` trains on ``.x`` / ``.y`` in memory (the serial and
    parallel plans); the host-side ``gather`` it inherits reads a host
    mirror made on first use, so the same source also works wherever a
    ``DataSource`` is expected (the hosted plan over raw arrays)."""

    def __init__(self, x, y):
        self.x = torch.as_tensor(x).to(torch.float32)
        self.y = torch.as_tensor(y).to(torch.float32)
        if self.x.dim() != 2 or self.y.dim() != 1 \
                or self.x.shape[0] != self.y.shape[0]:
            raise ValueError(f"x must be (n, d) and y (n,); got "
                             f"{tuple(self.x.shape)} / {tuple(self.y.shape)}")
        self._host_ready = False

    def _ensure_host(self) -> None:
        if not self._host_ready:
            super().__init__(self.x.detach().cpu().numpy(),
                             self.y.detach().cpu().numpy())
            self._host_ready = True

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def d(self) -> int:
        return int(self.x.shape[1])

    @property
    def nbytes(self) -> int:
        return 4 * self.n * (self.d + 1)

    def gather(self, idx: Index,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_host()
        return super().gather(idx, out_x=out_x, out_y=out_y)

    def gather_x(self, idx: Index,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        self._ensure_host()
        return super().gather_x(idx, out=out)

    def local(self, offset: int, length: int) -> HostSource:
        self._ensure_host()
        return super().local(offset, length)

    def split(self, n_shards: int) -> List[HostSource]:
        self._ensure_host()
        return super().split(n_shards)


# ---------------------------------------------------------------------------
# Appendable ring source (online training; DESIGN.md §11).
# ---------------------------------------------------------------------------

class RingSnapshot(HostSource):
    """A frozen, owned copy of a ring window: what one training epoch
    replays while the writer keeps appending.

    ``RingSource.snapshot()`` copies the live window out of the ring, so
    later appends (wrap-around overwrites of the very rows it captured
    included) can never alias it.  The snapshot carries its identity in
    absolute event coordinates: ``high_water`` is the writer's total at
    snapshot time, and the snapshot covers the absolute rows ``[base,
    high_water)`` with ``base = high_water - n``.  The online service
    carries alpha across support-set rebuilds and measures staleness in
    these coordinates.  Reads past ``n`` are refused by the inherited
    bounds check."""

    def __init__(self, x: np.ndarray, y: np.ndarray, *, version: int,
                 high_water: int):
        super().__init__(x, y)
        self.version = int(version)
        self.high_water = int(high_water)

    @property
    def base(self) -> int:
        """Absolute event id of row 0 (``high_water - n``)."""
        return self.high_water - self.n


class RingSource(HostSource):
    """Appendable ring-buffer ``HostSource``: bounded backing, unbounded
    stream.

    The writer ``append``s labeled events; ``total`` counts every event
    ever appended, while only the newest ``min(total, capacity)`` rows
    stay resident (older rows are overwritten in ring order).  Training
    never reads the live ring: it takes a ``snapshot()``, a versioned,
    frozen copy of the current window, so an epoch replays a fixed index
    range while events keep arriving (``solver.fit`` snapshots a live
    ring at entry).

    Row 0 of the live view is the oldest resident event.  Gathers are
    mapped through the ring and serialized against ``append`` (no torn
    rows), but the window can shift between calls: anything that needs
    repeatable indices takes a snapshot.

    ``RingSource.memmap(directory, capacity, d)`` backs the ring with
    disk memmaps; the default backing is plain numpy."""

    def __init__(self, capacity: int, d: int, *,
                 x: Optional[np.ndarray] = None,
                 y: Optional[np.ndarray] = None):
        capacity, d = int(capacity), int(d)
        if capacity <= 0 or d <= 0:
            raise ValueError(f"capacity and d must be positive; got "
                             f"{capacity} / {d}")
        xb = np.zeros((capacity, d), np.float32) if x is None else x
        yb = np.zeros((capacity,), np.float32) if y is None else y
        if xb.shape != (capacity, d) or yb.shape != (capacity,):
            raise ValueError(
                f"backing must be ({capacity}, {d}) / ({capacity},); got "
                f"{xb.shape} / {yb.shape}")
        super().__init__(xb, yb)
        self._capacity = capacity
        self._total = 0
        self._version = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def total(self) -> int:
        """Events ever appended (the monotonic high-water mark)."""
        return self._total

    @property
    def n(self) -> int:
        """Resident rows: ``min(total, capacity)``."""
        return min(self._total, self._capacity)

    @property
    def nbytes(self) -> int:
        return 4 * self.n * (self.d + 1)

    def append(self, x_rows: np.ndarray, y_rows: np.ndarray) -> int:
        """Append labeled events; returns the new ``total``.  An append
        larger than the ring would overwrite part of itself, so it is
        refused rather than truncated."""
        x_rows = np.asarray(x_rows, np.float32)
        y_rows = np.asarray(y_rows, np.float32)
        if x_rows.ndim != 2 or y_rows.ndim != 1 \
                or x_rows.shape[0] != y_rows.shape[0] \
                or x_rows.shape[1] != self.d:
            raise ValueError(
                f"events must be (m, {self.d}) / (m,); got "
                f"{x_rows.shape} / {y_rows.shape}")
        m = int(x_rows.shape[0])
        if m > self._capacity:
            raise ValueError(
                f"append of {m} rows exceeds ring capacity "
                f"{self._capacity}")
        with self._lock:
            pos = self._total % self._capacity
            end = pos + m
            if end <= self._capacity:
                self._x[pos:end] = x_rows
                self._y[pos:end] = y_rows
            else:
                k = self._capacity - pos
                self._x[pos:] = x_rows[:k]
                self._y[pos:] = y_rows[:k]
                self._x[: end - self._capacity] = x_rows[k:]
                self._y[: end - self._capacity] = y_rows[k:]
            self._total += m
            return self._total

    def _window(self) -> Tuple[int, int]:
        """(live row count, physical index of logical row 0); the caller
        holds ``self._lock``."""
        n = min(self._total, self._capacity)
        start = (self._total % self._capacity
                 if self._total > self._capacity else 0)
        return n, start

    def _ring_index(self, idx: Index) -> np.ndarray:
        """A logical index (0 = the oldest resident row) as physical ring
        positions: always an index array, since the window may wrap the
        buffer's edge.  The caller holds ``self._lock``."""
        n, start = self._window()
        if isinstance(idx, slice):
            if idx.step not in (None, 1):
                raise ValueError("strided row slices are not supported; "
                                 "gather an index array instead")
            start_l = idx.start or 0
            stop_l = n if idx.stop is None else idx.stop
            if start_l < 0:
                start_l += n
            if stop_l < 0:
                stop_l += n
            idx = np.arange(min(max(start_l, 0), n),
                            min(max(stop_l, 0), n))
        else:
            idx = np.asarray(idx)
            if idx.size and (idx.min() < 0 or idx.max() >= n):
                raise IndexError(
                    f"indices outside the view's [0, {n}) row range")
        return (start + idx) % self._capacity

    def gather(self, idx: Index,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            ai = self._ring_index(idx)
            return (self._take(self._x, ai, out_x),
                    self._take(self._y, ai, out_y))

    def gather_x(self, idx: Index,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        with self._lock:
            return self._take(self._x, self._ring_index(idx), out)

    def local(self, offset: int, length: int) -> HostSource:
        raise TypeError("a live RingSource has no stable row range; take "
                        "a snapshot() and carve views from that")

    def split(self, n_shards: int) -> List[HostSource]:
        raise TypeError("a live RingSource has no stable row range; take "
                        "a snapshot() and split that")

    def snapshot(self) -> RingSnapshot:
        """Freeze the current window: a versioned, owned copy that
        training can replay while appends continue."""
        with self._lock:
            n, start = self._window()
            self._version += 1
            phys = (start + np.arange(n)) % self._capacity
            # Fancy indexing copies: the snapshot owns its rows and never
            # sees a later append (wrap-around included).
            return RingSnapshot(
                np.asarray(self._x[phys], np.float32),
                np.asarray(self._y[phys], np.float32),
                version=self._version, high_water=self._total)

    @classmethod
    def memmap(cls, directory: str, capacity: int, d: int) -> "RingSource":
        """A ring backed by disk memmaps (mode ``w+``: files of the same
        shape are reused), the JAX package's file names."""
        os.makedirs(directory, exist_ok=True)
        x = np.memmap(os.path.join(directory, f"ring_x_{capacity}x{d}.f32"),
                      np.float32, mode="w+", shape=(capacity, d))
        y = np.memmap(os.path.join(directory, f"ring_y_{capacity}.f32"),
                      np.float32, mode="w+", shape=(capacity,))
        return cls(capacity, d, x=x, y=y)


# ---------------------------------------------------------------------------
# Double-buffered prefetch.
# ---------------------------------------------------------------------------

class _Buffers:
    """One staging slot: the page-locked tensors of one step's blocks and
    the numpy views the gather writes into."""

    __slots__ = ("pinned", "views")

    def __init__(self, specs):
        # pin_memory=True allocates page-locked memory or raises.
        self.pinned = tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                            for shape, dtype in specs)
        if not all(t.is_pinned() for t in self.pinned):
            raise RuntimeError("staging buffer is not page-locked")
        self.views = tuple(t.numpy() for t in self.pinned)


class _DeviceBlocks:
    """One step's blocks on the card and the event that follows their
    copies on the prefetcher's stream."""

    __slots__ = ("blocks", "event")

    def __init__(self, blocks: Tuple[torch.Tensor, ...],
                 event: torch.cuda.Event):
        self.blocks, self.event = blocks, event


class BlockPrefetcher:
    """Gather (and stage) step t+1's sampled rows while the card runs
    step t.

    Built from host-side epoch plans: ``plan_i (steps, n_grad)`` indexes
    the gradient rows, ``plan_j (steps, m)`` the (flattened) expansion
    rows.  ``extend(plan_i, plan_j)`` queues further epochs onto the SAME
    worker thread and staging slot, so a fit that plans each epoch one
    ahead streams across epoch boundaries; ``stats()`` accumulates over
    the prefetcher's life.  A segment with zero steps is legal.

    ``get()`` returns the next step's ``(xi, yi, xj_flat)`` as tensors on
    ``device`` (default ``cuda``):

    * on the card, the worker gathers with ``np.take`` into a page-locked
      staging slot, issues ``non_blocking`` copies into blocks it
      allocates on a stream of its own, records an event after them, and
      reuses the slot only after ``event.synchronize()``.
      ``get()`` makes the caller's current stream wait on that event and
      ``record_stream``s the blocks onto it, so the caching allocator
      cannot hand their memory to a later step's copy while the caller's
      queued kernels still read it.
    * on the CPU, the worker gathers into fresh owned arrays
      (``torch.from_numpy`` aliases its array, so no buffer is reused).

    At most two steps wait staged ahead.  A failure in the worker
    surfaces in ``get()``; every wait has a timeout, ``get()`` raises
    ``TimeoutError`` after ``timeout`` seconds without a step, and
    ``close()`` stops the worker, mid-stream or failed.  ``stats()``:
    ``gather_s`` is worker time spent gathering and copying rows,
    ``wait_s`` consumer time blocked in ``get()``.
    """

    def __init__(self, source: DataSource,
                 plan_i: Optional[np.ndarray] = None,
                 plan_j: Optional[np.ndarray] = None, *,
                 device: DeviceLike = None, timeout: float = 300.0):
        self._source = source
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # The worker thread sets its device by index.
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._timeout = float(timeout)
        self._bufs: Optional[_Buffers] = None
        self._segments: "queue.Queue[Tuple[np.ndarray, np.ndarray]]" = \
            queue.Queue()
        self.steps = 0
        self._taken = 0
        self._widths: Optional[Tuple[int, int]] = None
        self._ready: "queue.Queue[object]" = queue.Queue(maxsize=_DEPTH)
        self._stop = False
        self.gather_s = 0.0
        self.wait_s = 0.0
        if plan_i is not None:
            self.extend(plan_i, plan_j)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="BlockPrefetcher")
        self._thread.start()

    def extend(self, plan_i: np.ndarray, plan_j: np.ndarray) -> None:
        """Queue another epoch's plan onto the live worker (from the
        consumer's thread).  Step widths must match the first segment's:
        the staging slot serves the prefetcher's whole life."""
        plan_i, plan_j = np.asarray(plan_i), np.asarray(plan_j)
        if plan_j.shape[0] != plan_i.shape[0]:
            raise ValueError("plan_i / plan_j step counts differ")
        widths = (int(plan_i.shape[1]),
                  int(np.prod(plan_j.shape[1:], dtype=int)))
        if self._widths is None:
            self._widths = widths
            if self._cuda:
                self._bufs = _Buffers(self._buffer_specs(widths))
        elif widths != self._widths and plan_i.shape[0]:
            raise ValueError(
                f"segment step widths {widths} != first segment's "
                f"{self._widths}; one prefetcher serves one block geometry")
        self.steps += int(plan_i.shape[0])
        self._segments.put((plan_i, plan_j))

    # -- worker side ----------------------------------------------------
    def _next_indices(self):
        """Per-step (idx_i, idx_j), waiting between segments until the
        consumer extends the plan; ends when ``close()`` sets the stop
        flag."""
        while not self._stop:
            try:
                seg_i, seg_j = self._segments.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            for t in range(seg_i.shape[0]):
                yield seg_i[t], seg_j[t].reshape(-1)

    def _put_ready(self, item) -> bool:
        """Hand ``item`` to the consumer; False once ``close()`` asked the
        worker to stop."""
        while not self._stop:
            try:
                self._ready.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # -- what a step is: overridden by MeshPrefetcher ---------------------
    def _buffer_specs(self, widths: Tuple[int, int]):
        """(shape, dtype) of each block of a step: xi, yi, xj_flat."""
        n_grad, n_flat = widths
        d = self._source.d
        return (((n_grad, d), torch.float32), ((n_grad,), torch.float32),
                ((n_flat, d), torch.float32))

    def _gather_into(self, idx_i: np.ndarray, idx_j: np.ndarray,
                     views) -> None:
        """One step's rows into the staging slot's numpy views."""
        xi, yi, xj = views
        self._source.gather(idx_i, out_x=xi, out_y=yi)
        self._source.gather_x(idx_j, out=xj)

    def _gather_host(self, idx_i: np.ndarray, idx_j: np.ndarray) -> Tuple:
        """One step's rows as fresh owned arrays (the CPU path)."""
        xi, yi = self._source.gather(idx_i)
        return xi, yi, self._source.gather_x(idx_j)

    def _stage(self, idx_i: np.ndarray, idx_j: np.ndarray,
               stream: torch.cuda.Stream) -> _DeviceBlocks:
        """Gather one step into the staging slot and copy it to the card
        on ``stream``; returns once the copies have landed, the slot free
        for the next step."""
        bufs = self._bufs
        self._gather_into(idx_i, idx_j, bufs.views)
        with torch.cuda.stream(stream):
            blocks = tuple(torch.empty(p.shape, dtype=p.dtype,
                                       device=self._device)
                           for p in bufs.pinned)
            for b, p in zip(blocks, bufs.pinned):
                b.copy_(p, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        return _DeviceBlocks(blocks, event)

    def _worker(self) -> None:
        try:
            stream = None
            if self._cuda:
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            for idx_i, idx_j in self._next_indices():
                t0 = time.perf_counter()
                if self._cuda:
                    item = self._stage(idx_i, idx_j, stream)
                else:
                    item = tuple(torch.from_numpy(a)
                                 for a in self._gather_host(idx_i, idx_j))
                self.gather_s += time.perf_counter() - t0
                if not self._put_ready(item):
                    return
        except Exception as e:                   # surfaces in get()
            self._put_ready(e)

    # -- consumer side --------------------------------------------------
    def get(self) -> Tuple:
        """The next step's ``(xi, yi, xj_flat)``; blocks until the worker
        has staged it.  Raises the worker's error, ``RuntimeError`` past
        the end of the plan or after ``close()``, and ``TimeoutError``
        after ``timeout`` seconds."""
        if self._stop:
            raise RuntimeError("the prefetcher is closed")
        if self._taken >= self.steps:
            raise RuntimeError(f"all {self.steps} planned steps were taken; "
                               "extend() the plan first")
        t0 = time.perf_counter()
        while True:
            try:
                item = self._ready.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._ready.empty():
                    raise RuntimeError("the prefetch worker ended without "
                                       "staging the next step") from None
                if time.perf_counter() - t0 > self._timeout:
                    raise TimeoutError(
                        f"no staged step within {self._timeout} s") from None
        self.wait_s += time.perf_counter() - t0
        if isinstance(item, Exception):
            raise item
        self._taken += 1
        if isinstance(item, _DeviceBlocks):
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.event)
            for b in item.blocks:
                b.record_stream(stream)
            return item.blocks
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and join it (at most ``timeout`` seconds), then
        drop the staged steps."""
        self._stop = True
        self._thread.join(timeout=timeout)
        while True:
            try:
                self._ready.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "BlockPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        return {"steps": self.steps, "gather_s": self.gather_s,
                "wait_s": self.wait_s}


class SyncGather:
    """The no-overlap baseline with ``BlockPrefetcher``'s ``get()`` /
    ``extend()`` contract: every gather and copy to ``device`` runs
    inline on the consumer's thread (a pageable copy, so ``wait_s`` is
    ``gather_s``)."""

    def __init__(self, source: DataSource,
                 plan_i: Optional[np.ndarray] = None,
                 plan_j: Optional[np.ndarray] = None, *,
                 device: DeviceLike = None):
        self._source = source
        self._device = resolve_device(device)
        # Consumed steps are popped: a fit-lived loader holds at most the
        # epoch planned ahead.
        self._steps: "collections.deque[Tuple[np.ndarray, np.ndarray]]" = \
            collections.deque()
        self.steps = 0
        self.gather_s = 0.0
        if plan_i is not None:
            self.extend(plan_i, plan_j)

    def extend(self, plan_i: np.ndarray, plan_j: np.ndarray) -> None:
        plan_i, plan_j = np.asarray(plan_i), np.asarray(plan_j)
        if plan_j.shape[0] != plan_i.shape[0]:
            raise ValueError("plan_i / plan_j step counts differ")
        for t in range(plan_i.shape[0]):
            self._steps.append((plan_i[t], plan_j[t].reshape(-1)))
        self.steps += int(plan_i.shape[0])

    def get(self) -> Tuple:
        t0 = time.perf_counter()
        idx_i, idx_j = self._steps.popleft()
        xi, yi = self._source.gather(idx_i)
        xj = self._source.gather_x(idx_j)
        out = tuple(torch.from_numpy(a).to(self._device)
                    for a in (xi, yi, xj))
        self.gather_s += time.perf_counter() - t0
        return out

    def close(self) -> None:
        pass

    def __enter__(self) -> "SyncGather":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def stats(self) -> dict:
        return {"steps": self.steps, "gather_s": self.gather_s,
                "wait_s": self.gather_s}


# ---------------------------------------------------------------------------
# The mesh's data plane: each rank gathers its own blocks.
# ---------------------------------------------------------------------------

def _check_mesh_segment(plan_i: np.ndarray, plan_j: np.ndarray,
                        first: Optional[Tuple[int, int]]
                        ) -> Tuple[int, int]:
    """The (data, model) shard counts of a mesh plan segment, refused in
    the JAX loaders' words when it is not (steps, shards, width) or its
    shard counts differ from the first segment's."""
    if plan_j.shape[0] != plan_i.shape[0]:
        raise ValueError("plan_i / plan_j step counts differ")
    if plan_i.ndim != 3 or plan_j.ndim != 3:
        raise ValueError(
            f"mesh plan segments are (steps, shards, width); got "
            f"{plan_i.shape} / {plan_j.shape}")
    shards = (int(plan_i.shape[1]), int(plan_j.shape[1]))
    if first is not None and shards != first and plan_i.shape[0]:
        raise ValueError(
            f"segment shard counts (data={shards[0]}, "
            f"model={shards[1]}) != first segment's "
            f"(data={first[0]}, model={first[1]}); "
            "per-shard plans do not survive a mesh reshape — re-split "
            "the sources and build a fresh prefetcher (elastic "
            "rescale resumes do this)")
    return shards if first is None else first


class MeshPrefetcher(BlockPrefetcher):
    """``BlockPrefetcher`` over whole-mesh plan segments, for the rank at
    ``coord = (d, m)``: the mesh fit's data plane.

    Segments are whole-epoch mesh plans (``sampler.mesh_epoch_plan``):
    ``plan_i (steps, n_data, n_grad)`` / ``plan_j (steps, n_model,
    n_expand)``, LOCAL indices into the per-shard views
    (``source.split``).  The worker gathers only this rank's blocks, its
    data shard's rows from ``data_sources[d]`` and its model shard's from
    ``model_sources[m]``, and ``get()`` returns ``(xi, yi, xj, idx_j)`` on
    the rank's device, idx_j int64 LOCAL indices into its alpha shard.  On
    the card the rows go through the page-locked staging slot and the
    loader's own stream, exactly as ``BlockPrefetcher``'s do.  A segment
    whose shard counts differ from the first segment's is refused: an
    elastic rescale re-splits the sources and builds a fresh loader."""

    def __init__(self, data_sources: List[DataSource],
                 model_sources: List[DataSource],
                 plan_i: Optional[np.ndarray] = None,
                 plan_j: Optional[np.ndarray] = None, *,
                 coord: Tuple[int, int], device: DeviceLike = None,
                 timeout: float = 300.0):
        self._coord = (int(coord[0]), int(coord[1]))
        self._data_source = data_sources[self._coord[0]]
        self._model_source = model_sources[self._coord[1]]
        self._shards: Optional[Tuple[int, int]] = None
        super().__init__(self._data_source, plan_i, plan_j, device=device,
                         timeout=timeout)

    def extend(self, plan_i: np.ndarray, plan_j: np.ndarray) -> None:
        plan_i, plan_j = np.asarray(plan_i), np.asarray(plan_j)
        self._shards = _check_mesh_segment(plan_i, plan_j, self._shards)
        d, m = self._coord
        super().extend(plan_i[:, d], plan_j[:, m])

    def _buffer_specs(self, widths: Tuple[int, int]):
        n_grad, n_expand = widths
        return super()._buffer_specs(widths) + (
            ((n_expand,), torch.int64),)

    def _gather_into(self, idx_i: np.ndarray, idx_j: np.ndarray,
                     views) -> None:
        xi, yi, xj, ij = views
        self._data_source.gather(idx_i, out_x=xi, out_y=yi)
        self._model_source.gather_x(idx_j, out=xj)
        ij[:] = idx_j

    def _gather_host(self, idx_i: np.ndarray, idx_j: np.ndarray) -> Tuple:
        xi, yi = self._data_source.gather(idx_i)
        return (xi, yi, self._model_source.gather_x(idx_j),
                np.array(idx_j, np.int64))


class SyncMeshGather:
    """The inline mesh baseline with ``MeshPrefetcher``'s ``get()`` /
    ``extend()`` contract: the rank's gathers and its copies to ``device``
    run on the consumer's thread (so ``wait_s`` is ``gather_s``)."""

    def __init__(self, data_sources: List[DataSource],
                 model_sources: List[DataSource],
                 plan_i: Optional[np.ndarray] = None,
                 plan_j: Optional[np.ndarray] = None, *,
                 coord: Tuple[int, int], device: DeviceLike = None):
        d, m = int(coord[0]), int(coord[1])
        self._coord = (d, m)
        self._data_source = data_sources[d]
        self._model_source = model_sources[m]
        self._device = resolve_device(device)
        self._steps: "collections.deque[Tuple[np.ndarray, np.ndarray]]" = \
            collections.deque()
        self._shards: Optional[Tuple[int, int]] = None
        self.steps = 0
        self.gather_s = 0.0
        if plan_i is not None:
            self.extend(plan_i, plan_j)

    def extend(self, plan_i: np.ndarray, plan_j: np.ndarray) -> None:
        plan_i, plan_j = np.asarray(plan_i), np.asarray(plan_j)
        self._shards = _check_mesh_segment(plan_i, plan_j, self._shards)
        d, m = self._coord
        for t in range(plan_i.shape[0]):
            self._steps.append((plan_i[t, d], plan_j[t, m]))
        self.steps += int(plan_i.shape[0])

    def get(self) -> Tuple:
        t0 = time.perf_counter()
        idx_i, idx_j = self._steps.popleft()
        xi, yi = self._data_source.gather(idx_i)
        xj = self._model_source.gather_x(idx_j)
        out = tuple(torch.from_numpy(a).to(self._device)
                    for a in (xi, yi, xj, np.array(idx_j, np.int64)))
        self.gather_s += time.perf_counter() - t0
        return out

    def close(self) -> None:
        pass

    def __enter__(self) -> "SyncMeshGather":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def stats(self) -> dict:
        return {"steps": self.steps, "gather_s": self.gather_s,
                "wait_s": self.gather_s}


# ---------------------------------------------------------------------------
# Memmapped synthetic datasets (examples, tests, launch --data mmap).
# ---------------------------------------------------------------------------

def split_holdout(source: HostSource, *, cap: int = 2048, frac: int = 8
                  ) -> Tuple[HostSource, np.ndarray, np.ndarray]:
    """Hold out the LAST ``min(cap, n // frac)`` rows (at least one):
    ``(train_view, x_val, y_val)``.  The train view never sees the held-out
    rows, which are copied out of the backing store (owned arrays) through
    a local view of their range."""
    n_val = max(min(cap, source.n // frac), 1)
    train = source.local(0, source.n - n_val)
    x_val, y_val = source.local(source.n - n_val, n_val).gather(
        slice(0, n_val))
    return train, x_val, y_val


def make_memmap_dataset(directory: str, n: int, d: int, *, seed: int = 0,
                        granule: int = 8192) -> HostSource:
    """Write a learnable synthetic (N, D) classification set to disk as
    float32 memmaps, one ``granule`` of rows at a time (peak host memory
    O(granule * D)), with its ``manifest.json``, and return a read-only
    ``HostSource`` over it.  Granule g is drawn from numpy's
    ``default_rng((seed, g_start))``: the files equal the JAX package's
    byte for byte.

    Labels: the sign of a covertype-like nonlinear score (a smooth function
    of a fixed random projection plus low-order interactions) on
    all-continuous features."""
    os.makedirs(directory, exist_ok=True)
    x_path = os.path.join(directory, f"x_{n}x{d}.f32")
    y_path = os.path.join(directory, f"y_{n}.f32")
    x_mm = np.memmap(x_path, np.float32, mode="w+", shape=(n, d))
    y_mm = np.memmap(y_path, np.float32, mode="w+", shape=(n,))
    root = np.random.default_rng(seed)
    w = root.standard_normal(d).astype(np.float32)
    for start in range(0, n, granule):
        stop = min(start + granule, n)
        rng = np.random.default_rng((seed, start))
        xc = rng.standard_normal((stop - start, d)).astype(np.float32)
        score = (np.tanh(xc @ w / np.sqrt(d)) + 0.5 * np.sin(2.0 * xc[:, 0])
                 + 0.25 * xc[:, 1] * xc[:, 2] + 0.18)
        x_mm[start:stop] = xc
        y_mm[start:stop] = np.where(score >= 0.0, 1.0, -1.0)
    x_mm.flush()
    y_mm.flush()
    del x_mm, y_mm
    # The manifest: sizes, file names and the recipe, written atomically.
    manifest = {"version": 1, "n": int(n), "d": int(d), "dtype": "float32",
                "x_file": os.path.basename(x_path),
                "y_file": os.path.basename(y_path),
                "seed": int(seed), "granule": int(granule)}
    tmp = os.path.join(directory, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(directory, "manifest.json"))
    return open_memmap_dataset(directory, n, d)


def open_memmap_dataset(directory: str, n: Optional[int] = None,
                        d: Optional[int] = None) -> HostSource:
    """Re-open a dataset written by ``make_memmap_dataset``, read-only;
    ``n`` / ``d`` come from its ``manifest.json`` when omitted."""
    if n is None or d is None:
        meta = read_manifest(directory)
        n, d = meta["n"], meta["d"]
    x = np.memmap(os.path.join(directory, f"x_{n}x{d}.f32"), np.float32,
                  mode="r", shape=(n, d))
    y = np.memmap(os.path.join(directory, f"y_{n}.f32"), np.float32,
                  mode="r", shape=(n,))
    return HostSource(x, y)


def read_manifest(directory: str) -> dict:
    """Load and validate ``manifest.json``."""
    path = os.path.join(directory, "manifest.json")
    with open(path) as f:
        meta = json.load(f)
    for k in ("n", "d", "x_file", "y_file"):
        if k not in meta:
            raise ValueError(f"manifest {path} is missing {k!r}")
    if meta.get("dtype", "float32") != "float32":
        raise ValueError(f"manifest dtype {meta['dtype']!r} unsupported")
    return meta


class ManifestSource(HostSource):
    """A dataset addressed through its manifest, mapped per row range.

    The object holds only the manifest's metadata; ``local`` (and
    ``split``) return further ``ManifestSource`` views, and a view opens
    its ``np.memmap`` on first gather with ``offset=`` into the file,
    covering only its own rows."""

    def __init__(self, directory: str, *, offset: int = 0,
                 length: Optional[int] = None, _meta: Optional[dict] = None):
        meta = read_manifest(directory) if _meta is None else _meta
        n, d = int(meta["n"]), int(meta["d"])
        length = n - offset if length is None else int(length)
        if offset < 0 or offset + length > n:
            raise ValueError(
                f"row range [{offset}, {offset + length}) outside 0..{n}")
        self._directory = directory
        self._meta = meta
        self._global_offset = int(offset)   # rows into the file
        self._n = int(length)
        self._d = d
        self._offset = 0                    # view-local, after mapping
        self._mapped = False

    @property
    def d(self) -> int:
        return self._d

    @property
    def mapped(self) -> bool:
        """Whether this view has opened its memmap."""
        return self._mapped

    @property
    def global_offset(self) -> int:
        """First row of the file this view covers."""
        return self._global_offset

    def _ensure_mapped(self) -> None:
        if self._mapped:
            return
        meta, r0, rows = self._meta, self._global_offset, self._n
        x = np.memmap(os.path.join(self._directory, meta["x_file"]),
                      np.float32, mode="r", shape=(rows, self._d),
                      offset=4 * r0 * self._d)
        y = np.memmap(os.path.join(self._directory, meta["y_file"]),
                      np.float32, mode="r", shape=(rows,), offset=4 * r0)
        HostSource.__init__(self, x, y)
        self._mapped = True

    def gather(self, idx: Index,
               out_x: Optional[np.ndarray] = None,
               out_y: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_mapped()
        return super().gather(idx, out_x=out_x, out_y=out_y)

    def gather_x(self, idx: Index,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        self._ensure_mapped()
        return super().gather_x(idx, out=out)

    def local(self, offset: int, length: int) -> "ManifestSource":
        if offset < 0 or offset + length > self._n:
            raise ValueError(
                f"row range [{offset}, {offset + length}) outside the "
                f"view's [0, {self._n})")
        return ManifestSource(self._directory,
                              offset=self._global_offset + offset,
                              length=length, _meta=self._meta)
