"""Streaming DSEKL prediction engine, on one device or with its support set
sharded over a mesh (port of ``repro/serving/dsekl_engine.py``).

Serving is ``f(x) = K(x, X_sv) @ alpha_sv``:

  1. **Truncate + pad.**  The trained model is compacted to its support set
     (``dsekl.truncate``, index order kept) and zero-padded to a fixed
     geometry: ``n_sv_padded`` support rows (a multiple of ``sv_block``)
     and ``query_block`` query rows per serve call.
  2. **Tiled evaluation.**  Each serve call is one
     ``kops.kernel_matvec_tiled`` over the padded support set: one launch
     of the hand-written Hopper kernel on the card (K never in memory), the
     ``sv_block``-tiled plain-torch loop on the CPU.
  3. **Micro-batching front door.**  ``submit()`` queues ragged query
     batches; ``flush()`` / ``flush_async()`` concatenate them, pad into
     ``query_block`` tiles, serve every tile and split results per request.
  4. **Double-buffered pipeline.**  ``flush_async()`` fills one of two
     (pinned, on the card) host staging buffers with tile *n+1* while the
     device runs tile *n*; before a buffer is refilled, the host waits for
     the copy out of it two tiles back.  One synchronisation at handoff.
  5. **Kernel-map tile cache** with per-owner accounting and quotas
     (``cache_blocks > 0``): an LRU of materialized ``K(tile, X_sv)`` keyed
     on the tile's content hash; a hit is one matvec against the current
     alpha.

Thread-safety: one serving thread owns ``submit``/``flush*``/``predict``
and the cache mutators; ``update_alpha`` may run concurrently from another
thread (every sweep captures ``(alpha, version)`` once, under a lock).  On
the card the publisher and the server may run on different CUDA streams:
``update_alpha`` records an event after its copy, and the sweep-start
capture makes the serving stream (the serving thread's current stream)
wait on it and ``record_stream``s the captured tensors onto that stream,
so neither a torn alpha nor a reused allocation can reach a sweep.  The
pipelined flush's handoff synchronises the serving stream alone: work
another thread queued on its own stream does not delay it.

**Support-set sharding.**  With ``mesh`` (a ``launch.mesh.LocalMesh``) the
padded geometry is JAX's (``per_shard`` rows a data shard, ``sv_block``
shrunk to it, ``n_sv_padded`` a multiple of ``n_shards * sv_block``), and
the rank at data coordinate d holds rows ``[d, d + 1) * n_sv_padded /
n_shards`` of the support set and of alpha; ranks that differ only on the
model axis hold the same shard, as JAX's replicas do.  Each serve call
runs the matvec on the local shard, then one ``all_reduce`` of
``query_block`` floats over the data axis; the kernel-map cache keeps the
local K tile and its hits sum the local product the same way.  The
engine is SPMD: every rank makes the same calls with the same queries.
The reduction is queued on the sweep's own stream, after its wait on
the publish's event (gloo stages a CUDA tensor through the host, after
the stream's prior work).

**Spans.**  Under any ``torch.profiler`` session the engine marks its
host work (``repro_torch.tracing``): ``repro_torch.engine.submit`` (one
call, an auto-flush included), ``.flush`` (one sweep, pipelined or not)
with ``.merge`` (the alpha capture and the queue's concatenation),
``.stage`` (one pipelined tile: the slot's wait, the staging copy, the
copy to the card), ``.serve`` (one serve call, its ``all_reduce``
included), ``.cache_tile`` (one tile through the cache), ``.predict``
(the direct path) and ``.handoff`` (the pipeline's concatenation and
synchronisation).  With no profiler on a span costs one flag check.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import tracing
from repro_torch.core import dsekl
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static serving geometry (fixed at engine build)."""
    query_block: int = 1024     # padded query rows per serve call
    sv_block: int = 4096        # support rows per tile (ref path)
    truncate_tol: float = 1e-8  # |alpha| below this is not a support vector
                                # (negative keeps EVERY row: required for
                                # update_alpha)
    max_queue: int = 64         # submitted batches before submit auto-flushes
    cache_blocks: int = 0       # LRU capacity in cached kernel-map tiles
                                # (query_block * n_sv_padded * 4 bytes each;
                                # 0 disables the cache)


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pad_to(t: Tensor, rows: int) -> Tensor:
    """Zero-pad axis 0 of ``t`` to exactly ``rows`` rows."""
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad]).contiguous()


def _f32_copy(x, device: torch.device) -> Tensor:
    """A float32 copy of ``x`` (tensor or array) on ``device``: the caller
    may reuse its buffer after handing it over."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


class DSEKLPredictionEngine:
    """Batched kernel-prediction engine for a trained model.

    >>> eng = DSEKLPredictionEngine(cfg, alpha, x_train, device="cuda")
    >>> f = eng.predict(x_query)                   # any number of rows
    >>> t0 = eng.submit(batch_a); t1 = eng.submit(batch_b)
    >>> outs = eng.flush_async()                   # [f_a, f_b], pipelined
    """

    def __init__(self, cfg: DSEKLConfig, alpha, x_train, *,
                 engine_cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None, alpha_version: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        ec = engine_cfg
        alpha = _f32_copy(alpha, self.device)
        x_train = _f32_copy(x_train, self.device)

        # --- 1. truncate to the support set -------------------------------
        a_sv, x_sv = dsekl.truncate(alpha, x_train, ec.truncate_tol)
        self.n_train = int(x_train.shape[0])
        self.n_sv = int(a_sv.shape[0])
        self.d = int(x_train.shape[1])

        # --- 2. pad to the fixed tile geometry ----------------------------
        # Shrink the SV tile for small support sets so padding stays bounded.
        shards = mesh.size("data") if mesh is not None else 1
        self.n_shards = shards
        per_shard = max(1, -(-max(self.n_sv, 1) // shards))
        self.sv_block = min(ec.sv_block, _round_up(per_shard, 128))
        self.n_sv_padded = _round_up(max(self.n_sv, 1),
                                     shards * self.sv_block)
        # --- 3. this rank's shard of the support set ----------------------
        self._x_sv = self._shard(_pad_to(x_sv, self.n_sv_padded))
        self._a_sv = self._shard(_pad_to(a_sv, self.n_sv_padded))

        self._queue: List[Tensor] = []
        # Results carried by auto-flush, tagged with their sweep's version.
        self._done: List[Tuple[Tensor, int]] = []
        self.serve_calls = 0
        self.async_flushes = 0
        self.alpha_version = int(alpha_version)
        self._alpha_lock = threading.Lock()
        # Recorded after the build's (and each update_alpha's) copies on
        # the building thread's stream; every sweep's stream waits on it.
        self._alpha_ready = self._record_ready()

        # --- kernel-map tile cache (LRU, content-hash keyed) --------------
        self._cache: "OrderedDict[bytes, Tensor]" = OrderedDict()
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._cache_owner: Optional[str] = None
        self._cache_quota: dict = {}        # owner -> max resident tiles
        self._tile_owner: dict = {}         # tile key -> owner
        self._owner_cache: dict = {}        # owner -> counter dict
        self._staging: Optional[List[Tensor]] = None   # ping-pong buffers

    # ------------------------------------------------------------------
    # The serve function: (query_block, D) -> (query_block,).
    # ------------------------------------------------------------------

    def _shard(self, t: Tensor) -> Tensor:
        """This rank's rows of a padded (n_sv_padded, ...) array."""
        if self.n_shards == 1:
            return t
        rows = self.n_sv_padded // self.n_shards
        lo = self.mesh.index("data") * rows
        return t[lo:lo + rows].contiguous()

    def _reduce(self, f: Tensor) -> Tensor:
        """The partial f over this rank's shard summed over the data axis
        (one ``all_reduce`` of ``query_block`` floats)."""
        if self.n_shards > 1:
            dist.all_reduce(f, op=dist.ReduceOp.SUM,
                            group=self.mesh.group("data"))
        return f

    def _serve(self, xq: Tensor, a_sv: Tensor) -> Tensor:
        with tracing.span("repro_torch.engine.serve"):
            return self._reduce(kops.kernel_matvec_tiled(
                xq, self._x_sv, a_sv, kernel_name=self.cfg.kernel,
                kernel_params=self.cfg.kernel_params, z_block=self.sv_block,
                impl=self.cfg.impl))

    def _kmap(self, xq: Tensor) -> Tensor:
        """K(tile, X_sv) materialized, (query_block, this rank's support
        rows): the cache-miss path (the point of the cache is to keep
        K)."""
        return kops.kernel_block(xq, self._x_sv, kernel_name=self.cfg.kernel,
                                 kernel_params=self.cfg.kernel_params)

    # ------------------------------------------------------------------
    # Kernel-map tile cache.
    # ------------------------------------------------------------------

    @property
    def _cache_on(self) -> bool:
        return self.engine_cfg.cache_blocks > 0

    @staticmethod
    def _tile_key(tile: np.ndarray) -> bytes:
        return hashlib.sha1(tile.tobytes()).digest()

    def set_cache_owner(self, owner: Optional[str]) -> None:
        """Attribute subsequent cache traffic to ``owner`` (``None`` = the
        anonymous default owner).  Serving-thread only."""
        self._cache_owner = owner

    def set_cache_quota(self, owner: Optional[str],
                        quota: Optional[int]) -> None:
        """Bound ``owner``'s resident tiles: over a positive quota it
        evicts its OWN least-recently-used tile; ``quota == 0`` bypasses
        the cache (served by the streaming path, no dense K); ``None``
        removes the quota.  Serving-thread only."""
        if quota is None:
            self._cache_quota.pop(owner, None)
        else:
            self._cache_quota[owner] = int(quota)
        self._owner_counters(owner)

    def _owner_counters(self, owner: Optional[str]) -> dict:
        c = self._owner_cache.get(owner)
        if c is None:
            c = {"hits": 0, "misses": 0, "evictions": 0, "bypasses": 0,
                 "resident": 0}
            self._owner_cache[owner] = c
        return c

    def _evict_tile(self, key: bytes) -> None:
        del self._cache[key]
        victim_owner = self._tile_owner.pop(key, None)
        self._cache_evictions += 1
        self._owner_counters(victim_owner)["evictions"] += 1
        self._owner_counters(victim_owner)["resident"] -= 1

    def _owner_lru_key(self, owner: Optional[str],
                       exclude: Optional[bytes] = None) -> Optional[bytes]:
        for k in self._cache:                # oldest -> newest
            if k != exclude and self._tile_owner.get(k) == owner:
                return k
        return None

    def _serve_tile_cached(self, tile: np.ndarray, a_sv: Tensor) -> Tensor:
        """Serve one padded (query_block, D) host tile through the cache,
        contracting against the sweep's captured ``a_sv``."""
        with tracing.span("repro_torch.engine.cache_tile"):
            owner = self._cache_owner
            oc = self._owner_counters(owner)
            key = self._tile_key(tile)
            k_tile = self._cache.get(key)
            if k_tile is not None:
                self._cache.move_to_end(key)
                self._cache_hits += 1
                oc["hits"] += 1
                return self._reduce(k_tile @ a_sv)
            self._cache_misses += 1
            oc["misses"] += 1
            quota = self._cache_quota.get(owner)
            xq = _f32_copy(tile, self.device)
            self.serve_calls += 1
            if quota == 0:                       # admission denied: stream it
                oc["bypasses"] += 1
                return self._serve(xq, a_sv)
            k_tile = self._kmap(xq)
            self._cache[key] = k_tile
            self._tile_owner[key] = owner
            oc["resident"] += 1
            if quota is not None and oc["resident"] > quota:
                self._evict_tile(self._owner_lru_key(owner))
            while len(self._cache) > self.engine_cfg.cache_blocks:
                # Global pressure: prefer the inserting owner's own LRU tile.
                victim = self._owner_lru_key(owner, exclude=key)
                self._evict_tile(victim if victim is not None
                                 else next(iter(self._cache)))
            return self._reduce(k_tile @ a_sv)

    def cache_info(self) -> dict:
        """Hit/miss/eviction counters plus per-owner accounting under
        ``"owners"``; a fresh snapshot dict."""
        return {
            "enabled": self._cache_on,
            "capacity": self.engine_cfg.cache_blocks,
            "size": len(self._cache),
            "hits": self._cache_hits,
            "misses": self._cache_misses,
            "evictions": self._cache_evictions,
            "tile_bytes": 4 * self.engine_cfg.query_block * self.n_sv_padded,
            "owners": {
                (o if o is not None else "_default"): {
                    **c, "quota": self._cache_quota.get(o)}
                for o, c in self._owner_cache.items()},
        }

    def cache_clear(self) -> None:
        """Drop every resident tile (cumulative counters are kept;
        per-owner ``resident`` counts reset).  Serving-thread only."""
        self._cache.clear()
        self._tile_owner.clear()
        for c in self._owner_cache.values():
            c["resident"] = 0

    # ------------------------------------------------------------------
    # Model update.
    # ------------------------------------------------------------------

    def _record_ready(self) -> Optional[torch.cuda.Event]:
        """On the card, an event recorded on the calling thread's current
        stream after the copies it queued; ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _capture_alpha(self) -> Tuple[Tensor, int]:
        """The sweep-start capture: one coherent ``(alpha, version)``.  On
        the card the serving stream (the caller's current stream) waits on
        the publish's event, and the captured alpha and support rows are
        ``record_stream``ed onto it: the allocator does not hand their
        memory to the publisher's stream while this sweep may read it."""
        with self._alpha_lock:
            a_sv, version, ready = (self._a_sv, self.alpha_version,
                                    self._alpha_ready)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            a_sv.record_stream(stream)
            self._x_sv.record_stream(stream)
        return a_sv, version

    def update_alpha(self, alpha, *, version: Optional[int] = None) -> None:
        """Swap in new dual coefficients without rebuilding the engine.

        Only legal on a keep-all engine (``truncate_tol < 0``).  Cached
        kernel-map tiles stay valid (K does not depend on alpha).  A sweep
        already running completes on the alpha it captured; the version
        advances by one, or to an explicit ``version``.  Safe to call from
        a thread other than the serving thread, on a stream of its own: the
        copy is queued on the caller's current stream and an event after
        it orders every later sweep behind it."""
        if self.n_sv != self.n_train:
            raise ValueError(
                "update_alpha requires a keep-all engine (truncate_tol < 0):"
                f" {self.n_train - self.n_sv} rows were truncated at build")
        alpha = _f32_copy(alpha, self.device)
        if tuple(alpha.shape) != (self.n_train,):
            raise ValueError(
                f"alpha must be ({self.n_train},); got {tuple(alpha.shape)}")
        a_p = self._shard(_pad_to(alpha, self.n_sv_padded))
        ready = self._record_ready()
        with self._alpha_lock:
            self._a_sv = a_p
            self._alpha_ready = ready
            self.alpha_version = (self.alpha_version + 1
                                  if version is None else int(version))

    # ------------------------------------------------------------------
    # Direct path: predict any number of query rows.
    # ------------------------------------------------------------------

    def predict(self, x_query) -> Tensor:
        """f(x_query) on the engine's device: pads into ``query_block``
        tiles, each served by one serve call (through the cache when
        enabled), all against one captured alpha.  Returns without
        synchronising the device."""
        return self._predict(x_query, self._capture_alpha()[0])

    def warm(self) -> None:
        """One zero query tile through the serve function on the caller's
        stream (the kernel's first launch), past the tile cache: no tile
        is kept and no cache counter moves."""
        xq = torch.zeros((self.engine_cfg.query_block, self.d),
                         dtype=torch.float32, device=self.device)
        self._serve(xq, self._capture_alpha()[0])

    def _predict(self, x_query, a_sv: Tensor) -> Tensor:
        n = int(x_query.shape[0])
        if n == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        with tracing.span("repro_torch.engine.predict"):
            qb = self.engine_cfg.query_block
            if self._cache_on:
                merged = np.asarray(torch.as_tensor(x_query).detach().cpu(),
                                    dtype=np.float32)
                outs = []
                for start in range(0, n, qb):
                    tile = np.zeros((qb, self.d), np.float32)
                    rows = merged[start:start + qb]
                    tile[: rows.shape[0]] = rows
                    outs.append(self._serve_tile_cached(tile, a_sv))
                return torch.cat(outs)[:n]
            tiles = kops.tile_rows(_f32_copy(x_query, self.device), qb)
            outs = []
            for b in range(tiles.shape[0]):
                outs.append(self._serve(tiles[b], a_sv))
                self.serve_calls += 1
            return torch.cat(outs)[:n]

    # ------------------------------------------------------------------
    # Double-buffered pipeline.
    # ------------------------------------------------------------------

    def _staging_buffers(self) -> List[Tensor]:
        if self._staging is None:
            pin = self.device.type == "cuda"
            self._staging = [
                torch.zeros((self.engine_cfg.query_block, self.d),
                            dtype=torch.float32, pin_memory=pin)
                for _ in range(2)]
        return self._staging

    def _predict_pipelined(self, merged: np.ndarray, a_sv: Tensor) -> Tensor:
        """Serve a merged (n, D) host array with host/device overlap.

        Tile *b* is copied (asynchronously, from pinned memory on the card)
        out of staging buffer ``b % 2`` and served; meanwhile the host fills
        the other buffer with tile *b+1*.  Before refilling buffer ``b % 2``
        the host waits for the copy of tile *b-2* out of it.  The only
        other synchronisation is the one at handoff, of the serving stream
        (the caller's current stream) alone."""
        n = merged.shape[0]
        if n == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        qb = self.engine_cfg.query_block
        bufs = self._staging_buffers()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if cuda else None
        copied: List[Optional[torch.cuda.Event]] = [None, None]
        outs: List[Tensor] = []
        for b in range(-(-n // qb)):
            slot = b % 2
            with tracing.span("repro_torch.engine.stage"):
                if copied[slot] is not None:
                    copied[slot].synchronize()
                buf = bufs[slot]
                rows = torch.from_numpy(merged[b * qb:(b + 1) * qb])
                buf[: rows.shape[0]].copy_(rows)
                buf[rows.shape[0]:].zero_()
                if not self._cache_on:
                    if cuda:
                        xq = buf.to(self.device, non_blocking=True)
                        copied[slot] = torch.cuda.Event()
                        copied[slot].record(stream)
                    else:
                        xq = buf.clone()
            if self._cache_on:
                outs.append(self._serve_tile_cached(buf.numpy(), a_sv))
                continue
            outs.append(self._serve(xq, a_sv))
            self.serve_calls += 1
        with tracing.span("repro_torch.engine.handoff"):
            f = torch.cat(outs)[:n]
            if cuda:
                stream.synchronize()    # handoff: the serving stream alone
        return f

    # ------------------------------------------------------------------
    # Micro-batching front door: queue -> pad/bucket -> serve -> split.
    # ------------------------------------------------------------------

    def submit(self, x_query) -> int:
        """Queue one ragged query batch (a copy of it); returns its ticket,
        the batch's index in the list the next ``flush()`` /
        ``flush_async()`` returns.  With ``max_queue`` batches pending it
        first auto-flushes them through the pipeline (results held until
        the next explicit flush; tickets keep counting).  Serving-thread
        only."""
        with tracing.span("repro_torch.engine.submit"):
            shape = tuple(x_query.shape)
            if len(shape) != 2 or shape[1] != self.d:
                raise ValueError(
                    f"query batch must be (n, {self.d}); got {shape}")
            if len(self._queue) >= self.engine_cfg.max_queue:
                self._done.extend(self._flush_queue(pipelined=True))
            self._queue.append(_f32_copy(x_query, torch.device("cpu")))
            return len(self._done) + len(self._queue) - 1

    def _flush_queue(self, pipelined: bool) -> List[Tuple[Tensor, int]]:
        """Serve the pending queue micro-batched and split per ticket; one
        sweep = one captured ``(alpha, version)``."""
        if not self._queue:
            return []
        with tracing.span("repro_torch.engine.flush"):
            with tracing.span("repro_torch.engine.merge"):
                a_sv, version = self._capture_alpha()
                sizes = [int(b.shape[0]) for b in self._queue]
                merged = torch.cat(self._queue, dim=0)
                self._queue = []
                if pipelined:
                    merged = merged.numpy()
            if pipelined:
                self.async_flushes += 1
                f = self._predict_pipelined(merged, a_sv)
            else:
                f = self._predict(merged, a_sv)
            outs, start = [], 0
            for s in sizes:
                outs.append((f[start:start + s], version))
                start += s
            return outs

    def flush(self) -> List[Tensor]:
        """Serve every pending batch: one concatenation, one pad to
        ``query_block`` tiles, one serve sweep, split per ticket.  Results
        auto-flushed by ``submit`` come first, in submission order."""
        return [f for f, _ in self.flush_tagged()]

    def flush_async(self) -> List[Tensor]:
        """``flush()`` through the double-buffered pipeline; returns after
        the sweep's results are complete on the device."""
        return [f for f, _ in self.flush_async_tagged()]

    def flush_tagged(self) -> List[Tuple[Tensor, int]]:
        """``flush()`` with each result paired with the ``alpha_version``
        its sweep captured."""
        outs = self._done + self._flush_queue(pipelined=False)
        self._done = []
        return outs

    def flush_async_tagged(self) -> List[Tuple[Tensor, int]]:
        """``flush_async()`` with version tags (see ``flush_tagged``)."""
        outs = self._done + self._flush_queue(pipelined=True)
        self._done = []
        return outs

    @property
    def queued(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Serving geometry and counters; a fresh snapshot dict."""
        return {
            "n_train": self.n_train,
            "n_sv": self.n_sv,
            "n_sv_padded": self.n_sv_padded,
            "support_fraction": self.n_sv / max(self.n_train, 1),
            "sv_block": self.sv_block,
            "query_block": self.engine_cfg.query_block,
            "n_shards": self.n_shards,
            "sv_rows_per_shard": self.n_sv_padded // self.n_shards,
            "kernel": self.cfg.kernel,
            "impl": self.cfg.impl,
            "serve_calls": self.serve_calls,
            "async_flushes": self.async_flushes,
            "alpha_version": self.alpha_version,
            "cache": self.cache_info(),
        }


def engine_from_fit(cfg: DSEKLConfig, result, x_train, **kwargs
                    ) -> DSEKLPredictionEngine:
    """Build the engine from anything with ``.state.alpha`` (a fit result,
    JAX or port)."""
    return DSEKLPredictionEngine(cfg, result.state.alpha, x_train, **kwargs)
