"""Online train-to-serve loop: continuous learning under live traffic
(port of ``repro/serving/online.py``; DESIGN.md §11).

``OnlineService`` runs two halves in one process:

  * **one serving engine** (``DSEKLPredictionEngine``, keep-all) answering
    live ``submit`` / ``flush`` traffic through its tagged, double-buffered
    pipeline, and
  * **one background fit thread** running ``trainer.HostedPlan`` epochs
    over frozen, versioned snapshots of an appendable ``RingSource``.  On
    the card the thread queues its work on a CUDA stream of its own, so a
    live flush (on the serving thread's stream) never waits behind it.

At every epoch boundary:

  * **Publish** — the fresh alpha swaps into the live engine through
    ``update_alpha`` with a service-global version.  The swap is atomic
    against in-flight sweeps (each captures ``(alpha, version)`` once and
    its stream waits on the publish's event) and keeps every cached K tile
    valid.  Each version is logged with its staleness: how many appended
    events the training snapshot was behind at publish time.
  * **Rebuild** — only when the drift (events appended since the training
    snapshot) reaches ``rebuild_drift * n``: a new snapshot is frozen,
    alpha and accum are carried across by absolute event id (a snapshot
    covers ``[high_water - n, high_water)`` of the stream), and a new
    engine over the grown support set is built and warmed off the serving
    path, made device-complete, then flipped in under the serve lock.
    In-flight flushes complete on the old engine.
  * **Checkpoint** — ``CheckpointManager`` snapshots the whole resume
    closure (state, the generator state, the frozen snapshot's rows, the
    publish log), so a killed service resumed against a replayed event
    stream publishes the same model sequence.

The front door: ``submit(batch)`` takes a service-global ticket,
``flush()`` serves everything pending and returns ``OnlineResponse(ticket,
f, version)``, one per ticket, each tagged with the one alpha version that
served it.

Each epoch runs on a plan drawn from ``generator`` (a ``torch.Generator``)
on the snapshot it trains, or on ``plan_fn(epoch, n)`` when given: how the
tests replay the JAX package's ``jax.random.split`` chain.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
from repro_torch.core.trainer import HostedPlan
from repro_torch.data.source import RingSnapshot, RingSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.dsekl_engine import (DSEKLPredictionEngine,
                                              EngineConfig)

Tensor = torch.Tensor


def _host_rows(x) -> np.ndarray:
    """A query batch (tensor or array) as a float32 host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class OnlineResponse:
    """One served query batch: its ticket, scores (on the service's
    device) and the service-global alpha version that produced them."""
    ticket: int
    f: Tensor
    version: int


class OnlineService:
    """A live DSEKL model: serving and training share one process.

    >>> ring = RingSource(capacity, d); ring.append(x0, y0)
    >>> svc = OnlineService(cfg, ring, generator=g, max_epochs=20)
    >>> svc.start()
    >>> t = svc.submit(batch)          # any thread
    >>> [resp] = svc.flush()           # resp.version tags the model
    >>> svc.append(x_new, y_new)       # labeled events keep arriving
    >>> svc.stop()

    ``ingest_hook(service, epoch)``, called on the fit thread right before
    each epoch, is the deterministic event feed the tests and the launcher
    use (feeding by epoch number makes the published model sequence
    replayable for kill-and-resume); live traffic can ``append`` at any
    time instead.  ``record_models=True`` keeps a host copy of every
    published ``(alpha, snapshot)`` by version: the offline oracle.
    ``train_nice=N`` (Linux) runs the fit thread N nice levels below the
    serving threads.  The state and the engines live on ``device``
    (default ``cuda``, which raises without a card)."""

    def __init__(self, cfg: DSEKLConfig, source: RingSource, *,
                 generator: Optional[torch.Generator] = None,
                 plan_fn: Optional[Callable[[int, int], Any]] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 algorithm: str = "serial", prefetch: bool = True,
                 publish_every: int = 1,
                 rebuild_drift: Optional[float] = 0.5,
                 max_epochs: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 3,
                 resume: bool = False, record_models: bool = False,
                 train_nice: Optional[int] = None,
                 ingest_hook: Optional[
                     Callable[["OnlineService", int], None]] = None,
                 device: DeviceLike = None):
        if source.n == 0:
            raise ValueError("the ring is empty: append (or prefill) at "
                             "least one labeled event before serving")
        if generator is None and plan_fn is None:
            raise TypeError("OnlineService needs a torch.Generator (or a "
                            "plan_fn giving each epoch's index plan)")
        self.cfg = cfg
        self.source = source
        self.device = resolve_device(device)
        self._gen = generator
        self._plan_fn = plan_fn
        self._algorithm = algorithm
        self._prefetch = prefetch
        self._publish_every = max(int(publish_every), 1)
        self._rebuild_drift = rebuild_drift
        self._max_epochs = max_epochs
        self._checkpoint_every = max(int(checkpoint_every), 1)
        self._record_models = bool(record_models)
        self._train_nice = train_nice
        self._ingest_hook = ingest_hook
        ec = engine_cfg if engine_cfg is not None else EngineConfig(
            query_block=256)
        # The live engine must stay keep-all: update_alpha every epoch.
        self._engine_cfg = dataclasses.replace(ec, truncate_tol=-1.0)

        # Cache admission re-applied to every engine (re)build, so
        # per-tenant quotas survive the drift-gated flip.
        self._cache_owner: Optional[str] = None
        self._cache_quotas: Dict[str, Optional[int]] = {}

        self._manager = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            self._manager = CheckpointManager(checkpoint_dir,
                                              keep=checkpoint_keep)

        # --- the resume closure: state, generator, epoch, version,
        # snapshot and publish log.
        self.publish_log: List[Dict[str, Any]] = []
        self.version = 0
        self.epoch = 0
        flat = None
        if resume and self._manager is not None:
            step = self._manager.latest_valid_step()
            if step is not None:
                _, flat, extra = self._manager.restore(step)
                self._restore(flat, extra)
        if flat is None:
            self._snap = source.snapshot()
        self._plan = self._make_plan(self._snap)
        self._state = (self._plan.init_state() if flat is None
                       else self._plan.place_state(flat))
        self._last_ckpt_epoch: Optional[int] = (None if flat is None
                                                else self.epoch)
        self._engine = self._build_engine(self._snap, self._state.alpha,
                                          self.version)

        # The serving front door.
        self._serve_lock = threading.Lock()    # serializes flush + flip
        self._front_lock = threading.Lock()    # ticket counter + pending
        self._pending: List[Tuple[int, np.ndarray]] = []
        self._next_ticket = 0

        self._models: Dict[int, Tuple[np.ndarray, RingSnapshot]] = {}
        if self._record_models:
            self._models[self.version] = (
                self._state.alpha.cpu().numpy().copy(), self._snap)

        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.error: Optional[BaseException] = None
        self.rebuilds = 0
        # The wall of each epoch the fit thread ran, its device work
        # included (the steps follow from the publish log's n).
        self.epoch_seconds: List[float] = []

    def _restore(self, flat: Dict[str, np.ndarray],
                 extra: Dict[str, Any]) -> None:
        """The snapshot, generator, counters and log of a checkpoint (its
        state is placed by the plan)."""
        self._snap = RingSnapshot(
            np.asarray(flat["snap_x"], np.float32),
            np.asarray(flat["snap_y"], np.float32),
            version=0, high_water=int(extra["snapshot_hw"]))
        gen_state = np.asarray(flat.get("gen_state",
                                        np.zeros((0,), np.uint8)))
        if self._gen is not None and gen_state.size:
            self._gen.set_state(torch.from_numpy(gen_state.astype(np.uint8)))
        self.epoch = int(extra["epoch"])
        self.version = int(extra["version"])
        self.publish_log = list(extra["publish_log"])

    # ------------------------------------------------------------------
    # Engine and plan lifecycle.
    # ------------------------------------------------------------------

    def _build_engine(self, snap: RingSnapshot, alpha,
                      version: int) -> DSEKLPredictionEngine:
        eng = DSEKLPredictionEngine(
            self.cfg, alpha, snap.gather_x(slice(None)),
            engine_cfg=self._engine_cfg, device=self.device,
            alpha_version=version)
        for owner, quota in self._cache_quotas.items():
            eng.set_cache_quota(owner, quota)
        return eng

    def _make_plan(self, snap: RingSnapshot) -> HostedPlan:
        return HostedPlan(self.cfg, snap, algorithm=self._algorithm,
                          prefetch=self._prefetch, device=self.device)

    def _sync(self) -> None:
        """Wait for the work this thread queued on its current stream."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @property
    def engine_cfg(self) -> EngineConfig:
        """The (keep-all) ``EngineConfig`` every engine build uses."""
        return self._engine_cfg

    # ------------------------------------------------------------------
    # The serving front door (thread-safe).
    # ------------------------------------------------------------------

    def submit(self, x_query) -> int:
        """Queue one query batch; returns a service-global ticket.

        Thread-safe and non-blocking: takes only the front-door lock, so
        a submit never waits behind a serve sweep, an engine flip or an
        epoch."""
        x = _host_rows(x_query)
        if x.ndim != 2 or x.shape[1] != self.source.d:
            raise ValueError(
                f"query batch must be (n, {self.source.d}); got {x.shape}")
        with self._front_lock:
            t = self._next_ticket
            self._next_ticket += 1
            self._pending.append((t, x))
        return t

    def flush(self) -> List[OnlineResponse]:
        """Serve everything pending through the engine's tagged pipeline:
        one response per ticket, each tagged with the one alpha version
        its sweep captured.  A publish or an engine flip lands between
        sweeps, never inside one.

        Thread-safe and blocking: the sweep runs inline and returns when
        its results are complete on the device.  Concurrent flushes (and
        flips) serialize on the serve lock; each pending batch is served
        once, by whichever flush drains it."""
        with self._serve_lock:
            with self._front_lock:
                pending, self._pending = self._pending, []
            if not pending:
                return []
            eng = self._engine
            # Under the serve lock, so the attribution lands on the engine
            # this sweep runs on (a rebuild may have flipped it since
            # set_cache_owner was called).
            eng.set_cache_owner(self._cache_owner)
            for _, batch in pending:
                eng.submit(batch)
            pairs = eng.flush_async_tagged()
        return [OnlineResponse(t, f, v)
                for (t, _), (f, v) in zip(pending, pairs)]

    def append(self, x_rows, y_rows) -> int:
        """Feed labeled events into the ring (any thread); returns the
        stream's new high-water mark.  Non-blocking: the ring has its own
        lock."""
        return self.source.append(x_rows, y_rows)

    # ------------------------------------------------------------------
    # Cache admission (the tenancy front door's hooks, DESIGN.md §12).
    # ------------------------------------------------------------------

    def set_cache_owner(self, owner: Optional[str]) -> None:
        """Attribute later sweeps' kernel-tile cache traffic to ``owner``
        (``None``: unattributed).  Recorded here and applied to the live
        engine at the start of each ``flush`` sweep, under the serve lock,
        so it survives engine flips."""
        self._cache_owner = owner

    def set_cache_quota(self, owner: str, quota: Optional[int]) -> None:
        """Bound ``owner``'s resident kernel-map tiles (``0``: bypass the
        cache, ``None``: no bound); see
        ``DSEKLPredictionEngine.set_cache_quota``.  Recorded on the
        service and re-applied to every rebuilt engine.  Takes the serve
        lock briefly."""
        self._cache_quotas[owner] = quota
        with self._serve_lock:
            self._engine.set_cache_quota(owner, quota)

    def cache_info(self) -> Dict[str, Any]:
        """The live engine's kernel-tile cache counters, per owner
        included: a fresh snapshot (a rebuild starts a fresh cache, so the
        counters reset at each flip).  Takes the serve lock briefly."""
        with self._serve_lock:
            return self._engine.cache_info()

    # ------------------------------------------------------------------
    # The epoch boundary: publish / rebuild / checkpoint (fit thread).
    # ------------------------------------------------------------------

    def _log_entry(self, kind: str, version: int, alpha_host: np.ndarray,
                   snap: RingSnapshot) -> Dict[str, Any]:
        return {"version": version, "epoch": int(self.epoch), "kind": kind,
                "alpha_crc": int(zlib.crc32(alpha_host.tobytes())),
                "staleness": int(self.source.total - snap.high_water),
                "snapshot_hw": int(snap.high_water), "n": int(snap.n)}

    def _publish(self, kind: str) -> None:
        alpha_host = self._state.alpha.cpu().numpy()
        self.version += 1
        v = self.version
        if kind == "swap":
            # Zero downtime: the geometry is unchanged, cached K tiles
            # stay valid, in-flight sweeps finish on the alpha they
            # captured.
            self._engine.update_alpha(self._state.alpha, version=v)
        self.publish_log.append(self._log_entry(kind, v, alpha_host,
                                                self._snap))
        if self._record_models:
            self._models[v] = (alpha_host.copy(), self._snap)

    def _carry_state(self, old: RingSnapshot, new: RingSnapshot,
                     state: DSEKLState) -> DSEKLState:
        """Carry alpha and accum across a snapshot change by absolute event
        id: rows in both windows keep their values, new rows start at the
        init values (alpha 0, accum 1)."""
        alpha = torch.zeros((new.n,), dtype=torch.float32,
                            device=self.device)
        accum = torch.ones((new.n,), dtype=torch.float32, device=self.device)
        lo = max(old.base, new.base)
        hi = min(old.high_water, new.high_water)
        if hi > lo:
            alpha[lo - new.base: hi - new.base] = \
                state.alpha[lo - old.base: hi - old.base]
            accum[lo - new.base: hi - new.base] = \
                state.accum[lo - old.base: hi - old.base]
        return DSEKLState(alpha=alpha, accum=accum, step=state.step,
                          epoch=state.epoch)

    def _maybe_rebuild(self) -> None:
        """Re-cut the support set to the current window, when the drift
        says the serving model is too far behind the stream.  The new
        engine is built, warmed and made device-complete off the serving
        path; only the pointer flip holds the serve lock."""
        if self._rebuild_drift is None:
            return
        drift = self.source.total - self._snap.high_water
        if drift < self._rebuild_drift * max(self._snap.n, 1):
            return
        new_snap = self.source.snapshot()
        if new_snap.high_water == self._snap.high_water:
            return
        self._state = self._carry_state(self._snap, new_snap, self._state)
        self.version += 1
        v = self.version
        engine = self._build_engine(new_snap, self._state.alpha, v)
        # Warm the serve function off the serving path, past the tile
        # cache (a tile cached here would live in this stream's pool), and
        # finish every copy the build queued on this thread's stream before
        # serving threads see it.
        engine.warm()
        self._sync()
        with self._serve_lock:
            self._engine = engine              # the double-buffered flip
        self._plan.close()
        self._plan = self._make_plan(new_snap)
        old_snap, self._snap = self._snap, new_snap
        self.rebuilds += 1
        alpha_host = self._state.alpha.cpu().numpy()
        entry = self._log_entry("rebuild", v, alpha_host, new_snap)
        entry["grew"] = int(new_snap.high_water - old_snap.high_water)
        self.publish_log.append(entry)
        if self._record_models:
            self._models[v] = (alpha_host.copy(), new_snap)

    def _checkpoint(self) -> None:
        if self._manager is None or self._last_ckpt_epoch == self.epoch:
            return
        sx, sy = self._snap.gather(slice(None))
        gen_state = (self._gen.get_state().numpy().copy()
                     if self._gen is not None else np.zeros((0,), np.uint8))
        tree = {"alpha": self._state.alpha, "accum": self._state.accum,
                "step": self._state.step, "epoch": self._state.epoch,
                "gen_state": gen_state, "snap_x": sx, "snap_y": sy}
        extra = {"epoch": int(self.epoch), "version": int(self.version),
                 "snapshot_hw": int(self._snap.high_water),
                 "publish_log": self.publish_log}
        self._manager.save(self.epoch, tree, extra=extra)
        self._last_ckpt_epoch = self.epoch

    # ------------------------------------------------------------------
    # The background fit loop.
    # ------------------------------------------------------------------

    def _deprioritize(self) -> None:
        """Run the fit thread at a lower scheduler priority (Linux
        per-thread nice through the native thread id), so that a flush
        landing mid-epoch preempts training.  A no-op where unsupported."""
        if not self._train_nice:
            return
        try:
            import os
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                           int(self._train_nice))
        except (OSError, AttributeError):
            pass

    def _next_plan(self):
        """This epoch's index plan, on the snapshot it trains (a rebuild
        changes n)."""
        if self._plan_fn is not None:
            return self._plan_fn(self.epoch, self._snap.n)
        return self._plan.draw_plan(self._gen)

    def _run(self) -> None:
        self._deprioritize()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            try:
                while not self._stop_evt.is_set():
                    if self._max_epochs is not None \
                            and self.epoch >= self._max_epochs:
                        break
                    if self._ingest_hook is not None:
                        self._ingest_hook(self, self.epoch)
                    self._maybe_rebuild()
                    plan = self._next_plan()
                    t0 = time.perf_counter()
                    self._plan.plan_epoch(plan)
                    self._state = self._plan.run_epoch(self._state, plan)
                    self._sync()
                    self.epoch_seconds.append(time.perf_counter() - t0)
                    self.epoch += 1
                    if self.epoch % self._publish_every == 0:
                        self._publish("swap")
                    if self.epoch % self._checkpoint_every == 0:
                        self._checkpoint()
            except BaseException as e:        # surfaced via .error / stop()
                self.error = e
            finally:
                try:
                    if self.error is None:
                        self._checkpoint()
                        if self._manager is not None:
                            self._manager.wait()
                except BaseException as e:
                    self.error = e
                self._plan.close()

    def start(self) -> "OnlineService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dsekl-online-fit")
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the fit thread to finish (``max_epochs`` reached or
        ``stop()`` asked)."""
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        """Stop training (the final checkpoint is written) and keep
        serving: ``flush`` stays valid on the last published model."""
        self._stop_evt.set()
        self.join()

    def __enter__(self) -> "OnlineService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    def published(self, version: int) -> Tuple[np.ndarray, RingSnapshot]:
        """The recorded ``(alpha, snapshot)`` of a version
        (``record_models=True``): the offline oracle."""
        return self._models[version]

    def stats(self) -> Dict[str, Any]:
        """Service and live-engine counters: a fresh snapshot (every
        nested dict is built at call time).  Non-blocking; the values are
        coherent field by field, not across fields."""
        log = self.publish_log
        return {
            "epoch": self.epoch,
            "version": self.version,
            "publishes": len(log),
            "rebuilds": self.rebuilds,
            "stream_total": int(self.source.total),
            "snapshot_hw": int(self._snap.high_water),
            "staleness_mean": (float(np.mean([r["staleness"] for r in log]))
                               if log else 0.0),
            "staleness_max": (max(r["staleness"] for r in log) if log
                              else 0),
            "engine": self._engine.stats(),
        }

