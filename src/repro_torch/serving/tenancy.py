"""Multi-tenant serving QoS: one shared engine, many isolated callers
(port of ``repro/serving/tenancy.py``; DESIGN.md §12).

Many tenants share one ``DSEKLPredictionEngine`` or ``OnlineService``.
Left alone, a shared engine lets one tenant's burst take every serve
sweep, turns overload into everyone's latency through an unbounded queue,
and lets a tenant of unique queries churn the shared kernel-map tile
cache.  ``TenantFrontDoor`` puts three mechanisms in front of the engine:

  * **Weighted fair scheduling** — per-tenant submit queues drained by
    deficit round-robin in quanta of ``quantum_rows * weight`` rows: each
    ``pump()`` serves ONE tenant's drain of about one tile, rotating
    tenants with a carried deficit, so weights hold over time and a queued
    burst never takes more than its share of consecutive sweeps.
  * **Admission control and load shedding** — per-tenant budgets on
    outstanding tickets and queued rows; an over-budget ``submit`` returns
    a typed ``ShedResponse`` at once (O(1), no engine work).
  * **Cache admission** — per-tenant residency quotas on the engine's
    kernel-map tile cache (``set_cache_quota``): a tenant over its quota
    evicts its own least-recently-used tile, and a ``quota = 0`` tenant
    bypasses the cache.  ``cache_info()["owners"]`` reports per-tenant
    counters.

``QoSConfig(enabled=False)`` is the un-isolated baseline (global FIFO
drains, no shedding, no cache attribution), the A/B arm.

Thread safety: ``submit`` is safe from any thread and never blocks on
serving (it takes the bookkeeping lock only).  ``pump`` / ``flush``
serialize behind a serve lock.  ``stats()`` returns a fresh snapshot.
The front door must be the backend's only client: it serializes every
engine call, which the bare engine requires.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.serving.dsekl_engine import DSEKLPredictionEngine
from repro_torch.serving.online import OnlineService, _host_rows


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant QoS contract (static; one per registered tenant).

    ``weight`` scales the tenant's deficit-round-robin quantum — a
    weight-2 tenant drains twice the rows per rotation of a weight-1
    tenant when both are backlogged.  ``max_tickets`` bounds outstanding
    (submitted, not yet served) tickets and ``max_queued_rows`` bounds
    queued query rows; a submit that would exceed either is shed.
    ``cache_quota`` pins the tenant's kernel-map tile residency
    (``None`` = unquota'd, ``0`` = never cache — see
    ``DSEKLPredictionEngine.set_cache_quota``)."""
    weight: float = 1.0
    max_tickets: int = 64
    max_queued_rows: int = 65_536
    cache_quota: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Front-door scheduling/shedding policy.

    ``enabled=False`` is the no-isolation baseline: drains are global
    FIFO over arrival order, admission control is off (nothing is ever
    shed), and cache traffic is unattributed.  ``quantum_rows=0``
    defaults the DRR quantum to the backend's ``query_block`` — one
    drain ≈ one compiled serve tile.  ``shed=False`` keeps fair
    scheduling but disables admission control."""
    enabled: bool = True
    quantum_rows: int = 0
    shed: bool = True


@dataclasses.dataclass(frozen=True)
class ShedResponse:
    """Typed fast-rejection of an over-budget ``submit``.

    ``reason`` is ``"tickets"`` (outstanding-ticket budget) or
    ``"queue_rows"`` (queued-row budget); ``occupancy``/``budget`` are
    the limiting counter at rejection time and its configured bound,
    ``rows`` the size of the rejected batch.  No ticket is issued and no
    engine work happens — shedding is O(1) under the bookkeeping lock."""
    tenant: str
    reason: str
    occupancy: int
    budget: int
    rows: int


@dataclasses.dataclass
class TenantResponse:
    """One served batch: owning tenant, its ticket, scores, and the
    alpha version (backend-tagged) that produced them."""
    tenant: str
    ticket: int
    f: Any
    version: int


class _EngineBackend:
    """Adapter: drive a bare ``DSEKLPredictionEngine`` (fixed model)."""

    def __init__(self, engine: DSEKLPredictionEngine):
        self.engine = engine
        self.d = engine.d

    def set_cache_owner(self, owner: Optional[str]) -> None:
        self.engine.set_cache_owner(owner)

    def set_cache_quota(self, owner: str, quota: Optional[int]) -> None:
        self.engine.set_cache_quota(owner, quota)

    def serve(self, batches: List[np.ndarray]) -> List[Tuple[Any, int]]:
        for b in batches:
            self.engine.submit(b)
        return self.engine.flush_async_tagged()

    def cache_info(self) -> dict:
        return self.engine.cache_info()

    def stats(self) -> dict:
        return self.engine.stats()


class _ServiceBackend:
    """Adapter: drive an ``OnlineService`` (model keeps training; engine
    rebuilds flip underneath — versions tag every response)."""

    def __init__(self, service: OnlineService):
        self.service = service
        self.d = service.source.d

    def set_cache_owner(self, owner: Optional[str]) -> None:
        self.service.set_cache_owner(owner)

    def set_cache_quota(self, owner: str, quota: Optional[int]) -> None:
        self.service.set_cache_quota(owner, quota)

    def serve(self, batches: List[np.ndarray]) -> List[Tuple[Any, int]]:
        for b in batches:
            self.service.submit(b)
        return [(r.f, r.version) for r in self.service.flush()]

    def cache_info(self) -> dict:
        return self.service.cache_info()

    def stats(self) -> dict:
        return self.service.stats()


class _Tenant:
    __slots__ = ("name", "cfg", "queue", "rows", "deficit", "submitted",
                 "served_batches", "served_rows", "shed_tickets",
                 "shed_queue_rows", "shed_rows")

    def __init__(self, name: str, cfg: TenantConfig):
        self.name = name
        self.cfg = cfg
        self.queue: Deque[Tuple[int, np.ndarray]] = deque()
        self.rows = 0                       # queued rows right now
        self.deficit = 0.0                  # DRR carry, in rows
        self.submitted = 0
        self.served_batches = 0
        self.served_rows = 0
        self.shed_tickets = 0               # sheds for reason "tickets"
        self.shed_queue_rows = 0            # sheds for reason "queue_rows"
        self.shed_rows = 0                  # total rows rejected


class TenantFrontDoor:
    """Multi-tenant QoS front door over ONE shared serving backend.

    >>> fd = TenantFrontDoor(engine, {"a": TenantConfig(),
    ...                               "b": TenantConfig(weight=2.0)})
    >>> t = fd.submit("a", batch)          # int ticket, or ShedResponse
    >>> fd.pump()                          # serve ONE fair-share drain
    >>> fd.flush()                         # pump until all queues empty

    The backend is a ``DSEKLPredictionEngine`` or an ``OnlineService``;
    the front door must be its only client.  ``submit`` never blocks on
    serving; ``pump``/``flush`` serialize sweeps behind the serve lock.
    """

    def __init__(self, backend, tenants: Dict[str, TenantConfig],
                 qos: QoSConfig = QoSConfig()):
        if isinstance(backend, OnlineService):
            self._backend = _ServiceBackend(backend)
            query_block = backend.engine_cfg.query_block
        elif isinstance(backend, DSEKLPredictionEngine):
            self._backend = _EngineBackend(backend)
            query_block = backend.engine_cfg.query_block
        else:
            raise TypeError(
                "backend must be a DSEKLPredictionEngine or an "
                f"OnlineService; got {type(backend).__name__}")
        if not tenants:
            raise ValueError("register at least one tenant")
        for name, cfg in tenants.items():
            if cfg.weight <= 0:
                raise ValueError(f"tenant {name!r}: weight must be > 0 "
                                 "(DRR progress requires positive credit)")
            if cfg.max_tickets < 1 or cfg.max_queued_rows < 1:
                raise ValueError(f"tenant {name!r}: budgets must be >= 1")
        self.qos = qos
        self.quantum_rows = (qos.quantum_rows if qos.quantum_rows > 0
                             else query_block)
        self._tenants: Dict[str, _Tenant] = {
            name: _Tenant(name, cfg) for name, cfg in tenants.items()}
        self._order = list(self._tenants)   # DRR rotation order
        self._rr = 0
        self._fifo: Deque[str] = deque()    # arrival order (QoS-off mode)
        self._lock = threading.Lock()       # queues + tickets + counters
        self._serve_lock = threading.Lock()  # one sweep at a time
        self._next_ticket = 0
        self.pumps = 0
        if qos.enabled:
            for name, cfg in tenants.items():
                if cfg.cache_quota is not None:
                    self._backend.set_cache_quota(name, cfg.cache_quota)

    # ------------------------------------------------------------------
    # Admission (any thread; O(1), never blocks on serving).
    # ------------------------------------------------------------------

    def submit(self, tenant: str,
               x_query) -> Union[int, ShedResponse]:
        """Queue one query batch for ``tenant``.

        Returns a front-door-global ticket, or — when QoS shedding is on
        and the tenant is over an admission budget — a ``ShedResponse``
        describing which budget rejected it.  Thread-safe; takes only
        the bookkeeping lock, so a submit never waits behind an
        in-flight serve sweep."""
        t = self._tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}; registered: "
                           f"{sorted(self._tenants)}")
        x = _host_rows(x_query)
        if x.ndim != 2 or x.shape[1] != self._backend.d:
            raise ValueError(
                f"query batch must be (n, {self._backend.d}); "
                f"got {x.shape}")
        rows = int(x.shape[0])
        with self._lock:
            if self.qos.enabled and self.qos.shed:
                if len(t.queue) >= t.cfg.max_tickets:
                    t.shed_tickets += 1
                    t.shed_rows += rows
                    return ShedResponse(tenant, "tickets", len(t.queue),
                                        t.cfg.max_tickets, rows)
                if t.rows + rows > t.cfg.max_queued_rows:
                    t.shed_queue_rows += 1
                    t.shed_rows += rows
                    return ShedResponse(tenant, "queue_rows", t.rows,
                                        t.cfg.max_queued_rows, rows)
            ticket = self._next_ticket
            self._next_ticket += 1
            t.queue.append((ticket, x))
            t.rows += rows
            t.submitted += 1
            if not self.qos.enabled:
                self._fifo.append(tenant)
        return ticket

    # ------------------------------------------------------------------
    # Scheduling: one drain per pump.
    # ------------------------------------------------------------------

    def _drain_drr_locked(self) -> List[Tuple[str, int, np.ndarray]]:
        """Deficit round-robin: rotate tenants, crediting each visited
        non-empty queue ``quantum_rows * weight`` rows of deficit and
        draining whole batches while the deficit covers them.  The first
        tenant that drains anything ends the pump — one drain ≈ one
        tenant's ~one-tile share of the sweep.  A batch larger than one
        quantum accrues deficit across rotations until it fits, so big
        batches are served late but never starved."""
        while any(t.queue for t in self._tenants.values()):
            t = self._tenants[self._order[self._rr]]
            self._rr = (self._rr + 1) % len(self._order)
            if not t.queue:
                t.deficit = 0.0             # no credit hoarding while idle
                continue
            t.deficit += self.quantum_rows * t.cfg.weight
            out: List[Tuple[str, int, np.ndarray]] = []
            while t.queue and t.queue[0][1].shape[0] <= t.deficit:
                ticket, b = t.queue.popleft()
                t.deficit -= b.shape[0]
                t.rows -= int(b.shape[0])
                out.append((t.name, ticket, b))
            if not t.queue:
                t.deficit = 0.0
            if out:
                return out
        return []

    def _drain_fifo_locked(self) -> List[Tuple[str, int, np.ndarray]]:
        """The QoS-off baseline: drain globally-oldest batches up to one
        quantum of rows (at least one batch), regardless of tenant —
        arrival order is the only order, so a queued burst is served to
        completion ahead of everything that arrived behind it."""
        out: List[Tuple[str, int, np.ndarray]] = []
        rows = 0
        while self._fifo:
            t = self._tenants[self._fifo[0]]
            head_rows = int(t.queue[0][1].shape[0])
            if out and rows + head_rows > self.quantum_rows:
                break
            self._fifo.popleft()
            ticket, b = t.queue.popleft()
            t.rows -= head_rows
            rows += head_rows
            out.append((t.name, ticket, b))
        return out

    def pump(self) -> List[TenantResponse]:
        """Serve ONE drain (≈ one ``query_block`` quantum) through the
        backend and return its responses.

        QoS on: the drain is one tenant's deficit-round-robin share, and
        the backend's cache traffic is attributed to that tenant.  QoS
        off: the drain is the globally oldest quantum of batches.
        Returns ``[]`` when nothing is queued.  Blocking: runs a full
        backend sweep inline; concurrent pumps serialize on the serve
        lock."""
        with self._serve_lock:
            with self._lock:
                drained = (self._drain_drr_locked() if self.qos.enabled
                           else self._drain_fifo_locked())
            if not drained:
                return []
            owners = {name for name, _, _ in drained}
            self._backend.set_cache_owner(
                next(iter(owners)) if self.qos.enabled and len(owners) == 1
                else None)
            pairs = self._backend.serve([b for _, _, b in drained])
            self.pumps += 1
            responses = [
                TenantResponse(name, ticket, f, version)
                for (name, ticket, b), (f, version) in zip(drained, pairs)]
            with self._lock:
                for name, _, b in drained:
                    t = self._tenants[name]
                    t.served_batches += 1
                    t.served_rows += int(b.shape[0])
            return responses

    def flush(self) -> List[TenantResponse]:
        """Pump until every tenant queue is empty; returns all responses
        produced, in drain order.  Blocking: as many backend sweeps as
        drains remain.  Note that per-response latency structure comes
        from calling ``pump`` directly — ``flush`` is the convenience
        drain-everything form."""
        out: List[TenantResponse] = []
        while True:
            got = self.pump()
            if not got:
                return out
            out.extend(got)

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    @property
    def pending(self) -> int:
        """Queued (unserved) batches across all tenants right now."""
        with self._lock:
            return sum(len(t.queue) for t in self._tenants.values())

    def cache_info(self) -> dict:
        """The backend's cache snapshot (per-owner counters included);
        an immutable copy, like the backend's own ``cache_info``."""
        return self._backend.cache_info()

    def stats(self) -> dict:
        """Per-tenant admission/scheduling counters plus the backend
        snapshot.  Immutable snapshot: every dict (nested included) is
        built fresh at call time — mutate freely, later traffic never
        shows up in it."""
        with self._lock:
            tenants = {
                t.name: {
                    "weight": t.cfg.weight,
                    "submitted": t.submitted,
                    "served_batches": t.served_batches,
                    "served_rows": t.served_rows,
                    "queued_batches": len(t.queue),
                    "queued_rows": t.rows,
                    "deficit": t.deficit,
                    "shed": {"tickets": t.shed_tickets,
                             "queue_rows": t.shed_queue_rows,
                             "rows": t.shed_rows},
                    "shed_rate": (
                        (t.shed_tickets + t.shed_queue_rows)
                        / max(t.submitted + t.shed_tickets
                              + t.shed_queue_rows, 1)),
                } for t in self._tenants.values()}
            pumps = self.pumps
        return {
            "qos": {"enabled": self.qos.enabled, "shed": self.qos.shed,
                    "quantum_rows": self.quantum_rows},
            "pumps": pumps,
            "tenants": tenants,
            "backend": self._backend.stats(),
        }
