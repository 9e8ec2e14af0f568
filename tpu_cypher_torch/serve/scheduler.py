"""Admission scheduling: padded-cost ordering, tenant fairness, deadlines.

The scheduler decides WHICH waiting query runs next and HOW MANY run at
once. It is the serving-layer face of the engine's existing admission
machinery:

* **cost ordering** — each query carries a padded-memory cost estimate
  (``estimate_cost_bytes``, delegating to the optimizer's cost model:
  statistics-fed per-hop fanout when the graph has them, the legacy scan
  rows x pattern fan-out proxy otherwise, rounded up the bucket lattice
  exactly like a real materialize would be). Cheap queries
  are never starved behind a giant analytical scan; among one tenant's
  waiters, the smallest padded footprint runs first.
* **per-tenant fairness** — the next slot goes to the waiting tenant with
  the fewest queries in flight (then cheapest, then FIFO), and
  ``TPU_CYPHER_SERVE_TENANT_QUOTA`` caps any one tenant's in-flight count
  outright, so one chatty client cannot monopolize the engine.
* **pre-flight budget admission** — before a query even queues, its padded
  estimate runs through the CUDA backend's ``bucketing.admit`` against the
  device-memory budget (``TPU_CYPHER_MEM_BUDGET``,
  ``bucketing.memory_budget_bytes``): a query that could never fit is
  rejected typed (``AdmissionRejected``) without occupying a slot.
* **deadline propagation** — a queued query's wall-clock deadline keeps
  ticking; expiry while waiting raises the same typed ``QueryTimeout`` the
  execution guard (``runtime/guard.py``) raises mid-query, and admitted
  queries carry the remaining budget into the guard via
  ``guard.request_deadline``.

Everything here runs on the event loop (no locks; the pool's worker
threads only ever execute engine code, never scheduler code).
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, List, Optional

from ..backend.cuda import bucketing
from ..errors import AdmissionRejected, QueryTimeout
from ..obs.metrics import REGISTRY as _REGISTRY

# serving-layer scheduler telemetry (docs/serving.md lists the names)
QUEUE_DEPTH = _REGISTRY.gauge(
    "tpu_cypher_serve_queue_depth", "queries waiting for an execution slot"
)
INFLIGHT = _REGISTRY.gauge(
    "tpu_cypher_serve_inflight", "queries currently holding a slot"
)
ADMITTED = _REGISTRY.counter(
    "tpu_cypher_serve_admitted_total", "queries granted an execution slot"
)
REJECTED = _REGISTRY.counter(
    "tpu_cypher_serve_rejected_total",
    "queries rejected before execution",
    labels=("reason",),
)
QUEUE_WAIT = _REGISTRY.histogram(
    "tpu_cypher_serve_queue_wait_seconds",
    "wall seconds between submission and slot grant",
)

_EST_BYTES_PER_ROW = 16  # id lane + validity/property lane, padded


def _graph_rows(g) -> int:
    """Largest element-table row count reachable from a relational graph
    (scan graphs directly; wrapper graphs through their members)."""
    scans = getattr(g, "scans", None)
    if scans is not None:
        return max((int(s.table.size) for s in scans), default=0)
    members = getattr(g, "members", None)
    if members:
        return sum(
            _graph_rows(getattr(m, "graph", m)) for m in members
        )
    inner = getattr(g, "graph", None)
    if inner is not None and inner is not g:
        return _graph_rows(inner)
    return 0


def estimate_cost_bytes(graph, query: str) -> int:
    """Padded-memory cost of a query, priced by the optimizer's cost
    model (``optimizer.cost.estimate_query_cost_bytes``): real per-hop
    fanout when the graph carries statistics, the legacy
    rows x (1 + relationship count) proxy otherwise — either way on the
    active bucket lattice at a nominal bytes-per-row. It only needs to
    ORDER queries (and trip the memory budget for the hopeless ones), not
    predict footprints; the real per-materialize admission still happens
    inside execution at every count sync."""
    base = getattr(graph, "_graph", graph)
    rows = _graph_rows(base)
    try:
        from ..optimizer.cost import estimate_query_cost_bytes

        return estimate_query_cost_bytes(
            base, query, fallback_rows=rows, bytes_per_row=_EST_BYTES_PER_ROW
        )
    except Exception as exc:
        from ..errors import reraise_if_device

        reraise_if_device(exc, site="serve.estimate")
    fanout = 1 + query.count("]")  # each -[..]- pattern closes one bracket
    est_rows = max(rows, 1) * max(fanout, 1)
    return bucketing.round_size(est_rows) * _EST_BYTES_PER_ROW


class _Waiter:
    __slots__ = ("cost", "tenant", "seq", "event")

    def __init__(self, cost: int, tenant: str, seq: int):
        self.cost = cost
        self.tenant = tenant
        self.seq = seq
        self.event = asyncio.Event()


class AdmissionScheduler:  # shared-by: loop
    """Bounded concurrency with cost-ordered, tenant-fair slot grants."""

    def __init__(
        self,
        max_concurrent: int,
        tenant_quota: int = 0,
        queue_high: int = 0,
    ):
        self.max_concurrent = max(int(max_concurrent), 1)
        self.tenant_quota = max(int(tenant_quota), 0)
        # overload shed watermark (TPU_CYPHER_SERVE_QUEUE_HIGH): a queue
        # already this deep rejects new arrivals typed BEFORE they queue —
        # bounded queues fail fast instead of accumulating doomed waiters
        self.queue_high = max(int(queue_high), 0)
        self._running = 0
        self._inflight: Dict[str, int] = {}
        self._waiters: List[_Waiter] = []
        self._seq = itertools.count()
        self._draining = False

    # -- introspection ---------------------------------------------------

    @property
    def queued(self) -> int:
        return len(self._waiters)

    @property
    def running(self) -> int:
        return self._running

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- drain -----------------------------------------------------------

    def begin_drain(self) -> None:
        """Flip to drain mode: every future ``acquire`` rejects typed
        (``AdmissionRejected`` reason=draining); queries already queued or
        running are unaffected and finish normally."""
        self._draining = True

    async def quiesce(self, timeout: float) -> None:
        """Wait (bounded) until nothing is running or queued. Polling is
        fine here: drain is a once-per-process-lifetime event and the poll
        period only bounds shutdown latency, not throughput."""
        deadline = time.monotonic() + max(float(timeout), 0.0)
        while self._running > 0 or self._waiters:
            if time.monotonic() >= deadline:
                return
            await asyncio.sleep(0.02)

    # -- the queue -------------------------------------------------------

    def _eligible(self, w: _Waiter) -> bool:
        if self.tenant_quota and self.inflight(w.tenant) >= self.tenant_quota:
            return False
        return True

    def _pump(self) -> None:
        """Grant free slots to the best eligible waiters: fewest-in-flight
        tenant first, then cheapest padded cost, then arrival order."""
        while self._running < self.max_concurrent:
            eligible = [w for w in self._waiters if self._eligible(w)]
            if not eligible:
                break
            best = min(
                eligible,
                key=lambda w: (self.inflight(w.tenant), w.cost, w.seq),
            )
            self._waiters.remove(best)
            self._grant(best.tenant)
            best.event.set()
        QUEUE_DEPTH.set(len(self._waiters))

    def _grant(self, tenant: str) -> None:
        self._running += 1
        self._inflight[tenant] = self.inflight(tenant) + 1
        INFLIGHT.set(self._running)
        ADMITTED.inc()

    async def acquire(
        self,
        cost_bytes: int,
        tenant: str = "default",
        deadline_at: Optional[float] = None,
    ) -> None:
        """Wait for an execution slot. Raises typed ``QueryTimeout`` when
        the query's deadline expires while still queued (the query never
        ran — no slot was consumed)."""
        t0 = time.monotonic()
        if self._draining:
            REJECTED.inc(reason="draining")
            raise AdmissionRejected(
                "server is draining: not accepting new queries",
                site="serve-admission",
            )
        if self.queue_high and len(self._waiters) >= self.queue_high:
            # overload shed: reject while the queue is at the watermark —
            # a fast typed failure beats a slow deadline expiry in queue
            REJECTED.inc(reason="shed")
            raise AdmissionRejected(
                f"admission queue at high watermark "
                f"({len(self._waiters)} >= {self.queue_high})",
                site="serve-admission",
            )
        if deadline_at is not None and t0 >= deadline_at:
            # already dead on arrival: never consumes a slot (the guard
            # could only catch this at the query's first sync site — a
            # plan with none would run to completion past its deadline)
            REJECTED.inc(reason="deadline")
            raise QueryTimeout(
                "query deadline expired before admission",
                site="serve-admission",
            )
        # fast path: a free slot and no quota conflict — skip the queue
        if (
            self._running < self.max_concurrent
            and not self._waiters
            and not (
                self.tenant_quota
                and self.inflight(tenant) >= self.tenant_quota
            )
        ):
            self._grant(tenant)
            QUEUE_WAIT.observe(0.0)
            return
        w = _Waiter(int(cost_bytes), tenant, next(self._seq))
        self._waiters.append(w)
        # pump immediately: a slot may be free even with a non-empty queue
        # (every queued waiter quota-blocked) — without this, an eligible
        # arrival would wait for the next release for no reason
        self._pump()
        try:
            if deadline_at is None:
                await w.event.wait()
            else:
                remaining = deadline_at - time.monotonic()
                granted = remaining > 0 and await _wait_bounded(
                    w.event, remaining
                )
                # a grant can land between the timeout firing and this
                # coroutine resuming (everything runs on one loop, but
                # release() may run in that gap) — honor it
                if not granted and not w.event.is_set():
                    REJECTED.inc(reason="deadline")
                    raise QueryTimeout(
                        "query deadline expired in the admission queue",
                        site="serve-admission",
                    )
        except asyncio.CancelledError:
            if w.event.is_set():
                # cancelled AFTER the grant: hand the slot straight back
                self.release(tenant)
            raise
        finally:
            if not w.event.is_set():
                # timed out or cancelled while queued: leave no ghost entry
                if w in self._waiters:
                    self._waiters.remove(w)
                QUEUE_DEPTH.set(len(self._waiters))
        QUEUE_WAIT.observe(time.monotonic() - t0)

    def release(self, tenant: str = "default") -> None:
        self._running -= 1
        n = self.inflight(tenant) - 1
        if n <= 0:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = n
        INFLIGHT.set(self._running)
        self._pump()


async def _wait_bounded(event: asyncio.Event, timeout: float) -> bool:
    try:
        await asyncio.wait_for(event.wait(), timeout)
        return True
    except asyncio.TimeoutError:
        return False


def preflight_admit(graph, query: str, tenant: str = "default") -> int:
    """Budget admission BEFORE queueing: estimate the padded cost and run
    it through ``bucketing.admit`` so a query that cannot fit the device
    memory budget is rejected typed without holding a slot. Returns the estimate
    (the scheduler's ordering key)."""
    cost = estimate_cost_bytes(graph, query)
    try:
        bucketing.admit(
            cost // _EST_BYTES_PER_ROW, _EST_BYTES_PER_ROW, site="serve-admission"
        )
    except Exception:
        REJECTED.inc(reason="budget")
        raise
    return cost
