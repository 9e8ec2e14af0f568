"""Request routing: tenant affinity, replica retry, hedged dispatch.

The router turns ONE client query into however many worker attempts it
takes to answer it, without the client ever noticing:

* **tenant-affine pick** — a tenant hashes to a stable position over the
  currently-available workers (stable hash, not ``hash()``: Python's
  string hash is salted per process and per-tenant affinity must survive
  restarts). Affinity keeps a tenant's plan-cache locality inside one
  worker; availability is re-evaluated per attempt, so affinity BENDS
  under failure instead of breaking.

* **replica retry** — reads run against immutable snapshots, so a
  ``WorkerLost`` mid-query is safely retryable on a surviving replica.
  Writes retry too: a batch the dying worker committed is replayed from
  the shared WAL by the next writer, and the retried statement simply
  re-executes there (phrase writes as MERGE for exactly-once under
  retry — docs/mutation.md). Each failed attempt is stamped into the
  client-visible
  ``execution_log`` as rung ``"replica"`` (``guard.RUNG_REPLICA``) —
  transparent recovery stays auditable in the same log as the in-process
  ``device`` attempt. Retries deliberately DROP the request's fault schedule:
  an injected schedule died with the worker it killed, and replaying it
  would deterministically kill every replica in turn.

* **hedged dispatch** — with ``TPU_CYPHER_SERVE_HEDGE_MS`` set, a read
  still unanswered after the delay is duplicated to a second replica and
  the first reply wins (the tail-latency trade from "The Tail at Scale":
  pay one duplicate execute to cut p99). Hedging is skipped for faulted
  requests — a chaos schedule must fire exactly once — and for writes,
  which would otherwise execute twice by design. Writes also skip the
  tenant hash: they pin to the first ready worker in stable id order
  (the single-writer discipline; see ``_pick``).

The router never talks to a breaker directly beyond ``allow()`` — failure
accounting flows through ``Supervisor.note_failure`` so process-death
handling lives in one place.
"""

from __future__ import annotations

import asyncio
import time
import zlib
from typing import Any, Dict, List, Optional

from .. import errors as ERR
from ..obs.metrics import REGISTRY as _REGISTRY
from ..runtime import guard as G
from ..utils.config import SERVE_HEDGE_MS, SERVE_RETRY_MAX
from . import wire
from .supervisor import Supervisor, WorkerHandle

REPLICA_RETRIES = _REGISTRY.counter(
    "tpu_cypher_serve_replica_retries_total",
    "read queries re-dispatched to a surviving replica after WorkerLost",
)
HEDGES = _REGISTRY.counter(
    "tpu_cypher_serve_hedges_total",
    "hedged duplicate dispatches, by which attempt won",
    labels=("winner",),
)


class Router:  # shared-by: loop
    """Fans client queries out to the supervisor's ready workers."""

    def __init__(
        self,
        supervisor: Supervisor,
        retry_max: Optional[int] = None,
        hedge_ms: Optional[float] = None,
        ready_wait_s: float = 10.0,
    ):
        self.supervisor = supervisor
        self.retry_max = int(
            retry_max if retry_max is not None else SERVE_RETRY_MAX.get()
        )
        self.hedge_ms = float(
            hedge_ms if hedge_ms is not None else SERVE_HEDGE_MS.get()
        )
        # how long a retry attempt will wait out a momentarily-empty fleet
        # (every worker down at once) before failing typed — a supervisor
        # restart is usually seconds away, and absorbing it here turns a
        # correlated double-death into latency instead of an error
        self.ready_wait_s = float(ready_wait_s)

    # -- worker selection ------------------------------------------------

    def _pick(
        self, tenant: str, exclude: Optional[set] = None, *,
        write: bool = False,
    ) -> WorkerHandle:
        """Tenant-affine choice over the CURRENTLY available workers.
        ``exclude`` removes workers this query already watched die, so a
        retry lands elsewhere even before the breaker reacts. A ``write``
        goes to the FIRST ready worker in stable id order — one writer at
        a time keeps its delta overlay warm, and failover is simply the
        next worker in that order (the shared WAL's exclusive lock +
        catch-up make the hand-off safe regardless)."""
        ready = [
            w for w in self.supervisor.ready_workers
            if not (exclude and w.worker_id in exclude)
        ]
        if not ready and exclude:
            # every replica failed this query at least once: any available
            # worker beats a typed failure
            ready = self.supervisor.ready_workers
        if not ready:
            raise ERR.WorkerLost(
                "no available engine worker (all down or breaker-open)",
                site="serve-routing",
            )
        if write:
            return min(ready, key=lambda w: w.worker_id)
        idx = zlib.crc32(tenant.encode()) % len(ready)
        return ready[idx]

    async def _pick_or_wait(
        self,
        tenant: str,
        tried: set,
        deadline_at: Optional[float],
        write: bool = False,
    ) -> WorkerHandle:
        """``_pick``, but an empty fleet waits (bounded) for the supervisor
        to bring a worker back instead of failing instantly. A restart is
        normally seconds away; the wait is capped by ``ready_wait_s`` and
        by the query deadline, whichever is sooner."""
        wait_until = time.monotonic() + self.ready_wait_s
        if deadline_at is not None:
            wait_until = min(wait_until, deadline_at)
        while True:
            try:
                return self._pick(tenant, exclude=tried, write=write)
            except ERR.WorkerLost:
                if time.monotonic() >= wait_until:
                    raise
            await asyncio.sleep(0.05)

    # -- dispatch --------------------------------------------------------

    async def submit(
        self,
        *,
        graph: str,
        query: str,
        parameters: Optional[Dict[str, Any]] = None,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        faults: Optional[str] = None,
        qid: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Execute one read on the cluster; returns the worker payload with
        the retry trail merged into its ``execution_log``."""
        deadline_at = (
            time.monotonic() + deadline_s if deadline_s else None
        )
        # writes pin to the stable writer pick and never hedge (a hedged
        # write would execute twice by design). WorkerLost retry stays ON:
        # a write the dying worker committed is recovered from the WAL by
        # its successor, and the retried statement re-executes there —
        # callers wanting exactly-once under retry phrase writes as MERGE
        # (docs/mutation.md)
        is_write = wire.is_write_query(query)
        retry_log: List[Dict[str, Any]] = []
        spec = faults
        tried: set = set()
        for attempt in range(self.retry_max + 1):
            if deadline_at is not None and time.monotonic() >= deadline_at:
                raise ERR.QueryTimeout(
                    f"query deadline expired after {attempt} replica "
                    f"attempt(s)",
                    site="serve-routing",
                )
            w = await self._pick_or_wait(
                tenant, tried, deadline_at, write=is_write
            )
            req = {
                "op": "execute", "id": qid, "graph": graph, "query": query,
                "parameters": parameters or {}, "faults": spec,
            }
            if deadline_at is not None:
                req["deadline_s"] = max(deadline_at - time.monotonic(), 1e-6)
            t0 = time.monotonic()
            try:
                if not is_write and self._should_hedge(spec, deadline_at):
                    reply = await self._hedged(w, tenant, tried, req)
                else:
                    reply = await self._call(w, req)
            except ERR.WorkerLost as lost:
                tried.add(lost.worker or w.worker_id)
                retry_log.append({
                    "rung": G.RUNG_REPLICA,
                    "ok": False,
                    "worker": lost.worker or w.worker_id,
                    "error": "WorkerLost",
                    "duration_ms": round((time.monotonic() - t0) * 1e3, 3),
                })
                # the chaos schedule died with that worker; replaying it
                # would deterministically kill every replica in turn
                spec = None
                REPLICA_RETRIES.inc()
                continue
            # ANY framed reply — success or typed error — proves the worker
            # is conversational; only transport failures charge the breaker
            w.breaker.record_success()
            if not reply.get("ok"):
                wire.raise_wire_error(
                    str(reply.get("error")), str(reply.get("message"))
                )
            payload = reply["payload"]
            payload["worker"] = reply.get("worker", w.worker_id)
            payload["replica_retries"] = len(retry_log)
            if retry_log:
                payload["execution_log"] = (
                    retry_log + list(payload.get("execution_log") or [])
                )
                payload["rungs"] = [
                    e["rung"] for e in payload["execution_log"]
                ]
            return payload
        raise ERR.WorkerLost(
            f"query failed on {len(tried)} replica(s) "
            f"(retry budget {self.retry_max} exhausted)",
            site="serve-routing",
        )

    async def _call(
        self, w: WorkerHandle, req: Dict[str, Any]
    ) -> Dict[str, Any]:
        """One attempt against one worker. Transport failures surface as
        ``WorkerLost`` (stamped with the worker id) AFTER the supervisor
        has been told — restart/breaker reaction starts immediately, not
        at the next health tick."""
        try:
            reply = await wire.request(w.host, w.port, req)
        except (OSError, EOFError) as exc:
            self.supervisor.note_failure(w, exc)
            raise ERR.WorkerLost(
                f"worker {w.worker_id} lost mid-query: "
                f"{type(exc).__name__}: {exc}",
                site="serve-routing", worker=w.worker_id, cause=exc,
            ) from exc
        reply.setdefault("worker", w.worker_id)
        return reply

    # -- hedging ---------------------------------------------------------

    def _should_hedge(
        self, spec: Optional[str], deadline_at: Optional[float]
    ) -> bool:
        if self.hedge_ms <= 0 or spec is not None:
            return False
        if len(self.supervisor.ready_workers) < 2:
            return False
        return True

    async def _hedged(
        self,
        primary: WorkerHandle,
        tenant: str,
        tried: set,
        req: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Dispatch to ``primary``; if it has not answered after the hedge
        delay, duplicate to a second replica and take the first reply.
        The loser is cancelled (its worker simply finishes a read nobody
        is waiting for — harmless by idempotence)."""
        delay = self.hedge_ms / 1e3
        if req.get("deadline_s"):
            delay = min(delay, float(req["deadline_s"]) / 2)
        first = asyncio.ensure_future(self._call(primary, req))
        done, _ = await asyncio.wait({first}, timeout=delay)
        if done:
            return first.result()
        try:
            backup = self._pick(
                tenant, exclude=(tried | {primary.worker_id})
            )
        except ERR.WorkerLost:
            return await first  # nowhere to hedge to: ride the primary
        second = asyncio.ensure_future(self._call(backup, req))
        pending = {first, second}
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    if task.exception() is None:
                        HEDGES.inc(
                            winner="primary" if task is first else "hedge"
                        )
                        return task.result()
                # that attempt died; if the other is still running, wait on
                # it — if both died, re-raise the FIRST failure (the retry
                # loop above handles it like any single-attempt loss)
                if not pending:
                    return first.result() if not first.cancelled() else (
                        second.result()
                    )
        finally:
            for task in (first, second):
                if not task.done():
                    task.cancel()
        raise AssertionError("unreachable")  # pragma: no cover
