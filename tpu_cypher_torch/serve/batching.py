"""Micro-batching: same-bucket queries share one device dispatch.

"These queries run the same plan" is a cheap STATIC decision: a query's
relational plan is keyed by the session plan-cache key (query text +
ambient graph + parameter type signature), and the bucket mode its
materialize sizes round through is the rest of its shape. Two submissions
that agree on the plan-cache key, the parameter VALUES, and the bucket
signature are not merely same-plan — they are the same device work
bit-for-bit. Under bursty traffic (dashboards,
retries, fan-out frontends) such duplicates cluster within milliseconds,
so the server holds each batchable query open for a short coalescing
window (``TPU_CYPHER_SERVE_BATCH_WINDOW_MS``) and dispatches ONE execution
for the whole group: the leader runs the plan, every member's client gets
its own demuxed result stream, span tree, and per-client tags.

Queries the plan cache would not cache (catalog interaction, driving
tables, non-scalar parameters) are never batched; a ``None`` signature
falls through to a solo dispatch.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from ..backend.cuda import bucketing
from ..obs.metrics import REGISTRY as _REGISTRY

DISPATCHES = _REGISTRY.counter(
    "tpu_cypher_serve_dispatch_total",
    "device dispatches issued by the serving layer",
    labels=("batched",),
)
BATCHED_QUERIES = _REGISTRY.counter(
    "tpu_cypher_serve_batched_queries_total",
    "client queries that shared a dispatch with at least one other query",
)


def bucket_signature() -> Tuple[str, ...]:
    """The static part of 'same executable': the active bucket mode (the
    lattice every materialize size rounds through). Kept a tuple so future
    lattice knobs extend the signature without changing call sites."""
    return (bucketing.mode(),)


def batch_key(session, query: str, graph, parameters: Dict[str, Any]):
    """The coalescing key: plan-cache key + parameter values + bucket
    signature, or None when the query is not batchable (exactly the
    queries the plan cache refuses to cache)."""
    plan_key = session._plan_cache_key(query, graph, parameters or {}, None)
    if plan_key is None:
        return None
    try:
        values = tuple(sorted((k, repr(v)) for k, v in (parameters or {}).items()))
    except TypeError:  # fault-ok: unorderable params just skip batching
        return None
    return (plan_key, values, bucket_signature())


class Batch:  # shared-by: loop
    """One open coalescing group: the leader executes, members share."""

    __slots__ = ("key", "leader_id", "members", "done", "result", "error")

    def __init__(self, key, leader_id: str):
        self.key = key
        self.leader_id = leader_id
        self.members: List[str] = [leader_id]
        self.done = asyncio.Event()
        self.result: Optional[Any] = None
        self.error: Optional[BaseException] = None

    @property
    def size(self) -> int:
        return len(self.members)


class BatchWindow:  # shared-by: loop
    """The coalescer. Protocol (all on the event loop):

    * ``lead_or_join(key, qid)`` -> ``(batch, is_leader)``. The leader
      sleeps out the window (``await window()``), calls ``close`` to seal
      the group, executes once, then ``publish``es. Followers just await
      ``batch.done`` and read ``batch.result`` / ``batch.error``.
    * a ``None`` key never coalesces: callers get a fresh single-member
      batch that is already sealed.
    """

    def __init__(self, window_ms: float):
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self._open: Dict[Any, Batch] = {}

    def lead_or_join(self, key, qid: str) -> Tuple[Batch, bool]:
        if key is None or self.window_s <= 0:
            return Batch(None, qid), True
        b = self._open.get(key)
        if b is not None:
            b.members.append(qid)
            return b, False
        b = Batch(key, qid)
        self._open[key] = b
        return b, True

    async def window(self) -> None:
        if self.window_s > 0:
            await asyncio.sleep(self.window_s)

    def close(self, batch: Batch) -> Batch:
        """Seal the group: later arrivals with the same key start a new
        batch. Returns the sealed batch (its member list is now final)."""
        if batch.key is not None and self._open.get(batch.key) is batch:
            del self._open[batch.key]
        DISPATCHES.inc(batched=str(batch.size > 1).lower())
        if batch.size > 1:
            BATCHED_QUERIES.inc(batch.size)
        return batch

    @staticmethod
    def publish(batch: Batch, result=None, error: Optional[BaseException] = None) -> None:
        """Leader hands the single execution's outcome to every member."""
        batch.result = result
        batch.error = error
        batch.done.set()

    def abandon(self, batch: Batch) -> None:
        """Leader died before executing (cancelled while queued): unseal
        nothing, wake followers with a typed error so none hang."""
        if batch.key is not None and self._open.get(batch.key) is batch:
            del self._open[batch.key]
        if not batch.done.is_set():
            from ..errors import DeviceLost

            batch.error = DeviceLost(
                "batch leader cancelled before dispatch", site="serve-batch"
            )
            batch.done.set()
