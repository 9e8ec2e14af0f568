"""Multi-tenant query serving: N concurrent clients, one warm engine.

The port of ``tpu_cypher/serve/``. One line per layer:

* ``session_pool`` — ONE warm ``CypherSession`` (the device, the kernel
  builds and the plan cache are process-global) multiplexed onto bounded
  worker threads, each query inside a fresh ``contextvars.Context`` and
  on its thread's own CUDA stream, so neither engine state nor kernel
  scratch is shared between concurrent queries.
* ``scheduler`` — admission by padded-memory cost (``bucketing.admit``
  against ``TPU_CYPHER_MEM_BUDGET``, then cost-ordered tenant-fair slot
  grants) with queued deadline expiry raising the engine's typed
  ``QueryTimeout``, plus queue-depth overload shedding and graceful drain.
* ``batching`` — same-plan/same-params/same-bucket queries arriving
  within ``TPU_CYPHER_SERVE_BATCH_WINDOW_MS`` coalesce into ONE device
  dispatch, demuxed per client.
* ``result_cache`` — byte-budgeted LRU of complete wire payloads keyed
  on the micro-batch demux key and invalidated by the graph-statistics
  fingerprint: a repeat read launches no kernel.
* ``server`` — the asyncio front end: newline-JSON submit/stream/cancel
  (plus pull-based cursor streaming: ``"stream": true`` + ``next`` /
  ``close`` credit flow) plus ``GET /metrics``
  (``session.metrics_text()`` verbatim), ``GET /queries/<id>``
  (per-query profile JSON), ``GET /cache`` and ``GET /healthz`` on the
  same port.

And the fault-isolated multi-process tier layered on top:

* ``wire`` — the worker wire protocol + the shared execute-payload
  builder (single-process and multi-process results cannot drift).
* ``worker`` — the engine-worker process: one warm session per OS
  process (its own CUDA context), expendable by design, readiness gated
  on the kernel build and warmup; without a card it serves only when its
  config asks for ``"cpu"``.
* ``supervisor`` — spawn/health-check/restart with exponential backoff
  and a per-worker circuit breaker probed by canary queries.
* ``router`` — tenant-affine routing, transparent replica retry after
  ``WorkerLost`` (rung ``"replica"``), optional hedged dispatch.
* ``cluster`` — ``ClusterServer``: ``QueryServer``'s whole front half
  (protocol, admission, batching, obs) over N supervised workers sharing
  one WAL directory for their mutable graphs.

Run one with ``python -m tpu_cypher_torch.serve`` (demo graph; on the
card unless ``--device cpu``; ``TPU_CYPHER_SERVE_WORKERS=4`` for the
multi-process tier) or embed::

    server = QueryServer(CypherSession.cuda(), port=0)
    server.register_graph("social", graph)
    async with server:
        ...
"""

from .batching import BatchWindow, batch_key, bucket_signature
from .cluster import ClusterServer
from .result_cache import ResultCache
from .router import Router
from .scheduler import AdmissionScheduler, estimate_cost_bytes, preflight_admit
from .server import PAGE_ROWS, PROTOCOL_VERSION, QueryServer
from .session_pool import SessionPool
from .supervisor import (
    CircuitBreaker,
    SubprocessLauncher,
    Supervisor,
    WorkerHandle,
)

__all__ = [
    "AdmissionScheduler",
    "BatchWindow",
    "CircuitBreaker",
    "ClusterServer",
    "PAGE_ROWS",
    "PROTOCOL_VERSION",
    "QueryServer",
    "ResultCache",
    "Router",
    "SessionPool",
    "SubprocessLauncher",
    "Supervisor",
    "WorkerHandle",
    "batch_key",
    "bucket_signature",
    "estimate_cost_bytes",
    "preflight_admit",
]
