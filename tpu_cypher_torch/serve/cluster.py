"""Fault-isolated multi-process serving: ``ClusterServer``.

``QueryServer`` multiplexes tenants onto one warm engine in ONE process —
one native device abort (a sticky CUDA error poisons the context, an
illegal address takes the process down) and every tenant is gone. ``ClusterServer`` keeps the
entire front half of that server — protocol, admission scheduling,
micro-batching, HTTP observability — and swaps exactly one method:
``_execute_payload`` routes to a supervised engine-worker PROCESS
(``serve/worker.py``) through the router instead of running in-process.

The blast radius of a crash becomes one worker's in-flight queries, and
even those are transparently retried on a surviving replica
(``serve/router.py``; rung ``"replica"`` in the execution log). What
stays shared across workers is what is safe to share: the kernel
libraries on disk (``hopper/_build.py`` builds under a file lock, so N
workers booting together build once) and the WAL directory of the
mutable graphs. Each worker holds its own CUDA context and its own copy
of every graph on the card. The reference also shares a persistent XLA
compile cache; the port compiles nothing per query and has none.

Graphs are REPLICATED, not shared: ``register_graph`` takes the CREATE
query text and every worker builds its own copy (device buffers cannot
cross process boundaries; the text is the portable form, and the local
replica built from the same text keeps cost estimation and the
``/metrics`` surface identical to single-process serving). The same
deferral applies to ``warmup``: the corpus is recorded and each worker
runs it at boot — readiness is warmup-gated per worker.

Sizing: each worker is its own engine with ``lanes`` execution lanes, so
the cluster's admission ceiling defaults to ``max_concurrent x workers``
— the scheduler admits what the fleet can actually run.

Device: the front end and every worker run on ``device`` (``"cuda"`` by
default). A worker without a card fails its readiness unless the config
asks for ``"cpu"``, as the tests do; it never serves on the host in the
card's place.
"""

from __future__ import annotations

import asyncio
import tempfile
import time
from typing import Any, Dict, List, Optional

from ..storage.wal import wal_directory
from ..relational.session import CypherSession
from ..utils.config import (
    SERVE_DRAIN_TIMEOUT_S,
    SERVE_MAX_CONCURRENT,
    SERVE_WORKERS,
)
from . import wire
from .router import Router
from .server import PAGE_ROWS, QueryServer, _Ticket
from .supervisor import SubprocessLauncher, Supervisor


class ClusterServer(QueryServer):  # shared-by: loop
    """The router front end over N supervised engine-worker processes."""

    def __init__(
        self,
        workers: Optional[int] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        max_concurrent: Optional[int] = None,
        batch_window_ms: Optional[float] = None,
        tenant_quota: Optional[int] = None,
        device: str = "cuda",
        launcher=None,
        retry_max: Optional[int] = None,
        hedge_ms: Optional[float] = None,
        lanes: int = 4,
        cache_bytes: Optional[int] = None,
        wal_dir: Optional[str] = None,
    ):
        self.n_workers = max(
            int(workers if workers is not None else SERVE_WORKERS.get()), 1
        )
        if max_concurrent is None:
            # the fleet runs n_workers engines; admit what it can execute
            max_concurrent = int(SERVE_MAX_CONCURRENT.get()) * self.n_workers
        self.device = str(device)
        super().__init__(
            CypherSession.cuda(device=self.device),
            host=host, port=port, max_concurrent=max_concurrent,
            batch_window_ms=batch_window_ms, tenant_quota=tenant_quota,
            cache_bytes=cache_bytes,
        )
        self.lanes = int(lanes)
        # where worker WAL files live (one per mutable graph): the explicit
        # directory, else TPU_CYPHER_WAL_DIR (storage.wal.wal_directory),
        # else a temporary directory made at start when a mutable graph is
        # mounted — every worker must see the same files
        self.wal_dir = wal_directory(wal_dir)
        self._graph_specs: Dict[str, str] = {}
        self._mutable_graphs: set = set()
        self._warmup_specs: Dict[str, List[str]] = {}
        self._launcher = launcher
        self._retry_max = retry_max
        self._hedge_ms = hedge_ms
        self.supervisor: Optional[Supervisor] = None
        self.router: Optional[Router] = None

    # -- graphs: replicated by CREATE text -------------------------------

    def register_graph(
        self, name: str, create_query: str, mutable: bool = False
    ) -> None:  # type: ignore[override]
        """Mount a graph cluster-wide from its CREATE query text. The
        front end builds a LOCAL replica too (cost estimation, batching
        keys, and the single-process protocol surface all need a real
        graph object); workers each build theirs at boot. ``mutable``
        graphs boot on the workers as delta-CSR stores sharing one WAL
        file under ``wal_dir`` — the front-end replica stays immutable
        (it never executes queries; its fingerprint is refreshed from
        each write payload)."""
        self._graph_specs[name] = create_query
        if mutable:
            self._mutable_graphs.add(name)
        graph = self.session.create_graph_from_create_query(create_query)
        super().register_graph(name, graph)

    def warmup(self, queries, graph_name: str,
               parameters: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:  # type: ignore[override]
        """Record the warmup corpus for the workers (each runs it at boot,
        gating its own readiness). The front end does NOT execute it — the
        router never executes queries locally."""
        qs = list(queries)
        self._warmup_specs.setdefault(graph_name, []).extend(qs)
        return {"queries": len(qs), "deferred": True}

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        if self._launcher is None:
            if self._mutable_graphs and not self.wal_dir:
                self.wal_dir = tempfile.mkdtemp(prefix="tpu-cypher-cluster-wal-")
            self._launcher = SubprocessLauncher(
                self._graph_specs, self._warmup_specs,
                device=self.device,
                host=self.host, lanes=self.lanes,
                mutable=sorted(self._mutable_graphs),
                wal_dir=self.wal_dir,
            )
        canary = None
        if self._graph_specs:
            # a cheap known-good read on the first mounted graph: what the
            # supervisor executes to PROVE a worker ready (breaker close,
            # restart completion)
            first = sorted(self._graph_specs)[0]
            canary = (first, "MATCH (n) RETURN count(n) AS n")
        self.supervisor = Supervisor(
            self._launcher, self.n_workers, canary=canary
        )
        self.router = Router(
            self.supervisor, retry_max=self._retry_max,
            hedge_ms=self._hedge_ms,
        )
        await self.supervisor.start()
        await super().start()

    async def stop(self) -> None:
        await super().stop()
        if self.supervisor is not None:
            await self.supervisor.stop()

    async def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful cluster drain: stop admitting (typed rejections), let
        in-flight queries finish, then ask every worker to exit."""
        budget = float(
            timeout if timeout is not None else SERVE_DRAIN_TIMEOUT_S.get()
        )
        await super().drain(budget)
        if self.supervisor is not None:
            await self.supervisor.drain(budget)

    # -- the execution hook ----------------------------------------------

    async def _execute_payload(self, t: _Ticket, graph) -> Dict[str, Any]:
        remaining = None
        if t.deadline_s:
            remaining = max(
                t.deadline_s - (time.monotonic() - t.submitted_at), 1e-6
            )
        return await self.router.submit(
            graph=t.graph_name, query=t.query, parameters=t.parameters,
            tenant=t.tenant, deadline_s=remaining, faults=t.faults,
            qid=t.qid,
        )

    async def _open_stream(self, t: _Ticket, graph):
        """Cursor streaming over the cluster: route the query like any
        other (retry/hedging/breakers all apply), then page the payload
        the worker necessarily returned whole — the worker wire protocol
        is one-shot. The cursor protocol stays identical to the
        single-process server; only the front-end memory ceiling differs
        (one full payload instead of one chunk)."""
        payload = await self._execute_payload(t, graph)
        rows = payload.pop("rows", [])
        meta = dict(payload)
        meta["total_rows"] = len(rows)
        return meta, wire.ListPages(rows, page_rows=PAGE_ROWS)

    async def _flush_caches(self) -> int:
        """Flush the front-end cache AND every reachable worker's — the
        ``/cache/flush`` endpoint must leave no replica serving stale
        results."""
        dropped = self.cache.flush()
        workers = list(self.supervisor.workers) if self.supervisor else []
        for w in workers:
            if not w.available:
                continue
            try:
                reply = await wire.request(
                    w.host, w.port, {"op": "cache_flush"}, timeout=5.0
                )
                dropped += int(reply.get("flushed") or 0)
            except (OSError, EOFError, asyncio.TimeoutError):
                pass  # fault-ok: a dead worker's cache dies with it
        return dropped
