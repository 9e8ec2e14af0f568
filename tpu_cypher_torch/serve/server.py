"""The asyncio query server: JSON protocol, micro-batching, obs endpoints.

One ``QueryServer`` owns one warm engine (``SessionPool``), an admission
scheduler, and a batch coalescer, and serves two protocols on ONE port:

* **query protocol** — newline-delimited JSON, request/stream/response::

      -> {"op": "submit", "query": "MATCH ...", "graph": "g",
          "parameters": {...}, "tenant": "t1", "deadline_s": 1.5,
          "faults": "oom@join:1", "id": "my-1"}
      <- {"type": "accepted", "id": "my-1"}
      <- {"type": "rows", "id": "my-1", "seq": 0, "rows": [{...}, ...]}
      <- {"type": "done", "id": "my-1", "rows": 12, "seconds": 0.004,
          "batched": 3, "batch_leader": "q7", "rungs": ["device"],
          "degraded": false}

  plus ``{"op": "cancel", "id": ...}`` -> ``{"type": "cancelled"}`` and
  typed failures as ``{"type": "error", "id", "error": "QueryTimeout",
  "message"}``. Multiple queries stream concurrently on one connection;
  every message carries the query id it belongs to.

  A submit with ``"stream": true`` opens a pull-based CURSOR instead of
  the eager demux: pages flow under a credit window
  (``TPU_CYPHER_SERVE_STREAM_WINDOW`` unacknowledged pages), the client
  grants credit with ``{"op": "next", "id": ..., "n": 1}`` and may end
  early with ``{"op": "close", "id": ...}``; the ``done`` message then
  carries ``streamed: true`` and ``total_rows``. Row decode happens one
  bounded chunk at a time (``wire.RowStream``), so an arbitrarily large
  result streams under a fixed host-memory ceiling and a slow consumer
  parks only its own cursor — never the loop or a device slot.

  Repeat reads are served by a ZERO-DISPATCH result cache
  (``serve/result_cache.py``): hits skip batching, admission, and the
  device entirely, stamping ``cached: true`` on the ``done`` message.

* **observability over HTTP** (sniffed from the first line, so curl and a
  Prometheus scraper need no special port): ``GET /metrics`` returns
  ``session.metrics_text()`` VERBATIM (golden-tested against the
  in-process text so the surfaces cannot drift), ``GET /queries/<id>``
  returns the per-query record — status, execution log, rungs,
  batch tags, and the full ``profile()`` span tree as JSON.
  ``GET /cache`` reports result-cache occupancy and hit counters;
  ``POST /cache/flush`` drops every cached result (cluster mode fans the
  flush out to its worker processes; GET on it is 405 — a probe or
  crawler must never drop the cache).

Execution path per submit: resolve graph -> batch coalescing
(``serve/batching.py``) -> pre-flight budget admission + cost-ordered,
tenant-fair slot wait (``serve/scheduler.py``) -> one isolated-context
execution on the warm session (``serve/session_pool.py``) with the
client's deadline (``guard.request_deadline``) and chaos schedule
(``faults.scoped_spec``) scoped in, on the lane's own CUDA stream -> per-
client demux of rows, spans, and rung tags.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import json
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .. import errors as ERR
from ..backend.cuda import device as _device
from ..obs.metrics import REGISTRY as _REGISTRY
from ..relational.session import CypherSession, PropertyGraph
from ..utils.config import (
    SERVE_BATCH_WINDOW_MS,
    SERVE_DRAIN_TIMEOUT_S,
    SERVE_MAX_CONCURRENT,
    SERVE_PORT,
    SERVE_QUEUE_HIGH,
    SERVE_STREAM_WINDOW,
    SERVE_TENANT_QUOTA,
)
from . import wire
from .batching import Batch, BatchWindow, batch_key
from .result_cache import ResultCache, graph_fingerprint
from .scheduler import AdmissionScheduler, preflight_admit
from .session_pool import SessionPool

PROTOCOL_VERSION = 1
PAGE_ROWS = 256  # rows per streamed "rows" message
_QUERY_LOG_MAX = 512  # bounded /queries/<id> history

QUERIES_TOTAL = _REGISTRY.counter(
    "tpu_cypher_serve_queries_total",
    "client queries by terminal status",
    labels=("status",),
)
QUERY_SECONDS = _REGISTRY.histogram(
    "tpu_cypher_serve_query_seconds",
    "wall seconds from submit to done, per client query",
)
CURSORS_OPEN = _REGISTRY.gauge(
    "tpu_cypher_serve_cursor_open",
    "streaming cursors currently open",
)
BACKPRESSURE_WAITS = _REGISTRY.counter(
    "tpu_cypher_serve_cursor_backpressure_waits_total",
    "times a streaming cursor paused for client credit",
)

# the wire module owns value/row encoding now (router and worker processes
# need the identical forms); these aliases keep existing importers working
_json_value = wire.json_value
_encode_rows = wire.encode_rows


class _Ticket:
    """One client query, from submit to terminal message."""

    __slots__ = (
        "qid", "query", "graph_name", "parameters", "tenant", "deadline_s",
        "faults", "conn", "status", "cancelled", "task", "submitted_at",
        "stream", "cursor",
    )

    def __init__(self, qid, query, graph_name, parameters, tenant,
                 deadline_s, faults, conn, stream=False):
        self.qid = qid
        self.query = query
        self.graph_name = graph_name
        self.parameters = parameters
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.faults = faults
        self.conn = conn
        self.stream = bool(stream)
        self.cursor: Optional["_Cursor"] = None
        self.status = "queued"
        self.cancelled = False
        self.task: Optional[asyncio.Task] = None
        self.submitted_at = time.monotonic()


class _Cursor:  # shared-by: loop
    """Flow-control state for ONE streamed query: a credit window of
    unacknowledged pages. The delivery loop pauses (on ``wake``) once
    ``sent - acked`` reaches ``window``; each client ``next`` message
    grants credit. A slow consumer therefore blocks only its own
    delivery task — the event loop, other cursors, and the device slots
    (released before delivery starts) never wait on it."""

    def __init__(self, window: int):
        self.window = max(int(window), 1)
        self.acked = 0
        self.sent = 0
        self.closed = False
        self.wake = asyncio.Event()


class _Conn:  # shared-by: loop
    """One client connection: serialized writes, many in-flight queries."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.lock = asyncio.Lock()
        self.closed = False

    async def send(self, obj: Dict[str, Any]) -> None:
        await self.send_raw((json.dumps(obj) + "\n").encode())

    async def send_raw(self, data: bytes) -> None:
        """Write one pre-serialized frame (callers that attribute
        serialize time — the demux stage accounting — encode first)."""
        if self.closed:
            return
        async with self.lock:
            if self.closed:
                return
            try:
                self.writer.write(data)
                await self.writer.drain()
            except (ConnectionError, OSError):  # fault-ok: client went away
                self.closed = True


class QueryServer:  # shared-by: loop
    """The multi-tenant front end over one warm ``CypherSession``."""

    def __init__(
        self,
        session: Optional[CypherSession] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        max_concurrent: Optional[int] = None,
        batch_window_ms: Optional[float] = None,
        tenant_quota: Optional[int] = None,
        cache_bytes: Optional[int] = None,
    ):
        self.host = host
        self.port = int(port if port is not None else SERVE_PORT.get())
        max_c = int(
            max_concurrent if max_concurrent is not None
            else SERVE_MAX_CONCURRENT.get()
        )
        window = float(
            batch_window_ms if batch_window_ms is not None
            else SERVE_BATCH_WINDOW_MS.get()
        )
        quota = int(
            tenant_quota if tenant_quota is not None
            else SERVE_TENANT_QUOTA.get()
        )
        self.pool = SessionPool(session, workers=max_c)
        self.session = self.pool.session
        self.scheduler = AdmissionScheduler(
            max_c, tenant_quota=quota, queue_high=int(SERVE_QUEUE_HIGH.get())
        )
        self.batcher = BatchWindow(window)
        self.cache = ResultCache(cache_bytes)
        self._fingerprints: Dict[str, str] = {}
        # accumulated per-stage wall seconds (queue_wait / route /
        # dispatch / demux / serialize) — the soak harness's latency
        # attribution reads this
        self.stages: Dict[str, float] = {}
        self._graphs: Dict[str, PropertyGraph] = {}
        self._tickets: Dict[str, _Ticket] = {}
        self._records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._qids = itertools.count(1)
        self._server: Optional[asyncio.base_events.Server] = None

    # -- graphs ----------------------------------------------------------

    def register_graph(self, name: str, graph: PropertyGraph) -> None:
        """Mount a catalog graph for clients to query by name. Computes
        the graph's statistics fingerprint here — the SYNC setup path —
        so result-cache lookups on the event loop are one dict read.
        Re-registering a name with changed data yields a new fingerprint,
        which invalidates that graph's cached results on next lookup."""
        self._graphs[name] = graph
        self._fingerprints[name] = graph_fingerprint(self.session, graph)
        # the graph was ingested on this thread's stream; the pool's lanes
        # read it on streams of their own
        _device.fence()

    def warmup(self, queries, graph_name: str,
               parameters: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run a query corpus against a mounted graph ahead of traffic:
        kernel builds, CSR indexes and plans (blocking; call before
        accepting traffic)."""
        return self.pool.warmup(
            queries, graph=self._graphs[graph_name], parameters=parameters
        )

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        for t in list(self._tickets.values()):
            if t.task is not None and not t.task.done():
                t.task.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.pool.close()

    async def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful drain (SIGTERM semantics): new submits are rejected
        typed (``AdmissionRejected``) from this moment; queries already
        admitted or queued run to completion (bounded by ``timeout``,
        default ``TPU_CYPHER_SERVE_DRAIN_TIMEOUT_S``). The listener stays
        up through the drain so in-flight clients receive their rows;
        ``stop()`` afterwards tears it down."""
        budget = float(
            timeout if timeout is not None else SERVE_DRAIN_TIMEOUT_S.get()
        )
        self.scheduler.begin_drain()
        await self.scheduler.quiesce(budget)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def __aenter__(self) -> "QueryServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- connection handling ---------------------------------------------

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _Conn(writer)
        try:
            first = await reader.readline()
            if not first:
                return
            if first[:4] in (b"GET ", b"HEAD") or first[:5] == b"POST ":
                await self._handle_http(first, reader, writer)
                return
            await self._handle_line(first, conn)
            while True:
                line = await reader.readline()
                if not line:
                    break
                await self._handle_line(line, conn)
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass  # fault-ok: disconnects are routine, queries clean up below
        finally:
            conn.closed = True
            with contextlib.suppress(Exception):  # fault-ok: teardown only
                writer.close()
                await writer.wait_closed()

    async def _handle_line(self, line: bytes, conn: _Conn) -> None:
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError("message must be a JSON object")
        except ValueError as exc:
            await conn.send(
                {"type": "error", "id": None, "error": "ProtocolError",
                 "message": f"bad JSON line: {exc}"}
            )
            return
        op = msg.get("op")
        if op == "submit":
            await self._op_submit(msg, conn)
        elif op == "cancel":
            await self._op_cancel(msg, conn)
        elif op == "next":
            await self._op_next(msg, conn)
        elif op == "close":
            await self._op_close(msg, conn)
        elif op == "ping":
            await conn.send({"type": "pong", "protocol": PROTOCOL_VERSION})
        else:
            await conn.send(
                {"type": "error", "id": msg.get("id"), "error": "ProtocolError",
                 "message": f"unknown op {op!r}"}
            )

    # -- protocol ops ----------------------------------------------------

    async def _op_submit(self, msg: Dict[str, Any], conn: _Conn) -> None:
        qid = str(msg.get("id") or f"q{next(self._qids)}")
        if qid in self._tickets:
            await conn.send(
                {"type": "error", "id": qid, "error": "ProtocolError",
                 "message": f"duplicate query id {qid!r}"}
            )
            return
        query = msg.get("query")
        graph_name = msg.get("graph")
        if not isinstance(query, str) or not query.strip():
            await conn.send(
                {"type": "error", "id": qid, "error": "ProtocolError",
                 "message": "submit requires a non-empty 'query' string"}
            )
            return
        if graph_name not in self._graphs:
            await conn.send(
                {"type": "error", "id": qid, "error": "UnknownGraph",
                 "message": f"graph {graph_name!r} is not mounted "
                 f"(have: {sorted(self._graphs)})"}
            )
            return
        deadline_s = msg.get("deadline_s")
        t = _Ticket(
            qid, query, graph_name, dict(msg.get("parameters") or {}),
            str(msg.get("tenant") or "default"),
            float(deadline_s) if deadline_s else None,
            msg.get("faults"), conn, stream=bool(msg.get("stream")),
        )
        self._tickets[qid] = t
        await conn.send({"type": "accepted", "id": qid})
        t.task = asyncio.ensure_future(self._run_ticket(t))

    async def _op_cancel(self, msg: Dict[str, Any], conn: _Conn) -> None:
        qid = str(msg.get("id") or "")
        t = self._tickets.get(qid)
        if t is None or t.status in ("done", "error", "cancelled"):
            await conn.send(
                {"type": "error", "id": qid or None, "error": "UnknownQuery",
                 "message": f"no cancellable query {qid!r}"}
            )
            return
        t.cancelled = True
        if t.cursor is not None:
            t.cursor.wake.set()  # unblock a backpressure-paused stream
        if t.status == "queued" and t.task is not None:
            # still pre-dispatch: tear the task down now (a sealed batch
            # with followers is handled inside the task — it executes for
            # them and only this client's results are dropped)
            t.task.cancel()
        await conn.send({"type": "cancel_requested", "id": qid})

    async def _op_next(self, msg: Dict[str, Any], conn: _Conn) -> None:
        """Grant streaming credit: the client acknowledges page(s),
        letting a backpressure-paused cursor resume."""
        qid = str(msg.get("id") or "")
        t = self._tickets.get(qid)
        cur = t.cursor if t is not None else None
        if cur is None:
            await conn.send(
                {"type": "error", "id": qid or None, "error": "UnknownQuery",
                 "message": f"no open cursor {qid!r}"}
            )
            return
        try:
            n = max(int(msg.get("n") or 1), 1)
        except (TypeError, ValueError):
            n = 1
        cur.acked += n
        cur.wake.set()

    async def _op_close(self, msg: Dict[str, Any], conn: _Conn) -> None:
        """Close a streaming cursor early: delivery stops after the
        in-flight page and the query finishes with the rows sent so far."""
        qid = str(msg.get("id") or "")
        t = self._tickets.get(qid)
        cur = t.cursor if t is not None else None
        if cur is None:
            await conn.send(
                {"type": "error", "id": qid or None, "error": "UnknownQuery",
                 "message": f"no open cursor {qid!r}"}
            )
            return
        cur.closed = True
        cur.wake.set()
        await conn.send({"type": "close_requested", "id": qid})

    # -- the execution pipeline ------------------------------------------

    async def _run_ticket(self, t: _Ticket) -> None:
        graph = self._graphs[t.graph_name]
        if t.stream:
            try:
                await self._run_stream(t, graph)
            except asyncio.CancelledError:
                self._terminal(
                    t, "cancelled", {"type": "cancelled", "id": t.qid}
                )
                await t.conn.send({"type": "cancelled", "id": t.qid})
            except Exception as exc:  # fault-ok: typed error reply
                await self._fail(t, exc)
            return
        # chaos schedules and per-request deadlines are client-scoped
        # state: such queries never share a dispatch — and, for the same
        # reason, never hit or populate the result cache. Writes are also
        # excluded (belt to batch_key's suspenders): each must execute.
        key = None
        if (
            t.faults is None
            and t.deadline_s is None
            and not wire.is_write_query(t.query)
        ):
            key = batch_key(self.session, t.query, graph, t.parameters)
            hit = self.cache.lookup(key, self._fingerprints.get(t.graph_name, ""))
            if hit is not None:
                # zero-dispatch fast path: no batch window, no admission
                # wait, no device work — the stored payload is served
                # straight from host memory on a sealed single-member batch
                batch = Batch(None, t.qid)
                batch.result = hit
                try:
                    await self._finish(t, batch)
                except Exception as exc:  # fault-ok: typed error reply
                    await self._fail(t, exc)
                return
        batch, is_leader = self.batcher.lead_or_join(key, t.qid)
        try:
            if is_leader:
                await self.batcher.window()
                self.batcher.close(batch)
                if t.cancelled and batch.size == 1:
                    raise asyncio.CancelledError
                await self._dispatch(t, graph, batch)
            else:
                await batch.done.wait()
            await self._finish(t, batch)
        except asyncio.CancelledError:
            if is_leader:
                self.batcher.abandon(batch)
            self._terminal(t, "cancelled", {"type": "cancelled", "id": t.qid})
            await t.conn.send({"type": "cancelled", "id": t.qid})
        except Exception as exc:  # fault-ok: surfaced as a typed error reply
            await self._fail(t, exc)

    def _stage(self, name: str, seconds: float) -> None:
        """Accumulate per-stage wall seconds (queue_wait / route /
        dispatch / demux / serialize) for latency attribution."""
        self.stages[name] = self.stages.get(name, 0.0) + max(seconds, 0.0)

    async def _dispatch(self, t: _Ticket, graph, batch) -> None:
        """The leader's path: admission, one isolated execution, publish."""
        try:
            cost = preflight_admit(graph, t.query, t.tenant)
            deadline_at = (
                t.submitted_at + t.deadline_s if t.deadline_s else None
            )
            tq0 = time.perf_counter()
            await self.scheduler.acquire(cost, t.tenant, deadline_at)
            self._stage("queue_wait", time.perf_counter() - tq0)
            t.status = "running"
            td0 = time.perf_counter()
            try:
                payload = await self._execute_payload(t, graph)
            finally:
                self.scheduler.release(t.tenant)
            wall = time.perf_counter() - td0
            self._stage("dispatch", wall)
            # route = everything around the engine seconds: lane hop in
            # one process, connect/serialize/worker hop in cluster mode
            self._stage(
                "route", wall - float(payload.get("seconds") or 0.0)
            )
            self.batcher.publish(batch, result=payload)
            write_stats = payload.get("write")
            if write_stats and write_stats.get("fingerprint"):
                # a committed write advanced the graph's chained
                # fingerprint: refresh our copy so result-cache entries
                # stored under the old one stop matching from now on
                self._fingerprints[t.graph_name] = write_stats["fingerprint"]
            fp = self._fingerprints.get(t.graph_name)
            if batch.key is not None and fp is not None:
                # populate AFTER publish (and after any router mutation):
                # the stored payload is exactly what members received
                self.cache.store(batch.key, fp, payload)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # fault-ok: published to every member as a typed error
            self.batcher.publish(batch, error=exc)

    async def _execute_payload(self, t: _Ticket, graph) -> Dict[str, Any]:
        """THE execution hook: everything above it (protocol, batching,
        admission) is shared with the multi-process tier, which overrides
        this one method to route to an engine-worker process instead
        (``serve/cluster.py``)."""
        return await self.pool.run(lambda: self._execute(graph, t))

    def _execute(self, graph, t: _Ticket) -> Dict[str, Any]:
        """One engine execution — runs on a pool worker thread inside a
        FRESH contextvars.Context; everything scoped here dies with the
        query."""
        remaining = None
        if t.deadline_s:
            # remaining budget: queue wait already consumed part of it
            remaining = max(
                t.deadline_s - (time.monotonic() - t.submitted_at), 1e-6
            )
        return wire.execute_payload(
            self.session, graph, t.query, t.parameters,
            deadline_s=remaining, faults=t.faults,
        )

    # -- cursor streaming ------------------------------------------------

    async def _open_stream(self, t: _Ticket, graph):
        """Streamed-execution hook: ``(meta, page source)``. The cluster
        tier overrides this to route through an engine worker."""
        remaining = None
        if t.deadline_s:
            remaining = max(
                t.deadline_s - (time.monotonic() - t.submitted_at), 1e-6
            )
        return await self.pool.run(
            lambda: wire.open_stream(
                self.session, graph, t.query, t.parameters,
                deadline_s=remaining, faults=t.faults, page_rows=PAGE_ROWS,
            )
        )

    async def _run_stream(self, t: _Ticket, graph) -> None:
        """The pull-based delivery path (``"stream": true`` submits).

        Device execution happens once, under an admission slot; the slot
        is released BEFORE delivery, so a slow consumer holds host memory
        for one chunk — never a device slot. Pages then flow under the
        cursor's credit window: decode rides the pool lanes
        (``RowStream.next_page`` is blocking host work), sends ride this
        task, and a full window parks on the cursor event until the
        client grants credit (``next``), closes, cancels, or disconnects.
        Streamed queries never batch and never touch the result cache —
        their value is precisely the results too big to hold whole."""
        cost = preflight_admit(graph, t.query, t.tenant)
        deadline_at = t.submitted_at + t.deadline_s if t.deadline_s else None
        tq0 = time.perf_counter()
        await self.scheduler.acquire(cost, t.tenant, deadline_at)
        self._stage("queue_wait", time.perf_counter() - tq0)
        t.status = "running"
        td0 = time.perf_counter()
        try:
            meta, source = await self._open_stream(t, graph)
        finally:
            self.scheduler.release(t.tenant)
        wall = time.perf_counter() - td0
        self._stage("dispatch", wall)
        self._stage("route", wall - float(meta.get("seconds") or 0.0))
        cur = _Cursor(int(SERVE_STREAM_WINDOW.get()))
        t.cursor = cur
        CURSORS_OPEN.set(CURSORS_OPEN.value() + 1)
        streamed = 0
        seq = 0
        try:
            while not (t.cancelled or cur.closed or t.conn.closed):
                if cur.sent - cur.acked >= cur.window:
                    BACKPRESSURE_WAITS.inc()
                    cur.wake.clear()
                    await cur.wake.wait()
                    continue
                tp0 = time.perf_counter()
                page = await self.pool.run(source.next_page)
                if page is None:
                    break
                msg = {"type": "rows", "id": t.qid, "seq": seq, "rows": page}
                ts0 = time.perf_counter()
                data = (json.dumps(msg) + "\n").encode()
                tser = time.perf_counter() - ts0
                self._stage("serialize", tser)
                await t.conn.send_raw(data)
                self._stage("demux", time.perf_counter() - tp0 - tser)
                cur.sent += 1
                seq += 1
                streamed += len(page)
        finally:
            with contextlib.suppress(Exception):  # fault-ok: teardown only
                source.close()
            CURSORS_OPEN.set(max(CURSORS_OPEN.value() - 1, 0))
        if t.cancelled:
            self._terminal(t, "cancelled", {"type": "cancelled", "id": t.qid})
            await t.conn.send({"type": "cancelled", "id": t.qid})
            return
        if seq == 0:
            # zero-row parity with the eager path: always >= 1 rows frame
            await t.conn.send(
                {"type": "rows", "id": t.qid, "seq": 0, "rows": []}
            )
        done = {
            "type": "done",
            "id": t.qid,
            "rows": streamed,
            "total_rows": meta["total_rows"],
            "seconds": meta["seconds"],
            "batched": 1,
            "batch_leader": t.qid,
            "rungs": meta["rungs"],
            "degraded": meta["degraded"],
            "streamed": True,
            "cached": False,
        }
        self._terminal(t, "done", done, payload={**meta, "rows": []})
        self._records[t.qid]["rows"] = streamed
        await t.conn.send(done)

    async def _finish(self, t: _Ticket, batch) -> None:
        if batch.error is not None:
            raise batch.error
        payload = batch.result
        if t.cancelled:
            self._terminal(t, "cancelled", {"type": "cancelled", "id": t.qid})
            await t.conn.send({"type": "cancelled", "id": t.qid})
            return
        rows = payload["rows"]
        td0 = time.perf_counter()
        ser = 0.0
        for seq in range(0, max(len(rows), 1), PAGE_ROWS):
            page = rows[seq : seq + PAGE_ROWS]
            if page or seq == 0:
                msg = {"type": "rows", "id": t.qid, "seq": seq // PAGE_ROWS,
                       "rows": page}
                ts0 = time.perf_counter()
                data = (json.dumps(msg) + "\n").encode()
                ser += time.perf_counter() - ts0
                await t.conn.send_raw(data)
        self._stage("serialize", ser)
        self._stage("demux", time.perf_counter() - td0 - ser)
        done = {
            "type": "done",
            "id": t.qid,
            "rows": len(rows),
            "seconds": payload["seconds"],
            "batched": batch.size,
            "batch_leader": batch.leader_id,
            "rungs": payload["rungs"],
            "degraded": payload["degraded"],
            "cached": bool(payload.get("cached", False)),
        }
        self._terminal(t, "done", done, payload=payload, batch=batch)
        await t.conn.send(done)

    async def _fail(self, t: _Ticket, exc: Exception) -> None:
        typed = ERR.classify(exc)
        name = type(typed if typed is not None else exc).__name__
        msg = {
            "type": "error", "id": t.qid, "error": name,
            "message": str(exc)[:500],
        }
        self._terminal(t, "error", msg)
        await t.conn.send(msg)

    def _terminal(self, t: _Ticket, status: str, message: Dict[str, Any],
                  payload: Optional[Dict[str, Any]] = None,
                  batch=None) -> None:
        """Record the query's terminal state for ``GET /queries/<id>``."""
        t.status = status
        QUERIES_TOTAL.inc(status=status)
        QUERY_SECONDS.observe(time.monotonic() - t.submitted_at)
        record: Dict[str, Any] = {
            "id": t.qid,
            "status": status,
            "query": t.query,
            "graph": t.graph_name,
            "tenant": t.tenant,
            "message": {k: v for k, v in message.items() if k != "type"},
        }
        if payload is not None:
            record.update(
                rows=len(payload["rows"]),
                seconds=payload["seconds"],
                execution_log=payload["execution_log"],
                rungs=payload["rungs"],
                degraded=payload["degraded"],
                compile_stats=payload["compile_stats"],
                profile=payload["profile"],
                cached=bool(payload.get("cached", False)),
            )
        if batch is not None:
            record.update(batched=batch.size, batch_leader=batch.leader_id)
        self._records[t.qid] = record
        while len(self._records) > _QUERY_LOG_MAX:
            self._records.popitem(last=False)
        self._tickets.pop(t.qid, None)

    async def _flush_caches(self) -> int:
        """Drop every cached result (``POST /cache/flush``). The cluster
        tier overrides this to also fan out to its workers."""
        return self.cache.flush()

    # -- HTTP observability surface --------------------------------------

    async def _handle_http(
        self, first: bytes, reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        # drain headers (we key off the request line only)
        while True:
            line = await reader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
        try:
            method, path, _ = first.decode("latin-1").split(" ", 2)
        except ValueError:
            method, path = "GET", "/"
        if path.split("?", 1)[0] == "/cache/flush":
            if method != "POST":
                # flushing is a state change: POST only. A GET (a crawler,
                # a stray browser tab, a monitoring probe) must never drop
                # the cache.
                status, ctype, body = (
                    "405 Method Not Allowed", "application/json",
                    json.dumps(
                        {"error": "/cache/flush requires POST"}
                    ).encode(),
                )
            else:
                # the one ASYNC route: the cluster tier fans the flush out
                # to its worker processes over the wire
                dropped = await self._flush_caches()
                status, ctype, body = (
                    "200 OK", "application/json",
                    json.dumps({"flushed": dropped}).encode(),
                )
        elif method == "POST":
            status, ctype, body = (
                "405 Method Not Allowed", "application/json",
                json.dumps({"error": f"no POST route {path!r}"}).encode(),
            )
        else:
            status, ctype, body = self._http_response(path)
        head = (
            f"HTTP/1.1 {status}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        )
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    def _http_response(self, path: str) -> Tuple[str, str, bytes]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            # VERBATIM session.metrics_text(): the golden test pins the
            # HTTP body byte-identical to the in-process text
            return (
                "200 OK",
                "text/plain; version=0.0.4",
                self.session.metrics_text().encode(),
            )
        if path.startswith("/queries/"):
            qid = path[len("/queries/"):]
            rec = self._records.get(qid)
            if rec is None and qid in self._tickets:
                t = self._tickets[qid]
                rec = {"id": qid, "status": t.status, "query": t.query,
                       "graph": t.graph_name, "tenant": t.tenant}
            if rec is None:
                return (
                    "404 Not Found", "application/json",
                    json.dumps({"error": f"unknown query {qid!r}"}).encode(),
                )
            return ("200 OK", "application/json", json.dumps(rec).encode())
        if path == "/cache":
            return (
                "200 OK", "application/json",
                json.dumps(self.cache.stats()).encode(),
            )
        if path == "/healthz":
            return (
                "200 OK", "application/json",
                json.dumps(
                    {"ok": True, "protocol": PROTOCOL_VERSION,
                     "graphs": sorted(self._graphs),
                     "running": self.scheduler.running,
                     "queued": self.scheduler.queued}
                ).encode(),
            )
        return (
            "404 Not Found", "application/json",
            json.dumps({"error": f"no route {path!r}"}).encode(),
        )
