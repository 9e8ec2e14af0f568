"""The engine-worker wire protocol, shared by router and worker.

One module owns three things the multi-process tier must agree on, so the
front end (``serve/router.py``), the worker processes
(``serve/worker.py``), and the single-process server (``serve/server.py``)
cannot drift:

* **framing** — newline-delimited JSON over a stream pair
  (``send_msg``/``read_msg``), plus ``request`` for the one-shot
  connect/ask/close round trip the router, supervisor pings, and canary
  probes all use. EOF mid-read surfaces as ``asyncio.IncompleteReadError``
  (an ``EOFError``) so ``errors.classify`` maps it to ``WorkerLost``.

* **the execute payload** — ``execute_payload`` runs ONE query on a warm
  session inside the caller's already-fresh context (request deadline and
  chaos schedule scoped in) and returns the JSON-safe result dict
  {rows, columns, seconds, execution_log, rungs, degraded, compile_stats,
  profile}. ``QueryServer._execute`` and the worker's execute op are both
  one-line wrappers over it — 'byte-identical rows across serving modes'
  stays a checkable property.

* **typed errors on the wire** — a worker failure travels as
  ``{"ok": false, "error": <type name>, "message": ...}``;
  ``raise_wire_error`` reconstructs the engine's typed exception on the
  router side so retry/shed/deadline decisions see real types, not
  strings.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from typing import Any, Dict, List, Optional

from .. import errors as ERR
from ..api import values as V
from ..runtime import faults as F
from ..runtime import guard as G


# canonical write sniff lives beside the write executor; re-exported here
# because every serving tier keys cache/batch/routing decisions off it
from ..relational.mutate import is_write_query  # noqa: F401


def json_value(v: Any) -> Any:
    """JSON-safe wire form of a Cypher value. Scalars pass through;
    structured and temporal values ride their deterministic Cypher text
    (``api.values.to_cypher_string`` — the TCK formatting), which is what
    makes 'byte-identical to serial execution' a checkable property."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v
    return V.to_cypher_string(v)


def encode_rows(rows, columns) -> List[Dict[str, Any]]:
    return [{c: json_value(r.get(c)) for c in columns} for r in rows]


def execute_payload(
    session,
    graph,
    query: str,
    parameters: Optional[Dict[str, Any]] = None,
    *,
    deadline_s: Optional[float] = None,
    faults: Optional[str] = None,
) -> Dict[str, Any]:
    """One engine execution -> the wire payload. Runs BLOCKING engine work;
    callers put it on a worker lane (``SessionPool.run``) inside a fresh
    ``contextvars.Context``. ``deadline_s`` is the REMAINING budget (queue
    wait already deducted); ``faults`` is a client-scoped chaos schedule."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if deadline_s:
            stack.enter_context(G.request_deadline(deadline_s))
        if faults is not None:
            stack.enter_context(F.scoped_spec(faults))
        result = session.cypher(query, parameters or {}, graph=graph)
        records = result.records
        rows = records.collect() if records is not None else []
        columns = list(records.columns) if records is not None else []
    log = list(result.execution_log)
    rungs = [e["rung"] for e in log]
    payload = {
        "rows": encode_rows(rows, columns),
        "columns": columns,
        "seconds": round(time.perf_counter() - t0, 6),
        "execution_log": log,
        "rungs": rungs,
        "degraded": bool(rungs and rungs[-1] != G.RUNG_DEVICE),
        "compile_stats": result.compile_stats,
        "profile": result.profile(execute=False).to_dict(),
    }
    write_stats = getattr(result, "write_stats", None)
    if write_stats is not None:
        payload["write"] = write_stats
    return payload


def open_stream(
    session,
    graph,
    query: str,
    parameters: Optional[Dict[str, Any]] = None,
    *,
    deadline_s: Optional[float] = None,
    faults: Optional[str] = None,
    page_rows: int = 256,
) -> "tuple[Dict[str, Any], RowStream]":
    """One engine execution -> ``(meta, RowStream)`` WITHOUT materializing
    the result rows: device execution runs here (inside the deadline and
    chaos scopes, same as ``execute_payload``), but row decode is deferred
    to the returned stream's ``next_page`` pulls, one bounded chunk at a
    time. ``meta`` carries everything ``execute_payload`` does except
    ``rows``, plus ``total_rows``. BLOCKING engine work — callers put both
    this call and every ``next_page`` on a worker lane
    (``SessionPool.run``)."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if deadline_s:
            stack.enter_context(G.request_deadline(deadline_s))
        if faults is not None:
            stack.enter_context(F.scoped_spec(faults))
        result = session.cypher(query, parameters or {}, graph=graph)
        records = result.records
    columns = list(records.columns) if records is not None else []
    log = list(result.execution_log)
    rungs = [e["rung"] for e in log]
    meta = {
        "columns": columns,
        "total_rows": int(records.size) if records is not None else 0,
        "seconds": round(time.perf_counter() - t0, 6),
        "execution_log": log,
        "rungs": rungs,
        "degraded": bool(rungs and rungs[-1] != G.RUNG_DEVICE),
        "compile_stats": result.compile_stats,
        "profile": result.profile(execute=False).to_dict(),
    }
    return meta, RowStream(records, columns, page_rows=page_rows)


class RowStream:
    """Pull-based source of ENCODED row pages over a live query result.

    Decodes one bounded chunk at a time (``guard.stream_chunk_rows()``
    rows via ``records.iter_chunks``) and serves at most ``page_rows``
    wire-encoded rows per ``next_page()`` call — peak host memory is
    O(chunk), independent of the total result size, which is what lets a
    10M-row result stream under a fixed ceiling. Decode is BLOCKING host
    work: drive ``next_page`` from a worker lane, never the event loop."""

    def __init__(self, records, columns: List[str], *, page_rows: int = 256):
        self._columns = list(columns)
        self._page_rows = max(int(page_rows), 1)
        self._chunks = (
            records.iter_chunks(G.stream_chunk_rows())
            if records is not None
            else iter(())
        )
        self._buf: List[Any] = []
        self._pos = 0
        self.rows_sent = 0

    def next_page(self) -> Optional[List[Dict[str, Any]]]:
        """The next encoded page, or None once the result is exhausted."""
        while self._pos >= len(self._buf):
            nxt = next(self._chunks, None)
            if nxt is None:
                return None
            self._buf = nxt
            self._pos = 0
        hi = min(self._pos + self._page_rows, len(self._buf))
        page = encode_rows(self._buf[self._pos:hi], self._columns)
        self.rows_sent += len(page)
        self._pos = hi
        return page

    def close(self) -> None:
        """Drop the buffered chunk and the underlying iterator (early
        client close / cancel)."""
        self._chunks = iter(())
        self._buf = []
        self._pos = 0


class ListPages:
    """``RowStream``-shaped pager over ALREADY-ENCODED rows — the cluster
    front end streams a router payload it necessarily received whole (the
    worker wire protocol is one-shot), so the protocol stays identical to
    the single-process server even though the ceiling there is the full
    payload."""

    def __init__(self, rows: List[Dict[str, Any]], *, page_rows: int = 256):
        self._rows = rows
        self._page_rows = max(int(page_rows), 1)
        self._pos = 0
        self.rows_sent = 0

    def next_page(self) -> Optional[List[Dict[str, Any]]]:
        if self._pos >= len(self._rows):
            return None
        hi = min(self._pos + self._page_rows, len(self._rows))
        page = self._rows[self._pos:hi]
        self.rows_sent += len(page)
        self._pos = hi
        return page

    def close(self) -> None:
        self._rows = []
        self._pos = 0


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


async def send_msg(writer: asyncio.StreamWriter, obj: Dict[str, Any]) -> None:
    writer.write((json.dumps(obj) + "\n").encode())
    await writer.drain()


async def read_msg(
    reader: asyncio.StreamReader, timeout: Optional[float] = None
) -> Dict[str, Any]:
    """Read one framed message. EOF raises ``asyncio.IncompleteReadError``
    (an ``EOFError`` — ``errors.classify`` maps it to ``WorkerLost``);
    a hung peer raises ``TimeoutError`` when ``timeout`` is given."""
    if timeout is not None:
        line = await asyncio.wait_for(reader.readline(), timeout)
    else:
        line = await reader.readline()
    if not line:
        raise asyncio.IncompleteReadError(partial=b"", expected=1)
    return json.loads(line)


async def request(
    host: str,
    port: int,
    msg: Dict[str, Any],
    timeout: Optional[float] = None,
) -> Dict[str, Any]:
    """One connect/ask/read/close round trip against a worker. Transport
    failures propagate raw (``OSError``/``EOFError``/``TimeoutError``) —
    the caller decides whether that means ``WorkerLost`` (router) or just
    an unhealthy probe (supervisor)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        await send_msg(writer, msg)
        return await read_msg(reader, timeout=timeout)
    finally:
        writer.close()
        with contextlib.suppress(Exception):  # fault-ok: teardown only
            await writer.wait_closed()


def raise_wire_error(name: str, message: str) -> None:
    """Re-raise a worker's ``{"ok": false}`` reply as the engine's typed
    exception (by taxonomy class name), so the router and clients see the
    same types a single-process server raises. Unknown names — a planner
    bug's ValueError, say — surface as ``RuntimeError`` carrying both."""
    cls = getattr(ERR, name, None)
    if isinstance(cls, type) and issubclass(cls, ERR.TpuCypherError):
        raise cls(message)
    raise RuntimeError(f"{name}: {message}")
