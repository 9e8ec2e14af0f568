"""The engine-worker process: one warm session, expendable by design.

``python -m tpu_cypher_torch.serve.worker`` is what the supervisor
(``serve/supervisor.py``) actually spawns. Each worker is a full engine in
its own OS process — planner, CUDA context, kernel libraries, replicated
graphs — so a native device abort (a sticky CUDA error, an illegal
address) costs ONE worker, not the serving tier. What the workers share
is on disk: the kernel libraries (built once, under a file lock, by the
first worker to need them) and the WAL files of the mutable graphs.

Boot protocol (stdin/stdout, so no ports need pre-agreement):

1. parent writes ONE config JSON line to stdin::

       {"worker_id": "w0", "host": "127.0.0.1", "device": "cuda",
        "graphs": {"g": "CREATE (a:Person ...)"},
        "warmup": {"g": ["MATCH ...", ...]}, "wal_dir": "/path/wal"}

2. worker does ALL blocking setup synchronously — session on
   ``device`` (``"cuda"`` unless the config says ``"cpu"``), the kernel
   build on a card, graph replicas built from the CREATE queries, warmup —
   then binds an ephemeral TCP port and prints ONE readiness line to
   stdout::

       {"ready": true, "port": 41234, "pid": 7, "worker": "w0",
        "warmup": {"queries": n, "compiles": c, ...}}

   Readiness is gated on setup BY CONSTRUCTION: without a card (and
   without ``"cpu"`` in the config), or with a kernel that does not
   build, the worker exits before the line, the supervisor's
   ``wait_ready`` fails, and nothing serves on the host instead.

3. thereafter the worker speaks the ``serve/wire.py`` framing on its TCP
   port: ``execute`` (one query per request, typed errors by name),
   ``ping`` (liveness + inflight/draining + peak device memory), ``drain``
   (finish in-flight, refuse new, exit 0). SIGTERM means ``drain``.

The worker also ARMS the ``crash`` fault kind (``runtime/faults.py``):
``crash@site`` specs ``os._exit`` the process here — and only here — so
chaos tests can deterministically kill a worker mid-query.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import sys
from typing import Any, Dict, Optional

import torch

from .. import errors as ERR
from ..backend.cuda import device as _device
from ..relational.session import CypherSession
from ..runtime import faults as F
from ..storage.wal import wal_directory
from . import wire
from .batching import batch_key
from .result_cache import ResultCache, graph_fingerprint
from .session_pool import SessionPool


class EngineWorker:  # shared-by: loop
    """The async half of a worker: TCP service over one warm session.

    All engine execution rides ``SessionPool`` lanes (fresh contextvars
    context per query, exactly like the single-process server); everything
    on this class itself is event-loop-affine."""

    def __init__(self, worker_id: str, session: CypherSession, graphs,
                 host: str = "127.0.0.1", lanes: int = 4):
        self.worker_id = worker_id
        self.pool = SessionPool(session, workers=lanes)
        self.graphs = graphs
        # per-worker result cache: catches repeats the front end's cache
        # missed (restart, retry/hedge landing here). Fingerprints are
        # computed at boot — graph replicas are immutable for the
        # worker's lifetime
        self.cache = ResultCache()
        self._fingerprints = {
            name: graph_fingerprint(session, g) for name, g in graphs.items()
        }
        self.host = host
        self.port = 0
        self.inflight = 0
        self.draining = False
        self._idle = asyncio.Event()
        self._idle.set()
        self._server: Optional[asyncio.base_events.Server] = None

    # -- lifecycle -------------------------------------------------------

    async def serve(self, warmup_stats: Dict[str, Any]) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, 0
        )
        self.port = self._server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        # SIGTERM is the drain signal (docs/serving.md); SIGKILL is the
        # crash we are built to survive, so it gets no handler
        loop.add_signal_handler(signal.SIGTERM, self.begin_drain)
        # the readiness line: the parent's wait_ready() blocks on this
        print(json.dumps({
            "ready": True, "port": self.port, "pid": os.getpid(),
            "worker": self.worker_id, "warmup": warmup_stats,
        }), flush=True)
        try:
            while not (self.draining and self.inflight == 0):
                self._idle.clear()
                await self._idle.wait()
        finally:
            self._server.close()
            await self._server.wait_closed()
            self.pool.close()

    def begin_drain(self) -> None:
        self.draining = True
        self._idle.set()

    # -- the wire --------------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        try:
            while True:
                try:
                    msg = await wire.read_msg(reader)
                except (EOFError, ConnectionError, OSError):
                    break  # fault-ok: peer closed; requests are one-shot
                await wire.send_msg(writer, await self._dispatch(msg))
        except (ConnectionError, OSError):
            pass  # fault-ok: router vanished mid-reply; it will retry
        finally:
            writer.close()
            with contextlib.suppress(Exception):  # fault-ok: teardown only
                await writer.wait_closed()

    async def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "pong": True, "worker": self.worker_id,
                    "inflight": self.inflight, "draining": self.draining,
                    "peak_memory_bytes": _peak_memory_bytes()}
        if op == "drain":
            self.begin_drain()
            return {"ok": True, "draining": True, "inflight": self.inflight}
        if op == "execute":
            return await self._op_execute(msg)
        if op == "cache_flush":
            return {"ok": True, "flushed": self.cache.flush()}
        return {"id": msg.get("id"), "ok": False, "error": "ProtocolError",
                "message": f"unknown op {op!r}"}

    async def _op_execute(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        qid = msg.get("id")
        if self.draining:
            return {"id": qid, "ok": False, "error": "AdmissionRejected",
                    "message": "worker is draining"}
        graph = self.graphs.get(msg.get("graph"))
        if graph is None:
            return {"id": qid, "ok": False, "error": "UnknownGraph",
                    "message": f"graph {msg.get('graph')!r} not replicated "
                    f"(have: {sorted(self.graphs)})"}
        # chaos-injected and deadline-carrying requests never touch the
        # cache — same exclusion as the front end's (client-scoped state)
        key = None
        fp = self._fingerprints.get(msg.get("graph"), "")
        if msg.get("faults") is None and not msg.get("deadline_s"):
            key = batch_key(
                self.pool.session, msg["query"], graph,
                msg.get("parameters") or {},
            )
            hit = self.cache.lookup(key, fp)
            if hit is not None:
                return {"id": qid, "ok": True, "payload": hit}
        self.inflight += 1
        try:
            payload = await self.pool.run(
                lambda: self._execute(graph, msg)
            )
            refreshed = payload.pop("_wal_refresh_fingerprint", None)
            if refreshed is not None:
                # the pool-lane execution replayed WAL batches; apply the
                # advanced fingerprint here, on the loop that owns it
                self._fingerprints[msg.get("graph")] = refreshed
            write_stats = payload.get("write")
            if write_stats and write_stats.get("fingerprint"):
                # the committed write advanced the graph's chained
                # fingerprint: refresh so our cached reads stop matching
                self._fingerprints[msg.get("graph")] = (
                    write_stats["fingerprint"]
                )
            if key is not None:
                self.cache.store(key, fp, payload)
            return {"id": qid, "ok": True, "payload": payload}
        except Exception as exc:  # fault-ok: surfaced typed to the router
            typed = ERR.classify(exc)
            return {
                "id": qid, "ok": False,
                "error": type(typed if typed is not None else exc).__name__,
                "message": str(exc)[:500],
            }
        finally:
            self.inflight -= 1
            self._idle.set()

    def _execute(self, graph, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One engine execution on a pool lane. A read against a mutable
        graph first refreshes from the shared WAL (read-your-writes on a
        replica that is not the current writer; a no-op for the writer and
        for immutable graphs). The refreshed fingerprint travels back in
        the payload — ``self._fingerprints`` is loop-owned state, so the
        write-back happens in ``_op_execute`` on the event loop, never on
        a pool lane."""
        base = getattr(graph, "_graph", graph)
        refresh = getattr(base, "refresh", None)
        refreshed = None
        if callable(refresh) and refresh():
            refreshed = base.fingerprint()
        payload = wire.execute_payload(
            self.pool.session, graph, msg["query"],
            msg.get("parameters"),
            deadline_s=msg.get("deadline_s"),
            faults=msg.get("faults"),
        )
        if refreshed is not None:
            payload["_wal_refresh_fingerprint"] = refreshed
        return payload


def _peak_memory_bytes() -> int:
    """This process's peak device memory (0 on the CPU)."""
    dev = _device.get()
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def main() -> None:
    cfg = json.loads(sys.stdin.readline())
    # only an expendable worker process ever arms process-killing faults
    F.enable_crash()
    # ALL blocking setup happens here, synchronously, BEFORE the loop
    # exists: session boot, kernel build, graph replica construction,
    # corpus warmup. Printing READY after this is what makes readiness
    # setup-gated: a missing card (DeviceUnavailable) or a kernel that
    # does not build raises here, and the process exits without it.
    session = CypherSession.cuda(device=cfg.get("device") or "cuda")
    if _device.get().type == "cuda":
        from ..backend.cuda.hopper import _build

        _build.build_all()
    # graphs marked mutable boot as delta-CSR stores with a WAL in the
    # shared WAL directory: the CREATE-query replay rebuilds the base,
    # then attach_wal replays every committed batch — a SIGKILLed worker
    # restarts with exactly the committed writes (docs/mutation.md)
    mutable_names = set(cfg.get("mutable") or ())
    wal_dir = wal_directory(cfg.get("wal_dir"))
    graphs = {}
    for name, create_query in (cfg.get("graphs") or {}).items():
        if name in mutable_names:
            from ..storage import mutable_graph_from_create_query

            wal_path = (
                os.path.join(wal_dir, f"{name}.wal") if wal_dir else None
            )
            graphs[name] = mutable_graph_from_create_query(
                session, create_query, name=name, wal_path=wal_path
            )
        else:
            graphs[name] = session.create_graph_from_create_query(
                create_query
            )
    _device.fence()  # the lanes read the replicas on streams of their own
    warmup_stats: Dict[str, Any] = {"queries": 0, "compiles": 0}
    for graph_name, queries in (cfg.get("warmup") or {}).items():
        stats = session.warmup(queries, graph=graphs[graph_name])
        warmup_stats["queries"] += stats.get("queries", 0)
        warmup_stats["compiles"] += stats.get("compiles", 0)
    worker = EngineWorker(
        str(cfg.get("worker_id") or "w?"), session, graphs,
        host=str(cfg.get("host") or "127.0.0.1"),
        lanes=int(cfg.get("lanes") or 4),
    )
    asyncio.run(worker.serve(warmup_stats))


if __name__ == "__main__":
    main()
