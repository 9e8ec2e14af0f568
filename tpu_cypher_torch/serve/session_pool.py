"""Warm-session pool: one warm ``CypherSession``, isolated per-query lanes.

The device is process-global, and so are the things that make the engine
fast under traffic — the kernel builds, the per-graph CSR indexes, the
plan cache. A "pool" of real sessions would fracture all of them, so the
pool holds exactly ONE warm ``CypherSession`` and multiplexes concurrent
queries onto a bounded thread pool instead (the host side of a query is
synchronous Python; asyncio alone cannot overlap it).

What the pool guarantees per query is ISOLATION:

* each query runs inside a **fresh** ``contextvars.Context``
  (``Context().run``, not a copy of the caller's), so every context-local
  piece of engine state — the obs trace span tree, metric scopes, the
  execution guard's deadline and rung, scoped fault schedules — starts
  empty and dies with the query;
* on a card, each pool thread runs every query under a CUDA stream of its
  own, created once per thread. Kernel scratch is kept per (kernel,
  device, stream) (``hopper/_build.scratch_ptr``), and several tiers are
  more than one launch (``expand_rows``' state and merge launches,
  ``join_probe``'s build and probe): on one shared stream two queries'
  launches would interleave and one's state launch would overwrite
  another's scratch before its merge read it. A lane waits for its stream
  before it hands a result back, so a tensor made on one lane's stream is
  complete before another lane reads it; caches shared across lanes are
  fenced where they are filled (``backend/cuda/device.fence``).
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..backend.cuda import device as _device
from ..relational.session import CypherSession, PropertyGraph


class SessionPool:
    """One warm engine, N isolated execution lanes.

    ``workers`` bounds how many queries can be ON a worker thread at once;
    the admission scheduler (``serve/scheduler.py``) bounds how many are
    admitted, so the pool is sized to match ``max_concurrent``.
    """

    def __init__(
        self,
        session: Optional[CypherSession] = None,
        workers: int = 8,
    ):
        self.session = session if session is not None else CypherSession.cuda()
        self._executor = ThreadPoolExecutor(
            max_workers=max(int(workers), 1),
            thread_name_prefix="tpu-cypher-serve",
        )
        self._lane = threading.local()
        # thread name -> raw handle of its stream (introspection: the
        # serving smoke checks that concurrent lanes ran on distinct ones)
        self._streams: Dict[str, int] = {}

    # -- warmup ----------------------------------------------------------

    def warmup(
        self,
        queries: Sequence[str],
        graph: Optional[PropertyGraph] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Run the corpus ahead of traffic (``CypherSession.warmup``): the
        kernels build, the graph's CSR indexes fill and the plans cache
        before the first client arrives."""
        return self.session.warmup(queries, graph=graph, parameters=parameters)

    # -- isolated execution ----------------------------------------------

    def _stream(self) -> Optional["torch.cuda.Stream"]:
        """This lane's CUDA stream, created on the thread's first query;
        None when the backend runs on the CPU."""
        dev = _device.get()
        if dev.type != "cuda":
            return None
        s = getattr(self._lane, "stream", None)
        if s is None:
            s = self._lane.stream = torch.cuda.Stream(device=dev)
            self._streams[threading.current_thread().name] = s.cuda_stream
        return s

    def lane_streams(self) -> Dict[str, int]:
        """{pool thread name: raw CUDA stream handle} of the lanes that ran
        a query on the card."""
        return dict(self._streams)

    def _isolated(self, fn: Callable[[], Any]) -> Any:
        # a FRESH context (not a snapshot of the submitting coroutine's):
        # every engine contextvar starts at its default
        ctx = contextvars.Context()
        stream = self._stream()
        if stream is None:
            return ctx.run(fn)
        with torch.cuda.stream(stream):
            try:
                return ctx.run(fn)
            finally:
                stream.synchronize()

    async def run(self, fn: Callable[[], Any]) -> Any:
        """Run blocking engine work on a worker thread, inside a fresh
        ``contextvars.Context`` and on the thread's stream; awaitable from
        the event loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, self._isolated, fn)

    def close(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)
