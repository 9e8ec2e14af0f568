"""Per-query execution guard: the deadline and the rung.

The guard is the context a query executes under. It is context-local
(``contextvars``) so concurrent/interleaved queries — threads, asyncio,
nested view execution — each see their own deadline and rung.

* **Deadline**: ``CypherSession.cuda(query_deadline_seconds=..)`` /
  ``TPU_CYPHER_QUERY_DEADLINE_S``. Checked at every named fault site
  (``runtime.faults.fault_point``) — the natural interruption points
  between device launches. Expiry raises the TERMINAL ``QueryTimeout``.

* **Rung**: the reference degrades a faulted query down a ladder of rungs
  (exact buckets, chunked materializes, the host oracle). The port runs
  every query once on ``RUNG_DEVICE`` and lets a fault reach the caller
  typed (``relational/session.py``), so a kernel or device fault is never
  answered on the host.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

from ..errors import QueryTimeout
from ..obs.metrics import REGISTRY as _REGISTRY
from ..utils.config import DEADLINE_S

RUNG_DEVICE = "device"

# DEADLINE_S (0 = none; session option overrides the env) is declared in
# the typed registry (utils/config.py) and aliased here for its call sites.

# which rungs actually executed, fleet-wide (the per-query view is
# the ``execute`` trace span's ``rung`` attr and ``result.execution_log``)
LADDER_ACTIVATIONS = _REGISTRY.counter(
    "tpu_cypher_ladder_activations_total",
    "execution-guard activations per ladder rung",
    labels=("rung",),
)


class ExecutionGuard:
    """State for ONE query execution attempt. Per-site
    tracing rides the obs span tree (``obs.trace.note_site``), not the
    guard."""

    __slots__ = ("deadline_at", "rung")

    def __init__(self, deadline_at: Optional[float], rung: str):
        self.deadline_at = deadline_at
        self.rung = rung

    def check(self, site: str) -> None:
        if self.deadline_at is not None and time.monotonic() > self.deadline_at:
            raise QueryTimeout(
                f"query deadline exceeded at site {site!r}", site=site
            )


_CURRENT: contextvars.ContextVar[Optional[ExecutionGuard]] = (
    contextvars.ContextVar("tpu_cypher_guard", default=None)
)

# per-REQUEST deadline override (seconds), context-local: the serving layer
# (serve/) activates one around each client query so interleaved coroutines
# each see their own deadline. Resolution order in the session
# (relational/session.py): session option > request override > env default.
_REQUEST_DEADLINE_S: contextvars.ContextVar[Optional[float]] = (
    contextvars.ContextVar("tpu_cypher_request_deadline", default=None)
)


def request_deadline_s() -> Optional[float]:
    """The context-local per-request deadline (seconds), or None when no
    ``request_deadline`` scope is open in this context."""
    return _REQUEST_DEADLINE_S.get()


class request_deadline:
    """``with guard.request_deadline(1.5):`` — scope a per-request deadline
    over every query executed in this context. 0/None clears (queries fall
    back to the session/env deadline). Context-local, so concurrent server
    requests never see each other's deadlines."""

    def __init__(self, seconds: Optional[float]):
        self._seconds = float(seconds) if seconds and seconds > 0 else None
        self._token = None

    def __enter__(self) -> "request_deadline":
        self._token = _REQUEST_DEADLINE_S.set(self._seconds)
        return self

    def __exit__(self, *exc) -> None:
        _REQUEST_DEADLINE_S.reset(self._token)


def current() -> Optional[ExecutionGuard]:
    return _CURRENT.get()


def current_rung() -> str:
    g = _CURRENT.get()
    return g.rung if g is not None else RUNG_DEVICE


def check_deadline(site: str) -> None:
    g = _CURRENT.get()
    if g is not None:
        g.check(site)


class activate:
    """``with guard.activate(rung, deadline_seconds):`` — install a guard
    for one execution attempt. ``deadline_at`` is an ABSOLUTE monotonic
    stamp; resolving the session/env deadline config
    is the caller's job — ``relational/session.py`` is the single
    resolution point."""

    def __init__(
        self,
        rung: str = RUNG_DEVICE,
        deadline_seconds: Optional[float] = None,
        deadline_at: Optional[float] = None,
    ):
        if deadline_at is None and deadline_seconds and deadline_seconds > 0:
            deadline_at = time.monotonic() + float(deadline_seconds)
        self._guard = ExecutionGuard(deadline_at, rung)
        self._token = None

    def __enter__(self) -> ExecutionGuard:
        LADDER_ACTIVATIONS.inc(rung=self._guard.rung)
        self._token = _CURRENT.set(self._guard)
        return self._guard

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)
