"""Per-query trace spans: a context-local span tree from frontend to kernels.

A ``QueryTrace`` is opened per query by ``relational/session.py`` and nested
per pipeline phase (parse -> ir -> logical -> relational -> execute) and per
relational operator (``relational/ops.py`` wraps every lazy ``table`` pull in
an operator span). Inside operators, kernel dispatches
(``backend/cuda/hopper/dispatch.launch``) open kernel spans, the bucket
lattice (``backend/cuda/bucketing.round_size``) annotates the enclosing
span with padded-vs-true row counts, and every device->host sync of the
backend sits inside a ``sync`` span (``sync(site)``), which times the
host's wait for the device plus the copy. The finished tree attaches to
``CypherResult`` as ``result.profile()`` (rendered tree + JSON): the
``PROFILE``-style sibling of the ``EXPLAIN``-style ``result.plans``.
The traces of the last ``PROFILED`` queries opened while a
``torch.profiler`` recorded stay reachable through ``profiled_traces()``,
results dropped or not.

Costs, by design:

* spans record HOST wall time (``perf_counter``) and never sync the
  device: an operator span measures the enqueue of asynchronous CUDA
  work, and the ``sync:<site>`` spans inside it hold the waits. A
  ``kernel`` span that launched on the card also carries a pair of CUDA
  timing events around each of its ctypes launches
  (``hopper/dispatch.device_timed``); ``Span.device_seconds`` reads them
  only once the device has passed the last, so reading a profile never
  waits, and a later launch takes the pair back for its own;
* when no trace is active every instrumentation point is one contextvar
  read returning a shared null span (a ``sync`` span still counts its
  site in ``tpu_cypher_host_sync_total``);
* while a ``torch.profiler`` records, each span also opens a
  ``record_function("tpu_cypher:<kind>:<name>")`` region, so the same tree,
  sync waits included, shows up region-named on the device trace's own
  clock. Profile with one's own ``torch.profiler.profile(...)``; nothing
  here starts one.

Context-locality: the active trace/span ride ``contextvars``, so
interleaved queries (threads, asyncio, nested view execution) each grow
their own tree — the same isolation discipline as the metrics scopes and
the execution guard.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import json
import sys
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import metrics as M

SCHEMA_VERSION = 1

HOST_SYNC = M.REGISTRY.counter(
    "tpu_cypher_host_sync_total",
    "device->host syncs, per sync site (obs.trace.sync)",
    labels=("site",),
)


class Span:
    """One node of the tree: a named, timed region with attributes."""

    __slots__ = ("span_id", "name", "kind", "attrs", "t0", "seconds",
                 "status", "children", "events", "_device_s")

    def __init__(self, span_id: int, name: str, kind: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self.span_id = span_id
        self.name = name
        # "query" | "phase" | "operator" | "kernel" | "sync" | "span"
        self.kind = kind
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.t0: Optional[float] = None
        self.seconds: float = 0.0
        self.status = "ok"
        self.children: List["Span"] = []
        # [(start, end, device index)]: CUDA timing events around each
        # launch of a kernel span, until ``device_events`` takes them back;
        # ``_device_s`` keeps the seconds of the pairs taken back
        self.events: Optional[List[Tuple[Any, Any, int]]] = None
        self._device_s: Optional[float] = None

    @property
    def self_seconds(self) -> float:
        """Wall time minus child spans — the per-operator cost that sums
        (within tolerance) to the parent's total."""
        return max(self.seconds - sum(c.seconds for c in self.children), 0.0)

    def add_events(self, events: Tuple[Any, Any, int]) -> None:
        """Keep one launch's (start, end, device index) timing events."""
        with _EVENTS_LOCK:
            if self.events is None:
                self.events = []
                _EVENT_HOLDERS.append(self)
            self.events.append(events)

    @property
    def device_seconds(self) -> Optional[float]:
        """Device seconds between the span's CUDA timing events, summed over
        its launches (a kernel span on the ``kernel`` tier), or None: no
        events were recorded, or the device has not yet passed the last
        one. Never waits, and gives nothing back: ``device_events`` takes
        the pairs back once the device has passed them, and keeps their
        seconds here."""
        with _EVENTS_LOCK:
            ev = self.events
            if not ev:
                return self._device_s
            if not ev[-1][1].query():  # one stream: the last is the latest
                return None
            return (self._device_s or 0.0) + _elapsed_s(ev)

    def note(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def count(self, key: str, amount: int = 1) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + amount

    # per-span cap on retained (true, padded) pairs: enough for every
    # rounding a single operator performs, bounded against pathological
    # loops so a span never grows without limit
    ROWS_PAIRS_CAP = 64

    def add_rows(
        self,
        true_rows: int,
        padded_rows: int,
        shards: int = 1,
        local_true: Optional[int] = None,
        local_padded: Optional[int] = None,
        exact: bool = False,
    ) -> None:
        """Accumulate a padded-vs-true row count from the bucket lattice.

        Besides the running sums, the individual ``(true, padded)`` pairs
        are retained (bounded) so the lattice's predictions
        (``bucketing.predict_padded``) can be checked against what it
        actually produced, per rounding, not just in aggregate. Under a mesh the lattice rounds per shard: the span
        additionally records the shard count and the per-shard
        ``(local true extent, local padded)`` pairs, the sharded analog
        of the same static-vs-runtime agreement gate. ``exact``: a
        materialize that sizes its lanes exactly in every bucket mode
        (``bucketing.exact_size``); it adds to the sums, and its pairs go
        to ``exact_rows_pairs``, so ``rows_pairs`` holds the lattice's
        roundings only."""
        self.attrs["rows_true"] = self.attrs.get("rows_true", 0) + int(true_rows)
        self.attrs["rows_padded"] = (
            self.attrs.get("rows_padded", 0) + int(padded_rows)
        )
        pairs = self.attrs.setdefault(
            "exact_rows_pairs" if exact else "rows_pairs", []
        )
        if len(pairs) < self.ROWS_PAIRS_CAP:
            pairs.append([int(true_rows), int(padded_rows)])
        if shards > 1 and local_true is not None and local_padded is not None:
            self.attrs["shards"] = int(shards)
            spairs = self.attrs.setdefault("shard_rows_pairs", [])
            if len(spairs) < self.ROWS_PAIRS_CAP:
                spairs.append([int(local_true), int(local_padded)])

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "span_id": self.span_id,
            "name": self.name,
            "kind": self.kind,
            "seconds": round(self.seconds, 6),
            "self_seconds": round(self.self_seconds, 6),
            "status": self.status,
        }
        if self.events is not None or self._device_s is not None:
            dev = self.device_seconds
            out["device_ms"] = None if dev is None else round(dev * 1e3, 6)
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class _NullSpan:
    """The no-trace fast path: every mutator is a no-op."""

    __slots__ = ()

    def note(self, key, value):  # noqa: D401
        pass

    def count(self, key, amount=1):
        pass

    def add_rows(self, true_rows, padded_rows, shards=1, local_true=None,
                 local_padded=None):
        pass


NULL_SPAN = _NullSpan()


# the traces of the last PROFILED queries opened while a torch profiler
# recorded, oldest first: where nothing profiles, no query's spans outlive
# its result
PROFILED = 4096
_PROFILED: Deque["QueryTrace"] = collections.deque(maxlen=PROFILED)


def profiled_traces() -> List["QueryTrace"]:
    """The traces of the last ``PROFILED`` queries opened while a
    ``torch.profiler`` recorded, oldest first, whether or not anyone kept
    their results: the span trees of a profiled window, read once it has
    closed, beside the device trace."""
    return list(_PROFILED)


class QueryTrace:
    """The span tree for ONE query: a root plus per-phase children. The
    root's duration is the SUM of its phase durations (a lazy result may
    sit unpulled for minutes between planning and execution — idle wall
    time between phases is not query time)."""

    def __init__(self, name: str = "query", **attrs):
        self._ids = itertools.count(1)
        self.root = Span(0, name, "query", attrs)
        # deepest span open when the current execution attempt failed —
        # reset per ladder attempt, read into ``execution_log`` entries
        self.failed_span_id: Optional[int] = None
        if _profiler_enabled():
            _PROFILED.append(self)

    # -- aggregate views ---------------------------------------------------

    @property
    def total_seconds(self) -> float:
        return sum(c.seconds for c in self.root.children)

    def phase_seconds(self) -> Dict[str, float]:
        """{phase name: summed seconds} over the root's direct children
        (retried phases, e.g. ladder execute attempts, sum)."""
        out: Dict[str, float] = {}
        for c in self.root.children:
            out[c.name] = out.get(c.name, 0.0) + c.seconds
        return out

    def spans(self) -> List[Span]:
        """Every span, preorder."""
        out: List[Span] = []
        stack = [self.root]
        while stack:
            s = stack.pop()
            out.append(s)
            stack.extend(reversed(s.children))
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "total_seconds": round(self.total_seconds, 6),
            "root": self.root.to_dict(),
        }


# the active trace + innermost open span in THIS context
_TRACE: contextvars.ContextVar[Optional[QueryTrace]] = contextvars.ContextVar(
    "tpu_cypher_trace", default=None
)
_SPAN: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tpu_cypher_span", default=None
)


def current_trace() -> Optional[QueryTrace]:
    return _TRACE.get()


def current_span() -> Optional[Span]:
    return _SPAN.get()


def enabled() -> bool:
    return _TRACE.get() is not None


def note(key: str, value: Any) -> None:
    sp = _SPAN.get()
    if sp is not None:
        sp.attrs[key] = value


def note_rows(
    true_rows: int,
    padded_rows: int,
    shards: int = 1,
    local_true: Optional[int] = None,
    local_padded: Optional[int] = None,
    exact: bool = False,
) -> None:
    """Record a bucket-lattice materialize on the innermost open span
    (plus the per-shard extent pair while a mesh is active); ``exact``
    marks a materialize sized exactly in every mode."""
    sp = _SPAN.get()
    if sp is not None:
        sp.add_rows(
            true_rows, padded_rows,
            shards=shards, local_true=local_true, local_padded=local_padded,
            exact=exact,
        )


# CUDA timing events: the free (start, end) pairs per device index, and the
# kernel spans holding pairs, oldest first. A span is held from its first
# pair until the device has passed its last one and a launch needs a pair:
# then its pairs go back to the pool, and the span keeps their seconds. So
# the holders never outnumber the pairs, and on one stream a new pair is
# made only while every other one is in flight.
_EVENTS_LOCK = threading.Lock()
_EVENT_POOL: Dict[int, List[Tuple[Any, Any]]] = {}
_EVENT_HOLDERS: Deque[Span] = collections.deque()


def _elapsed_s(events: List[Tuple[Any, Any, int]]) -> float:
    return sum(start.elapsed_time(end) for start, end, _ in events) / 1e3


def device_events(index: int) -> Tuple[Any, Any, int]:
    """A pair of CUDA timing events for device ``index``, as
    ``Span.add_events`` takes them: from its pool, refilled from the oldest
    spans' pairs the device has passed, and new ones when none is free."""
    with _EVENTS_LOCK:
        pool = _EVENT_POOL.setdefault(index, [])
        while not pool and _EVENT_HOLDERS:
            oldest = _EVENT_HOLDERS[0]
            ev = oldest.events
            if not ev[-1][1].query():
                break  # still in flight: the younger ones are too
            oldest._device_s = (oldest._device_s or 0.0) + _elapsed_s(ev)
            oldest.events = None
            _EVENT_HOLDERS.popleft()
            for start, end, i in ev:
                _EVENT_POOL.setdefault(i, []).append((start, end))
        if pool:
            start, end = pool.pop()
            return start, end, index
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), index


def _profiler_enabled() -> bool:
    """True while a ``torch.profiler`` records (none can before torch is
    imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class activate:
    """``with activate(trace):`` — make ``trace`` the context's active
    trace, its root the innermost span. Used once per pipeline run AND
    re-entered by the lazy execution ladder / ``collect`` (a CypherResult
    is planned now, pulled later, possibly from another context)."""

    def __init__(self, trace: QueryTrace):
        self._trace = trace
        self._t1 = None
        self._t2 = None

    def __enter__(self) -> QueryTrace:
        self._t1 = _TRACE.set(self._trace)
        self._t2 = _SPAN.set(self._trace.root)
        return self._trace

    def __exit__(self, *exc) -> None:
        _SPAN.reset(self._t2)
        _TRACE.reset(self._t1)


class span:
    """``with span(name, kind=..., **attrs) as sp:`` — open a child of the
    innermost span. Returns ``NULL_SPAN`` (and records nothing) when no
    trace is active, so instrumentation points cost one contextvar read
    on the untraced path."""

    __slots__ = ("_name", "_kind", "_attrs", "_span", "_tok", "_dev")

    def __init__(self, name: str, kind: str = "span", **attrs):
        self._name = name
        self._kind = kind
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._tok = None
        self._dev = None

    def __enter__(self):
        tr = _TRACE.get()
        if tr is None:
            return NULL_SPAN
        parent = _SPAN.get() or tr.root
        sp = Span(next(tr._ids), self._name, self._kind, self._attrs)
        parent.children.append(sp)
        self._tok = _SPAN.set(sp)
        if _profiler_enabled():
            # the same region, named on the profiler's own timeline
            try:
                import torch

                self._dev = torch.profiler.record_function(
                    f"tpu_cypher:{self._kind}:{self._name}"
                )
                self._dev.__enter__()
            except Exception:  # fault-ok: profiling must never fail a query
                self._dev = None
        sp.t0 = time.perf_counter()
        self._span = sp
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        if sp is None:
            return False
        sp.seconds = time.perf_counter() - sp.t0
        if self._dev is not None:
            try:
                self._dev.__exit__(exc_type, exc, tb)
            except Exception:  # pragma: no cover - fault-ok: best-effort profiler teardown
                pass
        _SPAN.reset(self._tok)
        if exc_type is not None:
            sp.status = "error"
            tr = _TRACE.get()
            # exits unwind deepest-first: the FIRST error exit is the
            # failing operator the execution_log entry should name
            if tr is not None and tr.failed_span_id is None:
                tr.failed_span_id = sp.span_id
        if self._kind == "phase":
            M.record_stage(self._name, sp.seconds)
        return False


class sync(span):
    """``with sync(site):`` around ONE blocking device->host call
    (``int(t)``, ``.item()``, ``.tolist()``, a host copy, ``nonzero``,
    boolean indexing, ``unique``, a stream sync, ...): a child span of kind
    ``"sync"`` named ``sync:<site>``, whose seconds are the host's wait
    for the device plus the copy, and one count of
    ``tpu_cypher_host_sync_total{site}``. ``site`` is the fault site of the
    code around it, with a suffix where one function syncs more than once.
    It opens no device sync of its own."""

    __slots__ = ("_site",)

    def __init__(self, site: str):
        span.__init__(self, "sync:" + site, "sync")
        self._site = site

    def __enter__(self):
        HOST_SYNC.inc(site=self._site)
        return span.__enter__(self)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _attr_str(sp: Span) -> str:
    parts = [
        f"{k}={v}" for k, v in sp.attrs.items()
        if not isinstance(v, (dict, list))
    ]
    return f"  [{', '.join(parts)}]" if parts else ""


def _time_str(sp: Span) -> str:
    """A span's host time; a kernel span with timing events says that the
    host time is the enqueue, and gives the device's beside it."""
    if sp.events is None and sp._device_s is None:
        return f"{sp.seconds * 1000:.2f} ms"
    dev = sp.device_seconds
    dev_part = "pending" if dev is None else f"{dev * 1000:.3f} ms"
    return f"{sp.seconds * 1000:.2f} ms enqueue, device {dev_part}"


def render(trace: QueryTrace) -> str:
    """ASCII tree with per-span total and self wall times."""
    lines = [
        f"{trace.root.name} (total {trace.total_seconds * 1000:.2f} ms)"
        f"{_attr_str(trace.root)}"
    ]

    def walk(sp: Span, prefix: str, last: bool) -> None:
        branch = "`- " if last else "|- "
        mark = " !" if sp.status == "error" else ""
        self_part = (
            f" (self {sp.self_seconds * 1000:.2f} ms)" if sp.children else ""
        )
        lines.append(
            f"{prefix}{branch}{sp.name} {_time_str(sp)}"
            f"{self_part}{mark}{_attr_str(sp)}"
        )
        child_prefix = prefix + ("   " if last else "|  ")
        for i, c in enumerate(sp.children):
            walk(c, child_prefix, i == len(sp.children) - 1)

    for i, c in enumerate(trace.root.children):
        walk(c, "", i == len(trace.root.children) - 1)
    return "\n".join(lines)


class QueryProfile:
    """What ``CypherResult.profile()`` returns: the rendered tree plus the
    JSON form of the same data."""

    def __init__(self, trace: QueryTrace):
        self.trace = trace

    def render(self) -> str:
        return render(self.trace)

    def to_dict(self) -> Dict[str, Any]:
        return self.trace.to_dict()

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def phase_seconds(self) -> Dict[str, float]:
        return self.trace.phase_seconds()

    @property
    def total_seconds(self) -> float:
        return self.trace.total_seconds

    def __str__(self) -> str:
        return self.render()

    def __repr__(self) -> str:
        n = len(self.trace.spans()) - 1
        return (
            f"QueryProfile({n} spans, "
            f"total {self.trace.total_seconds * 1000:.2f} ms)"
        )
