"""Deterministic fault injection for the execution ladder.

``TPU_CYPHER_FAULTS`` names WHERE and WHEN synthetic device faults fire, so
the whole degrade-and-retry ladder is exercised under ``JAX_PLATFORMS=cpu``
in tier-1 — no real OOM or chip loss required. Grammar (comma-separated
specs):

    kind@site[:occurrence]

* ``kind``  — ``oom`` | ``compile`` | ``lost`` | ``timeout`` | ``crash``
* ``site``  — a named fault site (``join``, ``expand``, ``var_expand``,
  ``filter``, ``compact``, ``shuffle``, ``agg``, plus the Pallas kernel-tier sites
  ``kernel_join``/``kernel_expand``/``kernel_agg``/``kernel_frontier``
  fired by ``backend.tpu.pallas.dispatch.launch`` just before a kernel
  launch, and the write-path sites ``wal_append`` (before the WAL
  append: the write fails with nothing durable), ``delta_apply``
  (after the append, before the in-memory apply: commit rolls the WAL
  back to the pre-append offset) and ``compact`` again inside
  ``MutableGraph._maybe_compact`` (the already-committed write survives;
  compaction defers to the next commit) — see ``storage/delta.py``.
  Grep ``fault_point(`` and ``dispatch.register(`` for the full set)
* ``occurrence`` — WHICH invocations of the site fire, 1-based:
  ``:3`` (exactly the 3rd), ``:2-5`` (2nd through 5th), ``:*`` (every
  invocation — drives the ladder all the way to the host oracle). Default
  ``:1``.

Examples::

    TPU_CYPHER_FAULTS=oom@join:1                # first join OOMs once
    TPU_CYPHER_FAULTS=oom@join:*,compile@expand:1
    TPU_CYPHER_FAULTS=lost@compact:2-4

Each spec keeps its own per-site invocation counter; counters are
process-global and monotonically increasing across ladder retries — which
is exactly what makes the ladder testable: ``:1`` fails the device rung
once and the first retry rung succeeds, while ``:*`` fails every device
rung and lands on the host oracle.

Injected exceptions are RAW (``InjectedFault``, message carrying the same
status markers jaxlib uses) so they flow through ``tpu_cypher.errors
.classify`` exactly like real faults. ``timeout`` injects a typed
``QueryTimeout`` directly (deadline expiry is not a raw device error).

``crash`` is the process-death kind: inside an ARMED engine-worker process
(``serve/worker.py`` calls ``enable_crash()``), the covered invocation
``os._exit``\\ s the whole process — the deterministic stand-in for a
native libtpu abort, driving the supervisor/router recovery path
(restart, breaker, replica retry) without a real TPU death. In any
process that has NOT armed it (tests, the router front end, plain
sessions) the kind degrades to a raised lost-style ``InjectedFault``, so
a stray ``crash@...`` spec can never kill the test runner.
"""

from __future__ import annotations

import contextvars
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..errors import QueryTimeout
from ..obs import trace as _obs_trace
from ..obs.metrics import REGISTRY as _REGISTRY
from ..utils.config import FAULTS as _FAULTS

ENV = _FAULTS.name

# per-site invocation counts, served by the unified obs registry — sites
# are exactly the engine's device sync points, so this series doubles as
# dispatch-boundary telemetry (docs/observability.md). The occurrence-
# window logic below keys off the same counter (inc-and-get is atomic),
# which is why ``set_spec``/``reset_counters`` reset it: a fresh spec
# means a fresh deterministic schedule.
FAULT_SITE_HITS = _REGISTRY.counter(
    "tpu_cypher_fault_site_hits_total",
    "invocations of each named fault site (join/expand/kernel_*/...)",
    labels=("site",),
)


class InjectedFault(RuntimeError):
    """Synthetic RAW device fault (classified by message, like jaxlib's
    ``XlaRuntimeError``). Carries the site + occurrence for diagnostics."""

    def __init__(self, message: str, site: str, n: int):
        super().__init__(message)
        self.site = site
        self.n = n


_KIND_MESSAGES = {
    "oom": "RESOURCE_EXHAUSTED: injected out of memory allocating "
    "1099511627776 bytes on device",
    "compile": "INTERNAL: injected XLA compilation failure while compiling "
    "fused computation",
    "lost": "UNAVAILABLE: injected device lost (TPU driver tunnel closed)",
    "crash": "UNAVAILABLE: injected worker crash (disarmed outside an "
    "engine-worker process)",
}

_INF = 1 << 62

# the ``crash`` kind is only ever allowed to take down a dedicated
# engine-worker process — serve/worker.py arms it at startup; everywhere
# else a crash spec degrades to a raised lost-style fault
_CRASH_EXIT_CODE = 137
_crash_armed = False


def enable_crash(enabled: bool = True) -> None:
    """Arm (or disarm) the ``crash`` fault kind for THIS process. Only an
    expendable engine-worker process may arm it; the default is disarmed."""
    global _crash_armed
    _crash_armed = bool(enabled)


def crash_armed() -> bool:
    return _crash_armed

_lock = threading.Lock()
# parsed spec cache, keyed by the raw env/override string
_parse_cache: Tuple[Optional[str], Dict[str, List[Tuple[str, int, int]]]] = (
    None,
    {},
)
# in-process override (tests/fuzz set this instead of mutating os.environ)
_override: Optional[str] = None


class FaultSpecError(ValueError):
    pass


def parse_spec(text: str) -> Dict[str, List[Tuple[str, int, int]]]:
    """``"oom@join:2,lost@expand:*"`` -> {site: [(kind, lo, hi), ...]}
    with 1-based inclusive occurrence bounds (``*`` -> (1, inf))."""
    out: Dict[str, List[Tuple[str, int, int]]] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise FaultSpecError(f"fault spec {part!r}: expected kind@site[:n]")
        kind, _, rest = part.partition("@")
        kind = kind.strip().lower()
        if kind not in ("oom", "compile", "lost", "timeout", "crash"):
            raise FaultSpecError(f"fault spec {part!r}: unknown kind {kind!r}")
        site, _, occ = rest.partition(":")
        site = site.strip()
        if not site:
            raise FaultSpecError(f"fault spec {part!r}: empty site")
        occ = occ.strip() or "1"
        if occ == "*":
            lo, hi = 1, _INF
        elif "-" in occ:
            a, _, b = occ.partition("-")
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(occ)
        if lo < 1 or hi < lo:
            raise FaultSpecError(f"fault spec {part!r}: bad occurrence {occ!r}")
        out.setdefault(site, []).append((kind, lo, hi))
    return out


class _ScopedSchedule:
    """One context's private fault schedule: a parsed spec plus its OWN
    per-site occurrence counts, so two interleaved queries each see a fresh
    deterministic window (``:1`` means THEIR first invocation)."""

    __slots__ = ("spec", "counts")

    def __init__(self, spec: Dict[str, List[Tuple[str, int, int]]]):
        self.spec = spec
        self.counts: Dict[str, int] = {}

    def hit(self, site: str) -> int:
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        return n


# context-local fault schedule: layered OVER the process-global
# set_spec/env spec (a scope shadows it entirely while open). The serving
# layer (serve/) opens one per chaos-mode client query so concurrent
# requests never share occurrence windows.
_CTX_SCHEDULE: contextvars.ContextVar[Optional[_ScopedSchedule]] = (
    contextvars.ContextVar("tpu_cypher_fault_schedule", default=None)
)


class scoped_spec:
    """``with faults.scoped_spec("oom@join:1"):`` — context-local fault
    schedule with its own occurrence counters, shadowing the process-global
    spec while open. None/empty installs an explicit no-fault scope (chaos
    harnesses use that to pin a clean query next to a faulted one)."""

    def __init__(self, text: Optional[str]):
        self._sched = _ScopedSchedule(parse_spec(text) if text else {})
        self._token = None

    def __enter__(self) -> "scoped_spec":
        self._token = _CTX_SCHEDULE.set(self._sched)
        return self

    def __exit__(self, *exc) -> None:
        _CTX_SCHEDULE.reset(self._token)


def set_spec(text: Optional[str]) -> None:
    """In-process override of ``TPU_CYPHER_FAULTS`` (None = back to the
    env). Resets the invocation counters: a fresh spec means a fresh
    deterministic schedule."""
    global _override
    with _lock:
        _override = text
    FAULT_SITE_HITS.reset()


def reset_counters() -> None:
    FAULT_SITE_HITS.reset()


def counters() -> Dict[str, int]:
    """Snapshot of per-site invocation counts (diagnostics/tests) — a view
    over the registry series; zero-hit sites are omitted."""
    return {
        lbl["site"]: int(v)
        for lbl, v in FAULT_SITE_HITS.items()
        if int(v) > 0
    }


def _active_spec() -> Dict[str, List[Tuple[str, int, int]]]:
    global _parse_cache
    raw = _override if _override is not None else (_FAULTS.get() or None)
    if not raw:
        return {}
    cached_raw, cached = _parse_cache
    if cached_raw == raw:
        return cached
    parsed = parse_spec(raw)
    _parse_cache = (raw, parsed)
    return parsed


def fault_point(site: str) -> None:
    """Named fault site. Counts the invocation in the unified registry,
    stamps the site on the enclosing trace span (sites are exactly the
    device sync points between dispatches), checks the active query
    deadline (``runtime.guard``), and raises when an active spec's
    occurrence window covers this invocation."""
    from . import guard as G

    G.check_deadline(site)
    n = int(FAULT_SITE_HITS.inc(site=site))
    _obs_trace.note_site(site)
    sched = _CTX_SCHEDULE.get()
    if sched is not None:
        # a context-local schedule shadows the global spec entirely and
        # evaluates its windows against ITS OWN per-site counts
        spec, n = sched.spec, sched.hit(site)
    else:
        spec = _active_spec()
    if not spec:
        return
    rules = spec.get(site)
    if not rules:
        return
    for kind, lo, hi in rules:
        if lo <= n <= hi:
            if kind == "timeout":
                raise QueryTimeout(
                    f"injected deadline expiry at site {site!r} "
                    f"(invocation {n})",
                    site=site,
                )
            if kind == "crash" and _crash_armed:
                # the worker-process analogue of a native libtpu abort:
                # no unwinding, no atexit — the supervisor sees a dead
                # child, the router sees a socket EOF
                os._exit(_CRASH_EXIT_CODE)
            raise InjectedFault(
                f"{_KIND_MESSAGES[kind]} [injected: {kind}@{site} "
                f"invocation {n}]",
                site,
                n,
            )
