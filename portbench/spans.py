"""One query's span tree summed for the per-layer metrics that read the
program's own spans: the host's waits at its device syncs (the
``sync:<site>`` spans, ``obs.trace.sync``) and its kernels' device time
(the CUDA timing events of the ``kernel:<name>`` spans).

The window's traces are the program's own record of the queries it ran
while the traced run's profiler recorded (``obs.trace.profiled_traces()``),
read after the window has closed: those whose ``execute`` seconds are the
ones the harness recorded for the window's answered queries
(``rec["queries"]``), to the bit. A program that keeps no such record
gives None, and the metrics that read it are left out of the line.

Only the ``execute`` and ``collect`` phases count: a warm query's plan is a
plan-cache hit, and these are the phases ``execute_ms`` and the host's
own work read. A sync span inside another one counts as a sync, and its
seconds as part of the outer one's. A program whose trace has no sync
spans, or whose spans keep no device time, gives None for those values,
never a zero.
"""

from __future__ import annotations

import collections
import sys

PHASES = ("execute", "collect")


def summary(trace) -> dict:
    """{"execute_s", "collect_s", "sync_s", "syncs", "kernel_device_s"} of
    one query's ``QueryTrace``."""
    phases = trace.phase_seconds()
    has_sync = hasattr(sys.modules.get(type(trace).__module__), "sync")
    has_device = hasattr(type(trace.root), "device_seconds")
    sync_s, syncs, kernel_s = 0.0, 0, 0.0
    stack = [(sp, False) for sp in trace.root.children if sp.name in PHASES]
    while stack:
        sp, in_sync = stack.pop()
        if sp.kind == "sync":
            syncs += 1
            if not in_sync:
                sync_s += sp.seconds
        elif sp.kind == "kernel" and has_device:
            kernel_s += sp.device_seconds or 0.0
        stack.extend((c, in_sync or sp.kind == "sync") for c in sp.children)
    return {
        "execute_s": phases.get("execute", 0.0),
        "collect_s": phases.get("collect", 0.0),
        "sync_s": sync_s if has_sync else None,
        "syncs": syncs if has_sync else None,
        "kernel_device_s": kernel_s if has_device else None,
    }


def window(rec) -> list | None:
    """The summaries of the window's answered queries that the program's
    profiled traces still hold, in the order it opened them, or None where
    it keeps no such traces."""
    from tpu_cypher_torch.obs import trace as program_trace

    profiled = getattr(program_trace, "profiled_traces", None)
    if profiled is None:
        return None
    want = collections.Counter(q["execute_s"] for q in rec.get("queries") or ()
                               if q["execute_s"])
    out = []
    for qt in profiled():
        x = qt.phase_seconds().get("execute", 0.0)
        if want[x]:
            want[x] -= 1
            out.append(summary(qt))
    return out


def mean_of(rec, value) -> float | None:
    """The mean of ``value(query summary)`` over the window's answered
    queries, or None where the program keeps no profiled traces, none of
    them is the window's, or the program gave none of the values."""
    xs = [value(q) for q in window(rec) or []]
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None
