"""Reading a ``torch.profiler`` trace of the window: device time by kernel
name, the device's busy time, and its idle gaps named by what the host was
doing.

The trace is read from its Chrome export. Device activity is every event of
the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host spans are
the program's own span tree (``obs.trace``: phases, operators, kernel
dispatches, index builds), whose ``perf_counter`` times are mapped onto the
trace's clock by the harness's ``portbench.query`` regions, each opened at
a ``perf_counter`` reading the harness keeps.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
QUERY_REGION = "portbench.query"


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_events(events: Sequence[dict]) -> List[Tuple[float, float, str]]:
    """(start_us, end_us, name) of every device operation, by start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    out.sort()
    return out


def region_starts(events: Sequence[dict], name: str = QUERY_REGION) -> List[float]:
    """Start times (us, trace clock) of the host regions called ``name``."""
    return sorted(float(e["ts"]) for e in events
                  if e.get("ph") == "X" and e.get("name") == name
                  and e.get("cat") in ("user_annotation", "cpu_op"))


def clock_offset_us(trace_starts: Sequence[float], host_starts: Sequence[float]) -> float:
    """trace_clock_us - perf_counter_us, the median over the query regions
    (each region opens right after its ``perf_counter`` reading)."""
    n = min(len(trace_starts), len(host_starts))
    if n == 0:
        raise ValueError("the trace holds none of the harness's query regions")
    return float(np.median(np.asarray(trace_starts[:n]) - np.asarray(host_starts[:n]) * 1e6))


def busy_and_gaps(dev: Sequence[Tuple[float, float, str]], w0: float, w1: float):
    """(busy_us, gaps): the union of device intervals inside [w0, w1] and
    the idle intervals between them, as (start_us, end_us)."""
    busy, gaps, cursor = 0.0, [], w0
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    return busy, gaps


def kernel_seconds(dev: Sequence[Tuple[float, float, str]], functions: Sequence[str],
                   w0: float, w1: float) -> float:
    """Device seconds inside [w0, w1] of the kernels whose (demangled) name
    is one of ``functions``."""
    pat = re.compile(r"(?:^|[\s:])(?:%s)\s*(?:\(|$)" % "|".join(map(re.escape, functions)))
    return sum(min(e, w1) - max(s, w0) for s, e, name in dev
               if e > w0 and s < w1 and pat.search(name)) / 1e6


def top_device_ops(dev: Sequence[Tuple[float, float, str]], w0: float, w1: float,
                   k: int = 10) -> List[list]:
    """[[name, seconds]] of the ``k`` device operations that took most time
    in [w0, w1], by name (a kernel's argument list cut off)."""
    tot: Dict[str, float] = {}
    for s, e, name in dev:
        name = name.replace("(anonymous namespace)::", "")
        if e > w0 and s < w1:
            key = name.split("(")[0].strip()[:120] or name[:120]
            tot[key] = tot.get(key, 0.0) + (min(e, w1) - max(s, w0)) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def name_gaps(gaps: Sequence[Tuple[float, float]], spans: Sequence[Tuple[float, float, int, str]],
              k: int = 10) -> List[list]:
    """[[host span, seconds]]: the idle time summed by the deepest host span
    open at each gap's start (``harness`` where no query was open), the
    ``k`` largest. ``spans`` are (start_us, end_us, depth, name) on the
    trace clock."""
    if not gaps:
        return []
    sp = sorted(spans)
    starts = np.asarray([s[0] for s in sp]) if sp else np.zeros(0)
    tot: Dict[str, float] = {}
    for g0, g1 in gaps:
        name, depth = "harness", -1
        # the spans that opened before g0 and are still open at it
        i = int(np.searchsorted(starts, g0, side="right"))
        j = i - 1
        while j >= 0 and i - j <= 64:
            s0, s1, d, nm = sp[j]
            if s0 <= g0 < s1 and d > depth:
                name, depth = nm, d
            j -= 1
        tot[name] = tot.get(name, 0.0) + (g1 - g0) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]
