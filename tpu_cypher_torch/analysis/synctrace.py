"""Runtime device->host syncs, attributed to the port's source lines and
held against the host-sync rule's static inventory.

The static side is ``runner.sync_sites``: every sync the torch taint
model sees, with the rule's verdict. The runtime side is a list of
Python stacks, one per sync, taken by one of two recorders:

* ``cuda_sync_trace`` — on the card: ``torch.cuda.set_sync_debug_mode
  ("warn")`` makes torch warn at every synchronizing CUDA call (a copy to
  or from pageable host memory, ``.item()``, ``nonzero``, a stream
  sync, ...), and a ``warnings.showwarning`` hook records the stack;
* ``emulated_sync_trace`` — on the CPU, where nothing syncs: the tensor
  methods and torch functions that would sync on the card are wrapped
  to record their stacks (the explicit kinds of the taint model and the
  data-dependent sizes: ``nonzero``, boolean indexing, ``unique``,
  ``repeat_interleave`` without ``output_size``, ``bincount``,
  ``masked_select``). A rehearsal: copies to the device are not seen,
  and the plain tiers and the CPU-only branches run in the kernels'
  and the card's place.

``SyncMap.site`` attributes a stack to its innermost frame inside the
package (torch's own frames are walked past), and ``SyncMap.classify``
names what the analyzer says of that line: ``flagged``, ``suppressed``,
``accepted`` (under a ``fault_point``) or ``outside scope`` when the taint
model sees a sync there; ``missed`` when the line holds a sync kind of the
model (by shape) whose operand the model does not prove host, yet the
model saw no sync there — a false negative; ``implicit`` otherwise (a
data-dependent size or a copy the model does not try to see).
"""

from __future__ import annotations

import contextlib
import os
import traceback
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .dataflow import HOST, sync_shape
from .runner import Report, sync_sites

Site = Tuple[str, int, str]  # (path relative to the root, line, function)

_SYNC_WARNING = "synchronizing CUDA operation"


class SyncMap:
    """The static inventory of one analyzer run over ``package_dir``,
    keyed by absolute path, and the attribution of runtime stacks to
    it. Paths print relative to ``package_dir``'s parent."""

    def __init__(self, report: Report, package_dir: str):
        self.project = report.project
        self.package_dir = os.path.abspath(package_dir)
        self.root = os.path.dirname(self.package_dir)
        self._skip = os.path.join(self.package_dir, "analysis") + os.sep
        self._ctx = {
            os.path.abspath(ctx.path): ctx for ctx in self.project.contexts
        }
        rel_to_abs = {
            ctx.relpath: path for path, ctx in self._ctx.items()
        }
        self.static: Dict[Tuple[str, int], Dict[str, str]] = {
            (rel_to_abs[rel], line): v
            for (rel, line), v in sync_sites(report).items()
        }

    def site(self, stack: traceback.StackSummary) -> Optional[Site]:
        """The innermost frame of ``stack`` inside the package (the
        analyzer's own frames aside), or None."""
        for frame in reversed(stack):
            path = os.path.abspath(frame.filename)
            if path.startswith(self.package_dir + os.sep) and not path.startswith(
                self._skip
            ):
                rel = os.path.relpath(path, self.root).replace(os.sep, "/")
                return rel, frame.lineno, frame.name
        return None

    def classify(self, site: Site) -> str:
        path = os.path.join(self.root, site[0])
        got = self.static.get((path, site[1]))
        if got is not None:
            return got["status"]
        ctx = self._ctx.get(path)
        if ctx is None:
            return "implicit"
        taint = self.project.device_taint
        for call in ctx.calls:
            if getattr(call, "lineno", 0) != site[1]:
                continue
            shape = sync_shape(call)
            if shape is None:
                continue
            operand = shape[1]
            fn = ctx.enclosing_function(call)
            if operand is None or taint.classify(ctx, fn, operand) != HOST:
                return "missed"
        return "implicit"


@contextlib.contextmanager
def cuda_sync_trace(torch, sink: List[traceback.StackSummary]) -> Iterator[None]:
    """Record the stack of every synchronizing CUDA call made inside the
    block, from torch's sync debug mode; the mode and the warning filters
    are restored on exit, however the block ends."""

    def hook(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            sink.append(traceback.extract_stack()[:-1])
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _is_bool_index(torch, index) -> bool:
    parts = index if isinstance(index, tuple) else (index,)
    return any(
        isinstance(p, torch.Tensor) and p.dtype == torch.bool for p in parts
    )


@contextlib.contextmanager
def emulated_sync_trace(torch, sink: List[traceback.StackSummary]) -> Iterator[None]:
    """The CPU rehearsal of ``cuda_sync_trace``: wrap what would sync on
    the card and record its stack; every wrapper is removed on exit."""
    T = torch.Tensor

    def always(_args, _kwargs) -> bool:
        return True

    def no_output_size(_args, kwargs) -> bool:
        return kwargs.get("output_size") is None

    def bool_index(args, _kwargs) -> bool:
        return len(args) > 1 and _is_bool_index(torch, args[1])

    def one_arg_where(args, kwargs) -> bool:
        return len(args) == 1 and not kwargs

    targets: List[Tuple[object, str, Callable]] = [
        (T, name, always)
        for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                     "__bool__", "__index__", "nonzero", "unique")
    ] + [
        (torch, name, always)
        for name in ("nonzero", "unique", "bincount", "masked_select", "argwhere")
    ] + [
        (torch, "repeat_interleave", no_output_size),
        (T, "repeat_interleave", no_output_size),
        (T, "__getitem__", bool_index),
        (T, "__setitem__", bool_index),
        (torch, "where", one_arg_where),
    ]
    saved = []
    depth = [0]

    def wrap(fn, when):
        def wrapper(*args, **kwargs):
            if depth[0] == 0 and when(args, kwargs):
                sink.append(traceback.extract_stack()[:-1])
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1

        return wrapper

    try:
        for owner, name, when in targets:
            fn = getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, wrap(fn, when))
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def summarize(smap: SyncMap, stacks: List[traceback.StackSummary]) -> Dict[str, object]:
    """{"syncs": n, "by_status": {status: n}, "sites": [(site, status,
    n), ...] most frequent first, "outside": n (stacks with no frame in
    the package)}."""
    counts: Dict[Site, int] = {}
    outside = 0
    for st in stacks:
        site = smap.site(st)
        if site is None:
            outside += 1
        else:
            counts[site] = counts.get(site, 0) + 1
    sites = sorted(
        ((s, smap.classify(s), n) for s, n in counts.items()),
        key=lambda x: (-x[2], x[0]),
    )
    by_status: Dict[str, int] = {}
    for _, status, n in sites:
        by_status[status] = by_status.get(status, 0) + n
    return {
        "syncs": len(stacks),
        "by_status": by_status,
        "sites": sites,
        "outside": outside,
    }


def trace_queries(
    torch, smap: SyncMap, graphs, queries, recorder, echo=print
) -> Tuple[Dict[str, Dict[str, int]], List[Tuple[str, Site]]]:
    """Run each (label, graph key, query) of ``queries`` once warm, then
    once under ``recorder`` (``cuda_sync_trace`` or
    ``emulated_sync_trace``) on ``graphs[key]``, and ``echo`` its syncs
    by status and its sites. Returns ({label: {"syncs": n, status: n}},
    the missed sites as (label, site))."""
    import time

    out: Dict[str, Dict[str, int]] = {}
    escaped: List[Tuple[str, Site]] = []
    for label, key, query in queries:
        pg = graphs[key]
        pg.cypher(query).records.collect()  # warm
        stacks: List[traceback.StackSummary] = []
        t0 = time.perf_counter()
        with recorder(torch, stacks):
            rows = pg.cypher(query).records.collect()
        secs = time.perf_counter() - t0
        if not rows:
            raise RuntimeError(f"{label} returned no rows under the sync trace")
        summary = summarize(smap, stacks)
        out[label] = {"syncs": summary["syncs"], **summary["by_status"]}
        echo(f"  sync trace {label}: {summary['syncs']} syncs in {secs:.3f} s, by "
             f"status {summary['by_status']}, {summary['outside']} outside the package")
        for line in render_sites(summary):
            echo(f"    {line}")
        escaped += [(label, s) for s in missed(summary)]
    return out, escaped


def missed(summary: Dict[str, object]) -> List[Site]:
    return [s for s, status, _ in summary["sites"] if status == "missed"]


def render_sites(summary: Dict[str, object]) -> List[str]:
    return [
        f"{s[0]}:{s[1]}:{s[2]} [{status}] x{n}"
        for s, status, n in summary["sites"]
    ]


__all__ = [
    "SyncMap",
    "cuda_sync_trace",
    "emulated_sync_trace",
    "missed",
    "render_sites",
    "summarize",
    "trace_queries",
]
