"""The per-layer metrics that read the program's own spans: the host's
waits at its device syncs, its own work between them, its sync count and
its kernels' device time (``portbench/spans.py``, ``metrics/``), on
synthetic traces and records, on a program without those spans, and in a
traced run on the CPU."""

import sys
import types

import pytest

from portbench import spans
from portbench.harness import Bench

from conftest import REPO, TINY_CELLS

NEW = ("sync_wait_ms", "host_work_ms", "host_syncs_per_query", "kernel_device_ms")


class _Done:
    def __init__(self, at_ms):
        self.at_ms = at_ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.at_ms - self.at_ms


def _trace():
    """execute 10 ms: an operator with a 3 ms sync holding a nested 1 ms
    one, and a kernel span with 2 ms between its events; collect 1 ms with
    a 0.5 ms sync; a planning phase's sync outside both."""
    from tpu_cypher_torch.obs import trace as T

    def span(name, kind, seconds, *children):
        sp = T.Span(0, name, kind)
        sp.seconds = seconds
        sp.children = list(children)
        return sp

    kernel = span("kernel:expand_rows", "kernel", 0.0001)
    kernel.add_events((_Done(0.0), _Done(2.0), 0))
    tr = T.QueryTrace()
    tr.root.children = [
        span("relational", "phase", 0.002, span("sync:to_device", "sync", 0.001)),
        span("execute", "phase", 0.010, span("AggregateOp", "operator", 0.0099,
                                             span("sync:agg", "sync", 0.003,
                                                  span("sync:to_host", "sync", 0.001)),
                                             kernel)),
        span("collect", "phase", 0.001, span("sync:decode", "sync", 0.0005)),
    ]
    return tr


def test_summary_of_a_trace(monkeypatch):
    from tpu_cypher_torch.obs import trace as T

    import collections

    monkeypatch.setattr(T, "_EVENT_POOL", {})  # the stand-in span is held apart from the shared ones
    monkeypatch.setattr(T, "_EVENT_HOLDERS", collections.deque())
    got = spans.summary(_trace())
    assert got == pytest.approx({"execute_s": 0.010, "collect_s": 0.001, "sync_s": 0.0035,
                                 "syncs": 3, "kernel_device_s": 0.002})


def test_a_program_without_sync_spans_or_device_time_gives_none():
    """The parent of these metrics: its trace module has no ``sync`` and its
    spans keep no device time."""
    mod = types.ModuleType("parent_obs_trace")

    class Span:
        def __init__(self, name, kind, seconds, children=()):
            self.name, self.kind, self.seconds, self.children = name, kind, seconds, list(children)

    class QueryTrace:
        def __init__(self):
            self.root = Span("query", "query", 0.0, [
                Span("execute", "phase", 0.004, [Span("kernel:expand_rows", "kernel", 0.001)]),
            ])

        def phase_seconds(self):
            return {c.name: c.seconds for c in self.root.children}

    Span.__module__ = QueryTrace.__module__ = mod.__name__
    mod.Span, mod.QueryTrace = Span, QueryTrace
    sys.modules[mod.__name__] = mod
    try:
        got = spans.summary(QueryTrace())
    finally:
        del sys.modules[mod.__name__]
    assert got == {"execute_s": 0.004, "collect_s": 0.0, "sync_s": None, "syncs": None,
                   "kernel_device_s": None}


def test_a_program_that_keeps_no_profiled_traces_gives_none(monkeypatch):
    """The parent of these metrics keeps no record of its profiled
    queries: every reader leaves its metric out."""
    from tpu_cypher_torch.obs import trace as T

    monkeypatch.delattr(T, "profiled_traces")
    rec = {"queries": [{"kind": "fof", "execute_s": 0.010}]}
    assert spans.window(rec) is None
    for name in NEW:
        assert Bench(REPO).metric(name).read(rec) is None, name


def _query(execute_s, collect_s, syncs, kernel_ms):
    """A trace, kept as a profiled one: its execute phase holds an operator with the
    ``syncs`` waits (seconds each) and a kernel span with ``kernel_ms``
    between its events; its collect phase nothing else."""
    from tpu_cypher_torch.obs import trace as T

    def span(name, kind, seconds, *children):
        sp = T.Span(0, name, kind)
        sp.seconds = seconds
        sp.children = list(children)
        return sp

    kernel = span("kernel:expand_rows", "kernel", 0.0001)
    kernel.add_events((_Done(0.0), _Done(kernel_ms), 0))
    tr = T.QueryTrace()
    tr.root.children = [
        span("execute", "phase", execute_s, span("FilterOp", "operator", execute_s, kernel,
                                                 *[span("sync:filter", "sync", s) for s in syncs])),
        span("collect", "phase", collect_s),
    ]
    T._PROFILED.append(tr)
    return tr


def test_readers_on_a_synthetic_record(monkeypatch):
    """Two window queries among a warm-up query before them and a later one
    after: the readers take the two the record names, by their execute
    seconds."""
    import collections

    from tpu_cypher_torch.obs import trace as T

    monkeypatch.setattr(T, "_PROFILED", collections.deque(maxlen=T.PROFILED))
    monkeypatch.setattr(T, "_EVENT_POOL", {})
    monkeypatch.setattr(T, "_EVENT_HOLDERS", collections.deque())
    _query(0.5, 0.1, [0.2, 0.2], 9.0)  # warm-up
    _query(0.010, 0.001, [0.004], 2.0)
    _query(0.020, 0.002, [0.002, 0.004, 0.006], 4.0)
    _query(0.7, 0.1, [0.3], 9.0)  # after the window
    rec = {"queries": [{"kind": "fof", "execute_s": 0.010}, {"kind": "fof", "execute_s": 0.020}]}
    assert len(spans.window(rec)) == 2
    bench = Bench(REPO)
    read = {n: bench.metric(n).read(rec) for n in NEW}
    assert read == pytest.approx({"sync_wait_ms": 8.0, "host_work_ms": 8.5,
                                  "host_syncs_per_query": 2.0, "kernel_device_ms": 3.0})
    # the waits and the host's own work add up to the phases, by construction
    assert read["sync_wait_ms"] + read["host_work_ms"] == pytest.approx(16.5)
    for name in NEW:  # the .host_paced entries read the same file
        assert bench.metric(f"{name}.host_paced").read(rec) == read[name]
    assert all(bench.metric(n).read({"queries": []}) is None for n in NEW)
    assert all(bench.metric(n).read({}) is None for n in NEW)


def test_a_window_query_the_record_no_longer_holds_is_left_out(monkeypatch):
    """Of two window queries with the same execute seconds only the one
    still held counts, once."""
    import collections

    from tpu_cypher_torch.obs import trace as T

    monkeypatch.setattr(T, "_PROFILED", collections.deque(maxlen=2))
    monkeypatch.setattr(T, "_EVENT_POOL", {})
    monkeypatch.setattr(T, "_EVENT_HOLDERS", collections.deque())
    _query(0.010, 0.001, [0.004], 2.0)
    _query(0.010, 0.001, [0.004, 0.001], 2.0)
    _query(0.9, 0.1, [], 1.0)
    rec = {"queries": [{"kind": "fof", "execute_s": 0.010}] * 2}
    got = spans.window(rec)
    assert [q["syncs"] for q in got] == [2]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_traced_run_reports_them(run_cpu, cell, monkeypatch):
    """Each reader finds every answered query of the window among the
    program's profiled traces."""
    real, seen = spans.window, []

    def window(rec):
        out = real(rec)
        seen.append((len(out), len(rec["queries"])))
        return out

    monkeypatch.setattr(spans, "window", window)
    rc, res, err = run_cpu(cell, seed=2**31 + 5, trace=True)
    assert rc == 0 and res["correct"] is True, err
    assert len(seen) == len(NEW) and all(n == m > 0 for n, m in seen), seen
    m = res["metrics"]
    assert set(NEW) <= set(m), sorted(m)
    assert m["host_syncs_per_query"]["value"] >= 1
    assert m["kernel_device_ms"]["value"] == 0.0  # no kernel launches on the CPU
    assert m["sync_wait_ms"]["value"] >= 0.0 and m["host_work_ms"]["value"] > 0.0
    assert m["sync_wait_ms"]["unit"] == "ms" and m["host_syncs_per_query"]["unit"] == "syncs"
