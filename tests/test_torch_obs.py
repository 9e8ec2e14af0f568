"""The port's tracing (``tpu_cypher_torch/obs/trace.py``): the ``sync``
spans and the ``tpu_cypher_host_sync_total`` counter, the CUDA timing
events of kernel spans, the spans as regions of a ``torch.profiler``
trace, and that every device sync of the benchmark's queries sits inside
a sync span (a CPU rehearsal under ``analysis.synctrace``'s emulated
recorder; ``portbench/tests/test_portbench_sync_spans_card.py`` holds the
same on the card). All on the CPU; nothing here is timed."""

import json
import os
from pathlib import Path

import pytest
import torch

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.analysis import synctrace as ST
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.obs import trace as T

REPO = Path(__file__).resolve().parent.parent

GRAPH = (
    "CREATE (a:P {v: 1})-[:K]->(b:P {v: 2})-[:K]->(c:P {v: 3}), (a)-[:K]->(c), "
    "(c)-[:K]->(a)"
)
QUERY = "MATCH (a:P)-[:K]->(b:P) WHERE a.v < 3 RETURN count(*) AS n"


def _syncs(site):
    return T.HOST_SYNC.value(site=site)


# ---------------------------------------------------------------------------
# the sync span
# ---------------------------------------------------------------------------


def test_a_sync_span_nests_counts_and_feeds_the_registry():
    tr = T.QueryTrace()
    before = _syncs("agg")
    with T.activate(tr):
        with T.span("AggregateOp", kind="operator") as op:
            with T.sync("agg") as sp:
                assert T.current_span() is sp
                with T.sync("agg_inner") as inner:
                    assert T.current_span() is inner
            assert T.current_span() is op
    assert [c.name for c in op.children] == ["sync:agg"]
    assert sp.kind == "sync" and sp.seconds >= inner.seconds >= 0.0
    assert sp.children == [inner] and inner.name == "sync:agg_inner"
    assert _syncs("agg") == before + 1
    text = CypherSession.cuda(device="cpu").metrics_text()
    assert 'tpu_cypher_host_sync_total{site="agg"}' in text


def test_a_sync_without_a_trace_still_counts():
    before = _syncs("probe")
    with T.sync("probe") as sp:
        pass
    assert sp is T.NULL_SPAN and _syncs("probe") == before + 1


def test_a_query_profile_holds_its_sync_spans():
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(GRAPH)
    res = g.cypher(QUERY)
    assert res.records.collect() == [{"n": 3}]
    syncs = [s for s in res.profile().trace.spans() if s.kind == "sync"]
    assert "sync:filter" in {s.name for s in syncs}
    text = res.profile().render()
    assert "sync:filter" in text and "sites=" not in text
    assert all("sites" not in s.attrs for s in res.profile().trace.spans())


# ---------------------------------------------------------------------------
# device time on kernel spans
# ---------------------------------------------------------------------------


class _Event:
    """A CUDA timing event's reading surface: done or not, and the
    milliseconds to another event."""

    def __init__(self, at_ms, done=True):
        self.at_ms, self.done = at_ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done, "read before the device passed the event"
        return end.at_ms - self.at_ms


@pytest.fixture
def own_event_pool(monkeypatch):
    """Stand-in events go to a pool and a holder list of the test's own."""
    import collections

    monkeypatch.setattr(T, "_EVENT_POOL", {})
    monkeypatch.setattr(T, "_EVENT_HOLDERS", collections.deque())


def test_the_traces_of_profiled_queries_are_kept_and_no_others(monkeypatch):
    import collections

    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(T, "_PROFILED", collections.deque(maxlen=3))
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(GRAPH)

    def ask():
        res = g.cypher(QUERY)
        assert res.records.collect() == [{"n": 3}]
        return res.profile().trace

    ask()
    assert T.profiled_traces() == []
    with profile(activities=[ProfilerActivity.CPU]):
        seen = [ask() for _ in range(4)]
    ask()
    got = T.profiled_traces()
    assert got == seen[-3:] and all(t.phase_seconds()["execute"] > 0 for t in got)


def test_device_seconds_wait_for_the_device_and_return_the_events(own_event_pool):
    sp = T.Span(1, "kernel:expand_rows", "kernel")
    s1, e1 = _Event(0.0), _Event(0.5)
    start, end = _Event(1.0), _Event(3.5, done=False)
    sp.add_events((s1, e1, 7))
    sp.add_events((start, end, 7))  # a second launch of the same call
    assert sp.device_seconds is None  # pending: read again later, never waited for
    assert sp.to_dict()["device_ms"] is None
    assert "enqueue, device pending" in T.render(_trace_of(sp))
    end.done = True
    assert sp.device_seconds == pytest.approx(3.0e-3)  # both launches, not the gap
    assert sp.to_dict()["device_ms"] == pytest.approx(3.0)
    assert "enqueue, device 3.000 ms" in T.render(_trace_of(sp))
    assert list(T._EVENT_HOLDERS) == [sp]  # a read gives nothing back
    assert T.device_events(7) == (start, end, 7)  # the next launch takes the pairs back
    assert sp.events is None and T._EVENT_POOL[7] == [(s1, e1)]
    assert not T._EVENT_HOLDERS and sp.device_seconds == pytest.approx(3.0e-3)
    sp.add_events((_Event(10.0), _Event(10.25), 7))  # a launch after the take-back adds
    assert sp.device_seconds == pytest.approx(3.25e-3)
    assert "device_ms" not in T.Span(2, "kernel:x", "kernel").to_dict()


def test_events_no_one_reads_are_taken_back_once_passed(own_event_pool):
    """Where no reader asks (an untraced run's profiles), a pair goes back
    to the pool when a launch needs one and the device has passed it; its
    span keeps the seconds, and a pair still in flight is left alone."""
    done = T.Span(1, "kernel:intersect", "kernel")
    done.add_events((_Event(0.0), _Event(1.5), 0))
    pending = T.Span(2, "kernel:intersect", "kernel")
    pending.add_events((_Event(2.0), _Event(4.0, done=False), 0))
    pair = T.device_events(0)
    assert pair[2] == 0 and done.events is None and done.device_seconds == pytest.approx(1.5e-3)
    assert list(T._EVENT_HOLDERS) == [pending] and T._EVENT_POOL[0] == []
    assert pending.events is not None and pending.device_seconds is None


class _Counted(_Event):
    """A stand-in pair the device passes as soon as it is recorded."""

    made = 0

    def __init__(self):
        super().__init__(0.0)
        _Counted.made += 1

    def record(self, stream=None):
        pass


def test_the_holders_stay_bounded_when_every_profile_is_read(monkeypatch, own_event_pool):
    """A server reads every query's profile once its collect has synced:
    1,000 traced launches, each read through ``to_dict``, neither keep
    their spans held nor make a pair per launch."""
    _Counted.made = 0
    _stand_in_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _Counted())

    def wrapper():
        with PD.device_timed(torch.device("cuda", 0), 7):
            pass
        return "kernel"

    most = 0
    for _ in range(1000):
        tr = T.QueryTrace()
        with T.activate(tr):
            PD.launch("expand_rows", wrapper, lambda: "plain", device=torch.device("cuda", 0))
        assert T.QueryProfile(tr).to_dict()["root"]["children"][0]["device_ms"] == 0.0
        most = max(most, len(T._EVENT_HOLDERS))
    assert most <= 2 and _Counted.made <= 4


def _trace_of(sp):
    tr = T.QueryTrace()
    phase = T.Span(9, "execute", "phase")
    phase.children.append(sp)
    tr.root.children.append(phase)
    return tr


class _Recorded(_Event):
    def __init__(self, log):
        super().__init__(float(len(log)))
        self.log = log

    def record(self, stream=None):
        assert stream is not None and stream.device_index == 0  # the launch's stream
        self.at_ms = float(len(self.log))
        self.log.append(self)


def _stand_in_card(monkeypatch):
    """CUDA made to look initialized, with a stand-in stream object per
    ``torch.cuda.current_stream`` call; returns the devices it was asked
    for."""
    import contextlib

    made = []

    def current_stream(dev=None):
        made.append(dev)
        return type("S", (), {"device_index": 0})()

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(PD, "_STREAMS", {})
    return made


def test_each_launch_of_a_kernel_tier_call_is_timed_alone(monkeypatch, own_event_pool):
    """``device_timed`` around each ctypes launch: one event pair a launch
    on the call's kernel span, none around the wrapper's other work, and
    none outside a kernel span."""
    log = []
    made = _stand_in_card(monkeypatch)
    monkeypatch.setattr(T, "device_events", lambda index: (_Recorded(log), _Recorded(log), index))
    dev = torch.device("cuda", 0)

    def wrapper():
        log.append("alloc")
        with PD.device_timed(dev, 7):
            log.append("launch 1")
        log.append("between")
        with PD.device_timed(dev, 7):
            log.append("launch 2")
        log.append("total")
        return "kernel"

    tr = T.QueryTrace()
    with T.activate(tr):
        assert PD.launch("expand_rows", wrapper, lambda: "plain",
                         device=torch.device("cuda", 0)) == "kernel"
    [sp] = [s for s in tr.spans() if s.kind == "kernel"]
    marks = [x if isinstance(x, str) else "event" for x in log]
    assert marks == ["alloc", "event", "launch 1", "event", "between", "event", "launch 2",
                     "event", "total"]
    assert len(sp.events) == 2 and sp.device_seconds == pytest.approx(4e-3)
    with PD.device_timed(dev, 7):  # no kernel span open: nothing recorded
        pass
    assert len(log) == 9
    assert made == [dev]  # one stream object for the stream, reused by the second launch


@pytest.mark.parametrize("device,eligible", [
    (torch.device("cpu"), True),           # plain
    (torch.device("cuda", 0), True),       # a stand-in kernel tier without a card
    (torch.device("cuda", 0), False),      # fallback
])
def test_a_cpu_kernel_tier_call_records_no_events(device, eligible):
    tr = T.QueryTrace()
    with T.activate(tr):
        got = PD.launch("segment_agg", lambda: "kernel", lambda: "plain",
                        device=device, eligible=eligible)
    assert got == ("kernel" if device.type == "cuda" and eligible else "plain")
    [sp] = [s for s in tr.spans() if s.kind == "kernel"]
    assert sp.events is None and sp.device_seconds is None
    assert "device_ms" not in sp.to_dict()


# ---------------------------------------------------------------------------
# the spans in a torch.profiler trace
# ---------------------------------------------------------------------------


def test_regions_appear_in_a_profiler_trace_only_while_it_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(GRAPH)
    g.cypher(QUERY).records.collect()  # warm: a plan-cache hit from here on
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    g.cypher(QUERY).records.collect()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.cypher(QUERY).records.collect()
    names = {e.name for e in prof.events()}
    assert "tpu_cypher:phase:execute" in names
    assert "tpu_cypher:operator:FilterOp" in names
    assert "tpu_cypher:sync:sync:filter" in names
    assert set(opened) <= names and len(opened) >= 3
    opened.clear()
    g.cypher(QUERY).records.collect()
    assert opened == []


def test_a_span_reads_no_environment_variable(monkeypatch):
    read = []

    class Spy(dict):
        def __getitem__(self, key):
            read.append(key)
            return super().__getitem__(key)

        def get(self, key, default=None):
            read.append(key)
            return super().get(key, default)

        def __contains__(self, key):
            read.append(key)
            return super().__contains__(key)

    monkeypatch.setattr(os, "environ", Spy(os.environ))
    tr = T.QueryTrace()
    with T.activate(tr):
        for _ in range(3):
            with T.span("FilterOp", kind="operator"):
                with T.sync("filter"):
                    pass
    assert read == []
    assert len(tr.spans()) == 7


# ---------------------------------------------------------------------------
# every sync of the benchmark's queries inside a sync span (CPU rehearsal)
# ---------------------------------------------------------------------------


def _benchmark_queries():
    """(kind, query module, parameters) for every query kind of every
    traffic mix of the benchmark, on a 2,000-person graph of the SF1
    configuration's generator."""
    from portbench import snb
    from portbench.harness import Bench
    from portbench.refctx import Context

    bench = Bench(REPO)
    cfg = json.loads((REPO / "portbench" / "configs" / "snb_sf1.json").read_text())
    cfg["generator"].update(persons=2000, knows=30000)
    graph = snb.graph_of(cfg["generator"])
    out = []
    for path in sorted((REPO / "portbench" / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        if "walk_lengths" in mix["params"]:
            mix["params"]["windows"] = {"tiny": [
                {str(k): [100, 40 if k == 3 else 20] for k in mix["params"]["walk_lengths"]}
            ]}
        ctx = Context(graph, mix, 2**31 + 11, device="cpu", config="tiny")
        for k in mix["kinds"]:
            mod = bench.query(k["query"])
            out.append((k["query"], mod, mod.params(ctx)[0]))
    return graph, out


def test_every_sync_of_the_benchmarks_queries_is_in_a_sync_span():
    from portbench.harness import ask, ingest

    graph, queries = _benchmark_queries()
    assert {k for k, _, _ in queries} >= {
        "two_hop_distinct", "close_undirected", "triangle", "varlen_1_3", "varlen_1_4"
    }
    pg = ingest(CypherSession.cuda(device="cpu"), graph)
    for kind, mod, p in queries:
        want, _ = ask(pg, mod, p)  # warm

        outside = []

        class Sink(list):
            def append(self, stack):
                sp = T.current_span()
                if getattr(sp, "kind", None) != "sync":
                    outside.append((getattr(sp, "name", None), stack[-3:]))
                super().append(stack)

        sink = Sink()
        with ST.emulated_sync_trace(torch, sink):
            got, _ = ask(pg, mod, p)
        assert got == want
        assert sink, f"{kind}: no sync recorded"
        assert outside == [], f"{kind}: {outside}"
