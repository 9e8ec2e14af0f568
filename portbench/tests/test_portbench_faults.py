"""The check must fail: with the control in the program's place, and with
each fault a cell can have planted under the timed path (an answer altered
where it is produced, a query that returns the previous answer, half of the
graph left out of what the program ingests). The run is driven whole on
the CPU, the look for a card skipped."""

import pytest

from portbench import harness
from portbench.snb import Graph

from conftest import TINY_CELLS


def _answers_wrong(res):
    return res["correct"] is False and res["check"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_control_in_the_programs_place_is_not_correct(run_cpu, cell, monkeypatch):
    ctxs = []

    class Recorded(harness.Context):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            ctxs.append(self)

    real = harness.ask

    def control(pg, mod, p):
        _, res = real(pg, mod, p)
        return mod.control(ctxs[-1], p), res

    monkeypatch.setattr(harness, "Context", Recorded)
    monkeypatch.setattr(harness, "ask", control)
    rc, res, _ = run_cpu(cell, seed=31)
    assert rc == 0 and _answers_wrong(res)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_an_answer_altered_where_it_is_produced_is_caught(run_cpu, cell, monkeypatch):
    real, n = harness.ask, [0]

    def altered(pg, mod, p):
        value, res = real(pg, mod, p)
        n[0] += 1
        return value + (n[0] % 3 == 0), res

    monkeypatch.setattr(harness, "ask", altered)
    rc, res, _ = run_cpu(cell, seed=32, seconds=2.0)
    assert rc == 0 and _answers_wrong(res)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_query_that_returns_its_previous_answer_is_caught(run_cpu, cell, monkeypatch):
    """Consecutive queries ask of different sources, so their answers
    differ."""
    real, last = harness.ask, []

    def stale(pg, mod, p):
        value, res = real(pg, mod, p)
        out = last[-1] if last else value
        last.append(value)
        return out, res

    monkeypatch.setattr(harness, "ask", stale)
    rc, res, _ = run_cpu(cell, seed=33, seconds=2.0)
    assert rc == 0 and _answers_wrong(res)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_half_of_the_graph_left_out_is_caught(run_cpu, cell, monkeypatch):
    real = harness.ingest

    def half(session, g):
        keep = slice(0, g.e // 2)
        return real(session, Graph(ids=g.ids, birthday=g.birthday, src=g.src[keep],
                                   dst=g.dst[keep]))

    monkeypatch.setattr(harness, "ingest", half)
    rc, res, _ = run_cpu(cell, seed=34)
    assert rc == 0 and _answers_wrong(res)


def test_a_query_that_raises_is_a_failure(run_cpu, monkeypatch):
    real, n = harness.ask, [0]

    def flaky(pg, mod, p):
        n[0] += 1
        if n[0] == 9:  # the first after the 8 warm-up queries (4 windows, 2 kinds)
            raise RuntimeError("planted")
        return real(pg, mod, p)

    monkeypatch.setattr(harness, "ask", flaky)
    rc, res, err = run_cpu("tiny.varlen", seed=35, seconds=2.0)
    assert rc == 0 and res["correct"] is False and res["failed"] == 1
    assert "planted" in err
