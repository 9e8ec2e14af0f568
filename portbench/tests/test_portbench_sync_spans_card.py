"""On the card: every synchronizing call that torch's sync debug mode
reports for a cell's warmed queries is made inside one of the program's
``sync:<site>`` spans. Skips where there is no card."""

import json

import pytest

from conftest import REPO


def _cells():
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_every_sync_of_a_cells_warmed_queries_is_in_a_sync_span(card, cell):
    """Each warmed query of the cell once more under torch's sync debug
    mode: every synchronizing call it reports is made inside one of the
    program's ``sync:<site>`` spans."""
    import torch

    from portbench.harness import Bench, ask, ingest
    from portbench.refctx import Context
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.analysis.synctrace import cuda_sync_trace
    from tpu_cypher_torch.obs import trace as T

    bench = Bench(REPO)
    c = bench.cell(cell)
    mix = bench.mix(c["traffic"])
    ctx = Context.for_run(bench.config(c["config"]), mix, 2147483659, device=card)
    pg = ingest(CypherSession.cuda(), ctx.graph)
    warm = []
    for k in mix["kinds"]:
        mod = bench.query(k["query"])
        warm += [(mod, p) for p in mod.params(ctx)[:mix.get("warm") or None]]
    for mod, p in warm:
        ask(pg, mod, p)
    torch.cuda.synchronize()
    outside = []

    class Sink(list):
        def append(self, stack):
            sp = T.current_span()
            if getattr(sp, "kind", None) != "sync":
                outside.append((getattr(sp, "name", None), [str(f) for f in stack[-3:]]))
            super().append(stack)

    sink = Sink()
    with cuda_sync_trace(torch, sink):
        for mod, p in warm:
            ask(pg, mod, p)
    assert len(sink) >= len(warm)
    assert outside == [], outside
