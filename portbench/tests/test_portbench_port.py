"""Each query kind's reference against tpu_cypher_torch's own answer, with
``CypherSession.cuda(device="cpu")`` at a tiny size, through the harness's
whole run (set-up, window, check) and query by query."""

import pytest

from portbench.harness import Bench, ask, ingest
from portbench.refctx import Context

from conftest import TINY_CELLS


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_run_on_the_cpu_is_correct(run_cpu, cell):
    rc, res, err = run_cpu(cell, seed=2**31 + 7)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert res["check"]["wrong_answers"]["value"] == 0
    assert set(res["metrics"]) == {"queries_per_s", "latency_p95_ms", "peak_device_gib", "setup_s"}
    assert err.strip().splitlines()[-2].startswith("check wrong_answers 0 limit 0")


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_each_reference_equals_the_programs_answer(tiny_root, cell):
    from tpu_cypher_torch import CypherSession

    bench = Bench(tiny_root)
    c = bench.cell(cell)
    mix = bench.mix(c["traffic"])
    ctx = Context.for_run(bench.config(c["config"]), mix, 99)
    g = ctx.graph
    pg = ingest(CypherSession.cuda(device="cpu"), g)
    for k in mix["kinds"]:
        mod = bench.query(k["query"])
        for p in mod.params(ctx)[:4]:
            got, _ = ask(pg, mod, p)
            assert got == mod.reference(ctx, p), (k["query"], p)
