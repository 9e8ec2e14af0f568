"""The frozen byte bounds against PERF.md's, and each query kind's kernel
work against the calls the program's kernel gates actually receive."""

import pytest

from portbench import roofline
from portbench.harness import Bench, ingest
from portbench.refctx import Context

from conftest import TINY_CELLS


def test_the_frozen_bounds_reproduce_perf_md():
    # Q17's final hop at SF10: F=4,499,960 frontier rows, 197,148,177 lanes, no orig
    q17 = roofline.bound_seconds(roofline.expand_bytes(4_499_960, 197_148_177, False))
    assert round(q17 * 1e3, 4) == 1.2627
    # Q6's arm-0 probe at SF10: 102,797,650 queries over 4,499,960 keys
    q6 = roofline.bound_seconds(roofline.intersect_bytes(4_499_960, 102_797_650))
    assert round(q6 * 1e3, 4) == 0.7779
    # Q18's third hop, with orig: F=1,226,790, 58,582,515 lanes
    q18 = roofline.bound_seconds(roofline.expand_bytes(1_226_790, 58_582_515, True))
    assert round(q18 * 1e3, 4) == 0.6544


def test_every_kernel_has_its_device_functions():
    assert set(roofline.KERNELS) == {"expand_rows", "intersect"}
    for k in roofline.KERNELS.values():
        assert k["device_functions"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_work_equals_what_the_gates_receive(tiny_root, cell, monkeypatch):
    """The bytes each kind's ``work`` counts equal the bytes of the calls
    the ``expand_rows`` and ``intersect`` gates get when the program runs
    the query (the plain tiers here; the same calls reach the kernels on
    the card)."""
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.backend.cuda import hopper

    seen = {}
    inner_e, inner_i = hopper.expand_materialize_counted, hopper.intersect_range_count

    def expand(rp, ci, eo, pos, deg, nvalid, *, size, with_orig=True):
        seen["expand_rows"] = seen.get("expand_rows", 0) + roofline.expand_bytes(
            int(pos.shape[0]), size, with_orig)
        return inner_e(rp, ci, eo, pos, deg, nvalid, size=size, with_orig=with_orig)

    def intersect(keys, q, qvalid, *args, **kwargs):
        seen["intersect"] = seen.get("intersect", 0) + roofline.intersect_bytes(
            int(keys.shape[0]), int(q.shape[0]))
        return inner_i(keys, q, qvalid, *args, **kwargs)

    monkeypatch.setattr(hopper, "expand_materialize_counted", expand)
    monkeypatch.setattr(hopper, "intersect_range_count", intersect)
    bench = Bench(tiny_root)
    c = bench.cell(cell)
    mix = bench.mix(c["traffic"])
    ctx = Context.for_run(bench.config(c["config"]), mix, 5)
    g = ctx.graph
    pg = ingest(CypherSession.cuda(device="cpu"), g)
    for k in mix["kinds"]:
        mod = bench.query(k["query"])
        for p in mod.params(ctx)[:4]:
            seen.clear()
            pg.cypher(mod.QUERY, p).records.collect()
            assert seen == mod.work(ctx, p), (k["query"], p)
