"""The cost-based optimizer (``tpu_cypher_torch/optimizer/``) on
``CudaTable``: the port against the JAX package, on the CPU.

The counterparts of ``tests/test_optimizer.py``: statistics equal to true
counts, expand estimates within a constant factor of true cardinalities,
optimized plans bag-identical to syntax-order plans, the reorder firing on
the skewed chain and leaving the cyclic one alone, the plan cache keyed on
``TPU_CYPHER_OPT``, the calibration under the bucket lattice, and the
overrides that win verbatim. Left out: ``test_zero_warm_recompiles_under_
fixed_plan``, since the port runs eagerly and compiles no program per plan
(its kernels build once per source), so there is no recompile to count.
``test_feedback_never_observes_without_rows`` becomes its port form: the
port's operator spans carry (true, padded) rows in every bucket mode, so
the calibration gains samples and ``wcoj_scale`` leaves 1.0.

Beyond those: the port's ``GraphStatistics`` equal the reference's on the
same arrays; on a tenth-size copy of ``bench.py``'s join-order graph
(``_join_order_graph``: 3,000 nodes, 1 in 50 ``Admin``, 30,000 KNOWS, 60
RARE, ``default_rng(17)``) the five ``_JOIN_ORDER_QUERIES`` leave the
reference's ``join_order`` note (chosen, anchor, both costs) under
``auto`` and ``force`` with the calibration reset, and their rows are
bag-identical across the reference, ``local()`` and the port under
``syntax``, ``auto`` and ``force``; and a pinned
``TPU_CYPHER_PALLAS_MAX_GROUPS`` lowers the ``segment_agg`` gate's group
cap, never raises it.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.optimizer import GraphStatistics as RefGraphStatistics
from tpu_cypher.optimizer import feedback as RFB
from tpu_cypher.utils import config as RCFG

import test_optimizer as RTO

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.optimizer import (
    CostModel,
    GraphStatistics,
    broadcast_build_limit,
    estimate_query_cost_bytes,
    wcoj_threshold,
)
from tpu_cypher_torch.optimizer import cost as PCOST
from tpu_cypher_torch.optimizer import feedback
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)

_CHAIN = RTO._CHAIN_QUERIES


@pytest.fixture(autouse=True)
def _reset():
    feedback.reset_for_tests()
    RFB.reset_for_tests()
    yield
    for cfg in (PCFG, RCFG):
        cfg.OPT_MODE.reset()
        cfg.WCOJ_MIN_ROWS.reset()
        cfg.BROADCAST_LIMIT.reset()
        cfg.BUCKET_MODE.reset()
        cfg.WCOJ_MODE.reset()
    PCFG.PALLAS_MAX_GROUPS.reset()
    feedback.reset_for_tests()
    RFB.reset_for_tests()


@pytest.fixture(scope="module")
def skewed():
    create = RTO._skewed_create()
    return (
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
    )


def _model_for(g):
    r = g.cypher("MATCH (x:Person) RETURN count(*) AS c")
    r.records.collect()
    plan = r.relational_plan
    return CostModel(plan.graph, plan.context), plan


def _count(g, q):
    return int(g.cypher(q).records.collect()[0]["c"])


def _bag(records):
    return Counter(tuple(sorted(dict(r).items())) for r in records.collect())


def _notes(result, key="join_order"):
    return [sp.attrs[key] for sp in result.profile().trace.spans() if key in sp.attrs]


# ---------------------------------------------------------------------------
# statistics and estimates
# ---------------------------------------------------------------------------


def test_statistics_match_true_counts_and_reference(skewed):
    ref, _, port = skewed
    local = R.CypherSession.local().create_graph_from_create_query(RTO._skewed_create())
    stats = _model_for(port)[0].stats
    rr = ref.cypher("MATCH (x:Person) RETURN count(*) AS c")
    rr.records.collect()
    rstats = RefGraphStatistics.of(rr.relational_plan.graph, rr.relational_plan.context)
    for labels in ((), ("Person",), ("Admin",)):
        q = "MATCH (x{}) RETURN count(*) AS c".format(
            ":" + labels[0] if labels else "")
        assert stats.node_count(labels) == _count(local, q) == rstats.node_count(labels)
    for types in (("KNOWS",), ("RARE",), ()):
        if types:
            q = f"MATCH ()-[:{types[0]}]->() RETURN count(*) AS c"
            assert stats.rel_count(types) == _count(local, q)
        assert stats.rel_count(types) == rstats.rel_count(types)
        for rev in (False, True):
            assert stats.degree_stats(types, rev) == rstats.degree_stats(types, rev)
            assert stats.avg_degree(types, rev) == rstats.avg_degree(types, rev)
    assert stats.fingerprint() == rstats.fingerprint()
    _, plan = _model_for(port)
    assert GraphStatistics.of(plan.graph, plan.context) is stats


def test_expand_estimate_tracks_true_cardinality(skewed):
    _, local, port = skewed
    model, _ = _model_for(port)
    for q, anchor_labels, hops in (
        ("MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN count(*) AS c",
         ("Person",), [(("KNOWS",), ("Person",))]),
        ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) RETURN count(*) AS c",
         ("Person",), [(("KNOWS",), ()), (("KNOWS",), ())]),
        ("MATCH (a)-[:KNOWS]->(b:Admin) RETURN count(*) AS c",
         (), [(("KNOWS",), ("Admin",))]),
    ):
        true = _count(local, q)
        est, _ = model.scan(anchor_labels)
        for types, labels in hops:
            est, _ = model.expand(est, types, False, labels)
        assert true / 3.0 <= max(est, 0.5) <= max(true, 1) * 3.0, (q, est, true)


# ---------------------------------------------------------------------------
# differential: optimized rows == syntax rows; the reorder fires
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", _CHAIN)
def test_optimizer_rows_identical_to_syntax(skewed, query):
    ref, local, port = skewed
    want = _bag(local.cypher(query).records)
    assert _bag(ref.cypher(query).records) == want
    for mode in ("syntax", "auto", "force"):
        PCFG.OPT_MODE.set(mode)
        assert _bag(port.cypher(query).records) == want, (mode, query)


def _fresh():
    return CypherSession.cuda(device="cpu").create_graph_from_create_query(
        RTO._skewed_create()
    )


def test_reorder_fires_on_skewed_chain():
    PCFG.OPT_MODE.set("force")
    r = _fresh().cypher(_CHAIN[0])
    r.records.collect()
    notes = _notes(r)
    assert notes, "join-order search left no trace note"
    assert notes[0]["chosen"] == "model"
    assert notes[0]["model_cost"] < notes[0]["syntax_cost"]


def test_cyclic_chain_is_not_reordered(skewed):
    _, _, port = skewed
    plans = {}
    for mode in ("syntax", "force"):
        PCFG.OPT_MODE.set(mode)
        r = port.cypher(_CHAIN[3])
        r.records.collect()
        plans[mode] = r.relational_plan.pretty()
    assert plans["syntax"] == plans["force"]


def _cache_state(g, q):
    r = g.cypher(q)
    r.records.collect()
    return r.profile().trace.root.attrs.get("plan_cache")


def test_opt_mode_flip_replans():
    g = _fresh()
    q = _CHAIN[0]
    assert _cache_state(g, q) == "miss"  # cold under the default mode
    assert _cache_state(g, q) == "hit"
    PCFG.OPT_MODE.set("syntax")
    assert _cache_state(g, q) == "miss"  # the mode is in the cache key
    assert _cache_state(g, q) == "hit"
    PCFG.OPT_MODE.reset()
    assert _cache_state(g, q) == "hit"  # the default's entry survived


def test_default_mode_is_auto():
    assert PCFG.OPT_MODE.get() == "auto" == RCFG.OPT_MODE.get()


def test_cache_fingerprint_stable_under_auto():
    """The serving result cache keys on the statistics fingerprint; the
    optimizer's statistics, which ``auto`` now gathers on every planned
    query, leave it as it was when the graph was registered."""
    from tpu_cypher_torch.serve.result_cache import graph_fingerprint

    g = _fresh()
    before = graph_fingerprint(g.session, g)
    for q in _CHAIN:
        g.cypher(q).records.collect()
    assert graph_fingerprint(g.session, g) == before


# ---------------------------------------------------------------------------
# adaptive feedback
# ---------------------------------------------------------------------------


def test_feedback_calibration_accumulates_under_bucketing():
    """The reference samples ``_CHAIN[0]`` (a count) only because its
    lattice pads the index arrays it builds inside the first operator's
    span; the port builds them exactly and its count chain, like the
    reference's, stamps no rows. So the port's sample comes from the
    chain that returns rows, whose expands materialize on the lattice."""
    PCFG.BUCKET_MODE.set("pow2")
    r = _fresh().cypher(_CHAIN[2])
    r.records.collect()
    plan = r.relational_plan
    cal = feedback.get(plan.graph, plan.context)
    assert cal.samples() > 0
    for cls in cal.sec_per_krow:
        assert 0.25 <= cal.weight(cls) <= 4.0


def test_feedback_observes_rows_with_bucketing_off(skewed):
    """Both the binary expand tiers and the multiway intersect stamp their
    (true, padded) rows with the lattice off, so a few queries calibrate
    the WCOJ threshold away from its declared default."""
    _, _, port = skewed
    tri = ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
           "RETURN a.id AS a, count(*) AS c")
    plan = None
    for mode in ("force", "off"):
        PCFG.WCOJ_MODE.set(mode)
        r = port.cypher(tri)
        r.records.collect()
        plan = r.relational_plan
        spans = [sp for sp in r.profile().trace.spans() if sp.kind == "operator"
                 and sp.name in ("MultiwayIntersectOp", "CsrExpandOp", "CsrExpandIntoOp")]
        assert any(int(sp.attrs.get("rows_padded", 0) or 0) > 0 for sp in spans), mode
    cal = feedback.get(plan.graph, plan.context)
    assert cal.unit_cost("MultiwayIntersectOp") is not None
    assert cal.unit_cost("CsrExpandOp") is not None
    assert cal.wcoj_scale() != 1.0
    assert wcoj_threshold(plan.graph, plan.context) != int(PCFG.WCOJ_MIN_ROWS.default)


def test_one_outlier_leaves_wcoj_routing(skewed):
    """One span 100x its class's others (a collector pause on a served
    query) cannot pull an estimate past the class's other samples: each is
    the median of the class's last samples, so ``prefer_wcoj`` decides as
    it did. The reference's rule,
    an EMA at 20% a step, moves the binary tier's cost 20.8-fold here and
    flips the choice; the port departs from it (ROADMAP.md §3)."""
    _, _, port = skewed
    _, plan = _model_for(port)
    graph, ctx = plan.graph, plan.context
    cal = feedback.get(graph, ctx)
    for _ in range(4):
        cal.observe_span("MultiwayIntersectOp", 0.002, 1000, 1000)
        cal.observe_span("CsrExpandIntoOp", 0.001, 1000, 1000)
    base = wcoj_threshold(graph, ctx)
    est = base + base // 2  # above the threshold: WCOJ
    assert PCOST.prefer_wcoj(est, graph, ctx)
    cal.observe_span("CsrExpandIntoOp", 0.1, 1000, 1000)
    assert cal.unit_cost("CsrExpandIntoOp") == pytest.approx(1e-3)
    assert wcoj_threshold(graph, ctx) == base
    assert PCOST.prefer_wcoj(est, graph, ctx)
    ema = 1e-3 + 0.2 * (0.1 - 1e-3)  # the reference's rule on the same samples
    assert int(int(PCFG.WCOJ_MIN_ROWS.default) * max(0.25, 2e-3 / ema)) < base // 2


def test_calibration_round_trips_its_window():
    cal = feedback.Calibration()
    for v in (3.0, 1.0, 2.0):
        cal.observe_span("CsrExpandOp", v, 1000, 500)
    back = feedback.Calibration.from_json(cal.to_json())
    assert back.unit_cost("CsrExpandOp") == cal.unit_cost("CsrExpandOp") == 2.0
    back.observe_span("CsrExpandOp", 300.0, 1000, 500)
    assert back.unit_cost("CsrExpandOp") == 2.0 and back.samples() == 4
    old = feedback.Calibration.from_json({"sec_per_krow": {"CsrExpandOp": [5.0, 9]}})
    assert old.unit_cost("CsrExpandOp") == 5.0 and old.samples() == 9


# ---------------------------------------------------------------------------
# overrides
# ---------------------------------------------------------------------------


def test_wcoj_threshold_override_wins_verbatim(skewed):
    _, _, port = skewed
    _, plan = _model_for(port)
    assert wcoj_threshold(plan.graph, plan.context) == int(PCFG.WCOJ_MIN_ROWS.default)
    PCFG.WCOJ_MIN_ROWS.set(123)
    assert wcoj_threshold(plan.graph, plan.context) == 123


def test_broadcast_limit_only_extends():
    declared = int(PCFG.BROADCAST_LIMIT.get())
    assert broadcast_build_limit(64, 8) == declared
    assert broadcast_build_limit(1_000_000, 8) >= declared
    PCFG.BROADCAST_LIMIT.set(declared)
    assert broadcast_build_limit(1_000_000, 8) == declared


def test_serve_estimate_monotone_in_hops(skewed):
    _, _, port = skewed
    _model_for(port)  # attach statistics so the stats-fed path runs
    base = getattr(port, "_graph", port)
    costs = [
        estimate_query_cost_bytes(base, q, fallback_rows=1000, bytes_per_row=16)
        for q in (
            "MATCH (a) RETURN a",
            "MATCH (a)-[:KNOWS]->(b) RETURN a",
            "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(c) RETURN a",
        )
    ]
    assert costs[0] < costs[1] < costs[2]


@pytest.mark.parametrize("pin,cap", [(None, 256), (128, 128), (1 << 20, 256)])
def test_pinned_group_cap_only_lowers(monkeypatch, pin, cap):
    """A 256-group ``min`` is eligible for the ``segment_agg`` kernel
    unless ``TPU_CYPHER_PALLAS_MAX_GROUPS`` is pinned below 256, which
    sends it to the ``fallback`` tier on the card; a pin above the kernel's
    256 leaves the cap at 256. On the CPU every call runs the plain tier,
    so the gate's eligibility verdict is read where it is passed."""
    from tpu_cypher_torch.backend.cuda.hopper import aggregate, dispatch

    if pin is not None:
        PCFG.PALLAS_MAX_GROUPS.set(pin)
    assert PCOST.pallas_cap("aggregate") == cap
    seen = []
    real = dispatch.launch

    def spy(name, kernel_fn, plain_fn, *, device, eligible=True):
        seen.append((name, eligible))
        return real(name, kernel_fn, plain_fn, device=device, eligible=eligible)

    monkeypatch.setattr(aggregate.dispatch, "launch", spy)
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        "CREATE " + ", ".join(f"(n{i}:P {{g: {i}, v: {i * 3}}})" for i in range(256))
    )
    rows = g.cypher("MATCH (a:P) RETURN a.g AS g, min(a.v) AS m").records.collect()
    assert sorted((r["g"], r["m"]) for r in rows) == [(i, 3 * i) for i in range(256)]
    assert ("segment_agg", cap >= 256) in seen, seen


def test_other_caps_clip_to_the_kernels():
    for kernel, knob in (("expand", PCFG.PALLAS_MAX_FRONTIER),
                         ("intersect", PCFG.PALLAS_MAX_KEYS),
                         ("join", PCFG.PALLAS_MAX_BUILD),
                         ("frontier", PCFG.PALLAS_MAX_NODES)):
        limit = PCOST.pallas_cap(kernel)
        assert limit == int(knob.default)
        knob.set(7)
        assert PCOST.pallas_cap(kernel) == 7
        knob.set(limit * 2)
        assert PCOST.pallas_cap(kernel) == limit
        knob.reset()


# ---------------------------------------------------------------------------
# bench.py's join-order leg, at a tenth of its size
# ---------------------------------------------------------------------------


def _join_order_arrays(n=3_000, dense_e=30_000, rare_e=60):
    """``bench.py`` ``_join_order_graph``'s arrays, scaled: the same draws
    from ``default_rng(17)``."""
    rng = np.random.default_rng(17)
    ids = np.arange(n, dtype=np.int64)
    rels = []
    for count, base in ((dense_e, 1 << 40), (rare_e, 1 << 41)):
        src = rng.integers(0, n, count)
        dst = rng.integers(0, n, count)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        rels.append((np.arange(len(src), dtype=np.int64) + base, src, dst))
    return ids, ids % 50 == 0, rels


def _join_order_graph(pkg, session, arrays):
    """The graph from the arrays, through ``pkg``'s own graph API."""
    import importlib

    mapping = importlib.import_module(pkg + ".api.mapping")
    schema_mod = importlib.import_module(pkg + ".api.schema")
    graphs = importlib.import_module(pkg + ".relational.graphs")
    sess = importlib.import_module(pkg + ".relational.session")
    types = importlib.import_module(pkg + ".api.types")
    ids, admin, rels = arrays
    tables = []
    for label, mask in (("Person", ~admin), ("Admin", admin)):
        tables.append(graphs.ElementTable(
            mapping.NodeMapping(id_key="id", implied_labels=frozenset({label}),
                                property_mapping=(("id", "id"),)),
            session.table_cls.from_arrays({"id": ids[mask]}),
        ))
    for rtype, (eids, src, dst) in zip(("KNOWS", "RARE"), rels):
        tables.append(graphs.ElementTable(
            mapping.RelationshipMapping(id_key="id", source_key="source",
                                        target_key="target", rel_type=rtype),
            session.table_cls.from_arrays({"id": eids, "source": src, "target": dst}),
        ))
    prop_types = {"id": types.CTInteger.nullable}
    schema = (
        schema_mod.PropertyGraphSchema.empty()
        .with_node_combination(frozenset({"Person"}), prop_types)
        .with_node_combination(frozenset({"Admin"}), prop_types)
        .with_relationship_type("KNOWS", {})
        .with_relationship_type("RARE", {})
    )
    return sess.PropertyGraph(session, graphs.ScanGraph(tables, schema))


@pytest.fixture(scope="module")
def join_order_graphs():
    arrays = _join_order_arrays()
    return (
        _join_order_graph("tpu_cypher", R.CypherSession.tpu(), arrays),
        _join_order_graph("tpu_cypher", R.CypherSession.local(), arrays),
        _join_order_graph("tpu_cypher_torch", CypherSession.cuda(device="cpu"), arrays),
    )


# bench.py _JOIN_ORDER_QUERIES, verbatim
_JOIN_ORDER = {
    "rare_last": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:RARE]->(c:Admin) "
                 "RETURN count(*) AS c",
    "rare_mid": "MATCH (a:Person)-[:KNOWS]->(b)-[:RARE]->(c)-[:KNOWS]->(d:Person) "
                "RETURN count(*) AS c",
    "label_last": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Admin) "
                  "RETURN count(*) AS c",
    "cycle_close": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:RARE]->(c)-[:KNOWS]->(a) "
                   "RETURN count(*) AS c",
    "filter_hoist": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Admin) "
                    "WHERE c.id < 40 RETURN count(*) AS c",
}


@pytest.mark.parametrize("name", sorted(_JOIN_ORDER))
def test_join_order_matches_reference(join_order_graphs, name):
    ref, local, port = join_order_graphs
    query = _JOIN_ORDER[name]
    want = _bag(local.cypher(query).records)
    for mode in ("syntax", "auto", "force"):
        for cfg, fb in ((PCFG, feedback), (RCFG, RFB)):
            cfg.OPT_MODE.set(mode)
            fb.reset_for_tests()
        r_ref, r_port = ref.cypher(query), port.cypher(query)
        assert _bag(r_port.records) == _bag(r_ref.records) == want, (mode, name)
        assert _notes(r_port) == _notes(r_ref), (mode, name)
