"""The closing ExpandInto and the fused OPTIONAL expand: the port against the
JAX package, on the CPU.

* The ``jit_ops`` functions of the two operators (the optional expand's
  degrees and lane merge, the ExpandInto probe, its materialize, the
  undirected halves' concat, and the close counts with and without
  relationship uniqueness) against the reference's on the same seeded
  numpy CSR with self-loops and parallel edges. Where the port splits a
  reference function around a kernel gate (the probe's range count on
  ``intersect``, a walk hop's lane merge on ``expand_rows``), the test
  composes the parts as ``expand_op`` does, through the gates' CPU
  (``plain``) tiers. Every output is compared exactly.
* The queries of ``tests/test_into_close_count.py`` and the optional test
  of ``tests/test_kernels.py`` across the reference's
  ``CypherSession.tpu()``, its ``local()`` oracle and the port,
  bag-identical, with the operator each plan must show. The closes run
  under ``TPU_CYPHER_WCOJ=off``, the binary plan, which both engines'
  ``auto`` picks on these small graphs too. The reference's
  own forms (``count(y)``, ``count(DISTINCT a)``, ``r.w`` of a type the
  schema lacks, ``id(r1)``) run beside the forms that count or return a
  property in their place.
* The empty cases (a graph with no node, a type set with no edge, a
  frontier with no row), which return before a gate call, and a device
  fault inside the close count, which reaches the caller typed.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.utils import config as RCFG

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as ERR
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import expand_op as PX
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.hopper import intersect_range_count
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    for cfg in (RCFG, PCFG):
        cfg.WCOJ_MODE.reset()
    PD.reset()


def _same(want, got, what=""):
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.shape == g.shape, (what, w.shape, g.shape)
    assert np.array_equal(w.astype(np.int64), g.astype(np.int64)), (what, w, g)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the jit_ops functions against the reference's
# ---------------------------------------------------------------------------

N = 40


def _graph(seed=3, n=N, e=160):
    """A seeded CSR with self-loops and parallel edges: (rp int32, ci int32,
    eo int64, sorted src*N+dst keys, the key of each canonical row)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, n, e), [5, 5, 9, 9, n - 1]])
    d = np.concatenate([rng.integers(0, n, e), [5, 5, 9, 2, 3]])
    s = np.concatenate([s, s[:6]])  # parallel edges
    d = np.concatenate([d, d[:6]])
    order = np.lexsort((d, s))
    rp = np.searchsorted(s[order], np.arange(n + 1)).astype(np.int32)
    keys = s[order].astype(np.int64) * n + d[order]
    return rp, d[order].astype(np.int32), order.astype(np.int64), keys, s * n + d


# (frontier, far-label mask, lanes: exact, or bucketed with dead pad lanes
# past nvalid)
FRONTIERS = [
    ("dead", True, "bucketed"),
    ("live", False, "exact"),
    ("live", True, "exact"),
    ("live", False, "bucketed"),
    ("live", True, "bucketed"),
]


def _frontier(kind, with_mask, lanes, seed=11, f=25):
    rng = np.random.default_rng(seed)
    rp, ci, eo, keys, kbo = _graph()
    pos = rng.integers(0, N, f).astype(np.int64)
    pos[:4] = [5, 9, N - 1, 0]  # the loop, parallel-edge and last rows
    present = rng.random(f) < 0.85 if kind == "live" else np.zeros(f, bool)
    deg = np.where(present, rp[pos + 1] - rp[pos], 0).astype(np.int64)
    total = int(deg.sum())
    akey = rng.integers(0, N, f).astype(np.int64)
    akey[:3] = pos[:3]  # closes onto a loop
    mask = rng.random(N) < 0.6 if with_mask else None
    # carried edges drawn from the edges themselves, so the pairs bite
    prevs = tuple(eo[rng.integers(0, len(eo), f)] for _ in range(2))
    size = total if lanes == "exact" else max(32, 1 << max(total - 1, 0).bit_length())
    nvalid = None if lanes == "exact" else total
    return dict(rp=rp, ci=ci, eo=eo, keys=keys, kbo=kbo, pos=pos, present=present,
                deg=deg, akey=akey, mask=mask, prevs=prevs, size=size, nvalid=nvalid)


def _lanes(x, with_orig):
    """The final hop's lanes as the walk merges them (the expand_rows gate)."""
    return PX._walk_lanes(_t(x["rp"]), _t(x["ci"]), _t(x["eo"]), _t(x["pos"]),
                          _t(x["deg"]), x["size"], x["nvalid"], with_orig)


def _ref_nvalid(x):
    return None if x["nvalid"] is None else jnp.asarray(x["nvalid"], jnp.int64)


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("src_is_base", [True, False])
@pytest.mark.parametrize("kind,with_mask,lanes", FRONTIERS)
def test_close_count_matches_reference(kind, with_mask, lanes, src_is_base, undirected):
    x = _frontier(kind, with_mask, lanes)
    want = RJ.into_close_count(
        _j(x["rp"]), _j(x["ci"]), _j(x["pos"]), _j(x["deg"]), _j(x["akey"]),
        _j(x["mask"]), _j(x["keys"]), total=x["size"], src_is_base=src_is_base,
        num_nodes=N, undirected=undirected, nvalid=_ref_nvalid(x),
    )
    queries = PJ.into_close_queries(
        _lanes(x, False), _t(x["akey"]), _t(x["mask"]), src_is_base=src_is_base,
        num_nodes=N, undirected=undirected,
    )
    assert len(queries) == 1 + undirected
    got = sum(int(intersect_range_count(_t(x["keys"]), q, ok)[2]) for q, ok in queries)
    assert int(want) == got
    counts = PD.use_counts()
    assert counts["intersect"]["plain"] == 1 + undirected
    assert counts["expand_rows"]["plain"] == 1


UNIQUE_SPECS = [  # (mask_idx, sub_idx, sub_cur)
    ((), (), True),
    ((0,), (1,), False),
    ((), (0, 1), True),
    ((0, 1), (1, 0), True),
]


@pytest.mark.parametrize("mask_idx,sub_idx,sub_cur", UNIQUE_SPECS)
@pytest.mark.parametrize("src_is_base", [True, False])
@pytest.mark.parametrize("kind,with_mask,lanes", FRONTIERS[:2] + FRONTIERS[-1:])
def test_close_count_unique_matches_reference(kind, with_mask, lanes, src_is_base,
                                              mask_idx, sub_idx, sub_cur):
    x = _frontier(kind, with_mask, lanes)
    prevs = x["prevs"]
    # a carried edge equal to the other one: each distinct edge subtracts once
    prevs = (prevs[0], np.where(np.arange(len(prevs[1])) % 3 == 0, prevs[0], prevs[1]))
    want = RJ.into_close_count_unique(
        _j(x["rp"]), _j(x["ci"]), _j(x["eo"]), _j(x["pos"]), _j(x["deg"]),
        _j(x["akey"]), _j(x["mask"]), _j(x["keys"]), _j(x["kbo"]),
        tuple(_j(p) for p in prevs), total=x["size"], src_is_base=src_is_base,
        num_nodes=N, mask_idx=mask_idx, sub_idx=sub_idx, sub_cur=sub_cur,
        nvalid=_ref_nvalid(x),
    )
    probe, ok, orig, prevs_r = PJ.into_close_unique_queries(
        _lanes(x, True), _t(x["akey"]), _t(x["mask"]), tuple(_t(p) for p in prevs),
        src_is_base=src_is_base, num_nodes=N, mask_idx=mask_idx,
    )
    _, counts, _ = intersect_range_count(_t(x["keys"]), probe, ok)
    got = PJ.into_close_count_unique(counts, probe, ok, orig, prevs_r, _t(x["kbo"]),
                                     sub_idx=sub_idx, sub_cur=sub_cur)
    assert int(want) == int(got)


@pytest.mark.parametrize("drop_loops", [False, True])
def test_into_probe_and_materialize_match_reference(drop_loops):
    rng = np.random.default_rng(5)
    rp, ci, eo, keys, _ = _graph()
    m = 60
    s_pos = rng.integers(0, N, m).astype(np.int64)
    t_pos = rng.integers(0, N, m).astype(np.int64)
    s_pos[:3], t_pos[:3] = [5, 9, 9], [5, 9, 2]  # loops, parallel edges
    ok = rng.random(m) < 0.9
    want = RJ.into_probe(_j(keys), _j(s_pos), _j(t_pos), _j(ok), N, drop_loops=drop_loops)
    q, q_ok = PJ.into_probe(_t(s_pos), _t(t_pos), _t(ok), N, drop_loops=drop_loops)
    got = intersect_range_count(_t(keys), q, q_ok)
    for w, g, what in zip(want, got, ("lo", "counts", "total")):
        _same(w, g, what)
    total = int(got[2])
    assert total > 0
    rows = RJ.into_materialize(_j(eo), want[0], want[1], total=total)
    row, orig, live = PJ.into_materialize_counted(_t(eo), got[0], got[1], got[2], total)
    assert bool(live.all())
    for w, g in zip(rows, (row, orig)):
        _same(w, g, "into_materialize")
    half = total // 2
    parts = (rows[0][:half], rows[1][:half], rows[0][half:], rows[1][half:])
    for w, g in zip(RJ.concat_into_halves(*parts),
                    PJ.concat_into_halves(*(_t(np.asarray(p)) for p in parts))):
        _same(w, g, "concat_into_halves")


@pytest.mark.parametrize("types", ["edges", "none"])
@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("kind", ["live", "dead", "full"])
def test_optional_lanes_match_reference(kind, pads, types):
    """``optional_expand_degrees``, the plain ``optional_expand_materialize``
    and the operator's merge (the ``expand_rows`` gate over the matched
    lanes, then ``optional_place``) against the reference's: the plain
    version on every lane, unmatched lanes' clipped reads included; the
    merge on every lane's row and ``matched`` and on the matched lanes'
    ``nbr`` and ``orig`` (an unmatched lane's are masked null
    downstream). The last node (its row start is the end of ``ci``) and
    an empty type set are in the cases."""
    rng = np.random.default_rng(13)
    rp, ci, eo, _, _ = _graph()
    if types == "none":
        rp, ci, eo = np.zeros(N + 1, np.int32), ci[:0], eo[:0]
    f = 30
    pos = rng.integers(0, N, f).astype(np.int64)
    pos[:3] = [N - 1, 5, 0]
    present = rng.random(f) < 0.8 if kind == "live" else np.zeros(f, bool)
    if kind == "full":
        # every row present; with edges every row matched (the merge is the
        # gate's lanes as they stand), with an empty type set none
        if types == "edges":
            pos = rng.choice(np.flatnonzero(np.diff(rp) > 0), f).astype(np.int64)
        present = np.ones(f, bool)
    nrows = 24 if pads else None
    want_d = RJ.optional_expand_degrees(_j(rp), _j(pos), _j(present),
                                        nrows=None if nrows is None else jnp.int64(nrows))
    got_d = PJ.optional_expand_degrees(_t(rp), _t(pos), _t(present), nrows=nrows)
    for w, g in zip(want_d, got_d):
        _same(w, g, "optional_expand_degrees")
    deg, counts, total = got_d
    total = int(total)
    want = RJ.optional_expand_materialize(_j(rp), _j(ci), _j(eo), _j(pos), want_d[0],
                                          want_d[1], total=total)
    plain = PJ.optional_expand_materialize(_t(rp), _t(ci), _t(eo), _t(pos), deg, counts,
                                           total)
    merged = PX._optional_lanes(_t(rp), _t(ci), _t(eo), _t(pos), deg, counts, total,
                                int(deg.sum()))
    for i, (w, p) in enumerate(zip(want, plain)):
        _same(w, p, ("plain", i))
    hit = np.asarray(want[3])
    _same(want[0], merged[0], ("merge", "row"))
    _same(want[3], merged[3], ("merge", "matched"))
    for i in (1, 2):
        _same(np.asarray(want[i])[hit], merged[i].numpy()[hit], ("merge", i))
    launched = PD.use_counts()["expand_rows"]["plain"]
    assert launched == int(bool(deg.sum()))


def test_optional_lanes_empty_input():
    z = torch.zeros(0, dtype=torch.int64)
    rp = torch.zeros(N + 1, dtype=torch.int32)
    row, nbr, orig, matched = PX._optional_lanes(rp, rp[:0], z, z, z, z, 0, 0)
    assert row.shape == nbr.shape == orig.shape == matched.shape == (0,)
    assert PD.use_counts()["expand_rows"]["plain"] == 0


# ---------------------------------------------------------------------------
# queries across the three engines
# ---------------------------------------------------------------------------


def _bag(result):
    return Counter(tuple(sorted(dict(r).items())) for r in result.records.collect())


def _engines(create):
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
    )


def _three(engines, query, mode="off"):
    """Bag-identical rows across the port, the reference and its oracle,
    with ``TPU_CYPHER_WCOJ`` at ``mode`` in both engines; one device
    attempt, every kernel on its CPU tier. Returns the port's result and
    rows."""
    port, ref, local = engines
    for cfg in (RCFG, PCFG):
        cfg.WCOJ_MODE.set(mode)
    PD.reset()
    result = port.cypher(query)
    got = _bag(result)
    assert got == _bag(ref.cypher(query)), query
    assert got == _bag(local.cypher(query)), query
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    for name, c in PD.use_counts().items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
    return result, got


def _random_create(seed, n, e, labels=("N",)):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    parts = [f"(n{i}:{labels[i % len(labels)]} {{v: {i}}})" for i in range(n)]
    parts += [f"(n{s})-[:K]->(n{d})" for s, d in zip(src, dst)]
    return "CREATE " + ", ".join(parts)


def _random_create_loop_free(seed, n, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    parts = [f"(n{i}:N {{v: {i}}})" for i in range(n)]
    parts += [f"(n{s})-[:K]->(n{d})" for s, d in zip(src, dst)]
    return "CREATE " + ", ".join(parts)


TRIANGLE = "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS t"
UNDIRECTED = "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]-(a) RETURN count(*) AS t"

# tests/test_into_close_count.py's QUERIES
QUERIES = [
    TRIANGLE,
    # labeled intermediate/far nodes (label masks inside the chain walk)
    "MATCH (a:N)-[:K]->(b:N)-[:K]->(c:N)-[:K]->(a) RETURN count(*) AS t",
    # 2-cycle close: single-hop chain under the into op
    "MATCH (a)-[:K]->(b)-[:K]->(a) RETURN count(*) AS t",
    # undirected close: both probe orientations, loops dropped once
    UNDIRECTED,
    # backwards hop inside the chain
    "MATCH (a)<-[:K]-(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS t",
    # 4-cycle: longer chain before the close
    "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(d)-[:K]->(a) RETURN count(*) AS t",
]


@pytest.fixture(scope="module")
def close_graph():
    return _engines(_random_create(7, 30, 150, labels=("N", "M")))


@pytest.mark.parametrize("query", QUERIES)
def test_close_count_across_engines(close_graph, query):
    result, _ = _three(close_graph, query)
    assert "CsrExpandIntoOp" in result.plans
    counts = PD.use_counts()
    assert counts["intersect"]["plain"] > 0 and counts["expand_rows"]["plain"] > 0


@pytest.mark.parametrize("create,expected", [
    ("CREATE (x:N)-[:K]->(x)", 0),
    ("CREATE (x:N)-[:K]->(y:N), (y)-[:K]->(x), (x)-[:K]->(x)", 3),
])
def test_close_count_self_loops_and_cycles(create, expected):
    """Self-loops close only onto themselves; relationship isomorphism makes
    most of these 0."""
    _, got = _three(_engines(create), TRIANGLE)
    assert got == Counter({(("t", expected),): 1})


def _spy(monkeypatch, name, calls):
    inner = getattr(PJ, name)

    def spy(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(PJ, name, spy)


@pytest.mark.parametrize("seed,loopy", [(3, True), (11, False)])
def test_close_count_uses_fused_program(monkeypatch, seed, loopy):
    """The triangle count(*) goes through the fused close count (no chain
    materialization) whether or not the graph has self-loops: a loop-free
    graph drops the uniqueness filters by proof (``into_close_queries``),
    a loopy one enforces them in the count (``into_close_unique_queries``
    and ``into_close_count_unique``, with no FilterOp above the operator).
    The materializing ``into_probe`` never runs."""
    calls = {}
    for name in ("into_close_queries", "into_close_unique_queries",
                 "into_close_count_unique", "into_probe"):
        _spy(monkeypatch, name, calls)
    create = _random_create(seed, 20, 80) if loopy else _random_create_loop_free(seed, 20, 80)
    result, _ = _three(_engines(create), TRIANGLE)
    if loopy:
        assert calls == {"into_close_unique_queries": 1, "into_close_count_unique": 1}
        rel = result.plans.split("=== Relational plan ===")[1].strip().splitlines()
        assert rel[0].startswith("AggregateOp")
        assert rel[1].strip().startswith("CsrExpandIntoOp(") and " uniq(" in rel[1]
    else:
        assert calls == {"into_close_queries": 1}
        assert "uniq" not in result.plans


@pytest.mark.parametrize("counted", ["a.v", "a"])
def test_close_count_materializes_when_columns_needed(monkeypatch, counted):
    """A close whose columns are read takes the materialize path (both
    endpoints probed on the intersect gate): ``count(DISTINCT a)`` of the
    reference's test, and of a property."""
    calls = {}
    _spy(monkeypatch, "into_probe", calls)
    q = f"MATCH (a:N)-[:K]->(b)-[:K]->(c)-[:K]->(a) RETURN count(DISTINCT {counted}) AS t"
    result, _ = _three(_engines(_random_create(9, 25, 120)), q)
    assert "CsrExpandIntoOp" in result.plans
    assert calls["into_probe"] >= 1


@pytest.mark.parametrize("query", [
    "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]-(a) RETURN a.v AS a, b.v AS b, c.v AS c",
    "MATCH (a)-[r:K]->(b)-[s:K]->(c)-[t:K]->(a) RETURN a.v AS a, b.v AS b, c.v AS c",
    "MATCH (a)-[:K]->(b)-[:K]->(a) RETURN a.v AS a, b.v AS b",
])
def test_loopy_close_rows(query):
    """Rows of a close on a graph with self-loops and parallel edges: the
    undirected close's pairs over both halves, the directed close's pairs
    by element-id masks (``_apply_enforced_pairs``)."""
    rng = np.random.default_rng(4)
    n, e = 12, 40
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    parts = [f"(n{i}:N {{v: {i}}})" for i in range(n)]
    parts += [f"(n{s})-[:K]->(n{d})" for s, d in zip(src, dst)]
    parts += ["(n1)-[:K]->(n1)", "(n2)-[:K]->(n3)", "(n2)-[:K]->(n3)"]
    result, got = _three(_engines("CREATE " + ", ".join(parts)), query)
    assert "CsrExpandIntoOp" in result.plans and sum(got.values()) > 0


def test_plans_show_expand_into():
    """``tests/test_tpu_backend.py``'s plan check: the triangle under ``off``
    and under ``auto`` (this small graph's blowup estimate lies under the
    WCOJ threshold) and the undirected close all plan ``CsrExpandIntoOp``;
    under ``force`` the directed triangle goes to WCOJ."""
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        _random_create(7, 10, 30))
    for mode in ("off", "auto"):
        PCFG.WCOJ_MODE.set(mode)
        plans = port.cypher(TRIANGLE).plans
        assert "CsrExpandIntoOp" in plans and "MultiwayIntersectOp" not in plans
    PCFG.WCOJ_MODE.set("force")
    assert "MultiwayIntersectOp" in port.cypher(TRIANGLE).plans
    PCFG.WCOJ_MODE.set("auto")
    plans = port.cypher(UNDIRECTED).plans
    assert "CsrExpandIntoOp" in plans and "MultiwayIntersectOp" not in plans


def _optional_create():
    rng = np.random.default_rng(17)
    n, e = 25, 50
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    parts = [f"(n{i}:V {{i:{i}}})" for i in range(n)]
    parts += [f"(n{s})-[:E {{w:{int(w)}}}]->(n{d})" for s, d, w in
              zip(src, dst, rng.integers(0, 5, e))]
    return "CREATE " + ", ".join(parts)


@pytest.fixture(scope="module")
def optional_graph():
    return _engines(_optional_create())


# tests/test_kernels.py's optional test, and each count(y) as count(y.i)
OPTIONAL_FUSED = [
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:E]->(y) "
    "RETURN count(*) AS rows, count(y) AS m, sum(r.w) AS s",
    "MATCH (x:V) OPTIONAL MATCH (x)-[:E]->(y) RETURN x.i, count(y) AS c ORDER BY x.i",
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:NOPE]->(y) RETURN x.i, r.w, y.i ORDER BY x.i",
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:E]->(y) RETURN x.i, y.i, r.w ORDER BY x.i, y.i, r.w",
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:E]->(y) "
    "RETURN count(*) AS rows, count(y.i) AS m, sum(r.w) AS s",
    "MATCH (x:V) OPTIONAL MATCH (x)-[:E]->(y) RETURN x.i, count(y.i) AS c ORDER BY x.i",
    # backward: the bound var is the edge's target
    "MATCH (x:V) OPTIONAL MATCH (y)-[r:E]->(x) RETURN x.i, y.i, r.w ORDER BY x.i, y.i, r.w",
    # no relationship of the requested type: every row null-padded
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:NOPE]->(y) RETURN x.i, y.i ORDER BY x.i",
]
OPTIONAL_CLASSIC = [
    "MATCH (x:V) WHERE x.i > 20 OPTIONAL MATCH (x)-[:E]->(y) RETURN x.i, count(y) AS c "
    "ORDER BY x.i",
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:E]->(y) WHERE y.i > 10 RETURN count(y) AS c",
    "MATCH (x:V) OPTIONAL MATCH (x)-[:E]-(y) RETURN count(y) AS c",
    # WHERE on the base match and inside OPTIONAL, an undirected pattern
    # and far labels keep the classic outer join
    "MATCH (x:V) WHERE x.i > 20 OPTIONAL MATCH (x)-[:E]->(y) RETURN x.i, count(y.i) AS c "
    "ORDER BY x.i",
    "MATCH (x:V) OPTIONAL MATCH (x)-[r:E]->(y) WHERE y.i > 10 RETURN count(y.i) AS c",
    "MATCH (x:V) OPTIONAL MATCH (x)-[:E]-(y) RETURN count(y.i) AS c",
    # a labelled far side
    "MATCH (x:V) OPTIONAL MATCH (x)-[:E]->(y:V) RETURN count(y.i) AS c",
]


@pytest.mark.parametrize("query", OPTIONAL_FUSED)
def test_optional_fused_across_engines(optional_graph, monkeypatch, query):
    calls = {}
    _spy(monkeypatch, "optional_place", calls)
    result, _ = _three(optional_graph, query, mode="auto")
    assert "CsrOptionalExpandOp" in result.plans
    assert "JoinOp(left_outer" not in result.plans.split("=== Relational plan ===")[1]\
        .split("CsrOptionalExpandOp")[0]
    assert calls == {"optional_place": 1}
    launched = PD.use_counts()["expand_rows"]["plain"]
    assert launched == (0 if "NOPE" in query else 1)


@pytest.mark.parametrize("query", OPTIONAL_CLASSIC)
def test_optional_classic_across_engines(optional_graph, query):
    result, _ = _three(optional_graph, query, mode="auto")
    assert "CsrOptionalExpandOp" not in result.plans
    assert "JoinOp(left_outer" in result.plans


# ---------------------------------------------------------------------------
# the empty cases and a device fault
# ---------------------------------------------------------------------------


EMPTY_CASES = [  # (query, operator, expand_rows calls)
    # a type set with no edge: the close count returns before the walk, the
    # materialize after the chain's expand and before the probe
    ("MATCH (a)-[:K]->(b)-[:NOPE]->(a) RETURN count(*) AS t", "CsrExpandIntoOp", 0),
    ("MATCH (a)-[:K]->(b)-[:NOPE]-(a) RETURN count(DISTINCT a.v) AS n",
     "CsrExpandIntoOp", 1),
    ("MATCH (a:N) OPTIONAL MATCH (a)-[:NOPE]->(b) RETURN count(*) AS n",
     "CsrOptionalExpandOp", 0),
    # a frontier with no row (the optional expand's: its lanes test above)
    ("MATCH (a:N) WHERE a.v > 100 WITH a MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(a) "
     "RETURN count(*) AS t", "CsrExpandIntoOp", 0),
    ("MATCH (a:N) WHERE a.v > 100 WITH a MATCH (a)-[:K]->(b)-[:K]->(a) "
     "RETURN count(DISTINCT a.v) AS n", "CsrExpandIntoOp", 0),
]


@pytest.mark.parametrize("query,op,launches", EMPTY_CASES)
def test_empty_cases(query, op, launches):
    """Each returns before a gate call that would be empty."""
    result, got = _three(_engines(_random_create(7, 10, 30)), query)
    assert op in result.plans and sum(got.values()) == 1
    counts = PD.use_counts()
    assert counts["intersect"]["plain"] == 0
    assert counts["expand_rows"]["plain"] == launches


def test_empty_graph_declines():
    """A graph with no node: both hooks decline (the reference answers it
    from its classic child), and the classic plans answer."""
    from tpu_cypher.io.ldbc import _graph_from_arrays as ref_graph_from_arrays
    from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

    from tpu_cypher_torch import interop
    from tpu_cypher_torch.api import types as PT

    empty = np.zeros(0, np.int64)
    engines = [interop.graph_from_arrays(
        CypherSession.cuda(device="cpu"), empty, {}, {"id": PT.CTInteger.nullable},
        empty, empty)]
    for session in (R.CypherSession.tpu(), R.CypherSession.local()):
        g = ref_graph_from_arrays(session, empty, {"id": empty},
                                  {"id": R.api.types.CTInteger.nullable}, empty, empty, False)
        engines.append(RefPropertyGraph(session, g))
    for q, want in (
        ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]-(a) "
         "RETURN count(*) AS t", {"t": 0}),
        ("MATCH (a:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) RETURN count(*) AS n", {"n": 0}),
    ):
        result, got = _three(engines, q)
        assert got == Counter({tuple(want.items()): 1})
        assert "CsrExpandIntoOp" not in result.plans
        assert "CsrOptionalExpandOp" not in result.plans


def test_close_count_device_fault_reaches_caller(monkeypatch):
    """A device fault inside the fused close count is not taken for "the
    pattern doesn't fit": it reaches the caller typed after one device
    attempt, and the materialize path never runs."""
    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(PJ, "into_close_queries", oom)
    monkeypatch.setattr(PJ, "into_probe", lambda *a, **k: pytest.fail("into_probe called"))
    PCFG.WCOJ_MODE.set("off")
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        _random_create_loop_free(11, 20, 80))
    result = port.cypher(TRIANGLE)
    with pytest.raises(ERR.DeviceOOM):
        result.records
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["error"] == "DeviceOOM"


# ---------------------------------------------------------------------------
# chip_smoke.py's Q22-Q26 and loopy closes at a small size, held to the
# truths chip_smoke.py holds the card to
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snb_close():
    import chip_smoke as CS
    from tpu_cypher_torch import interop
    from tpu_cypher_torch.api import types as PT
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    session = CypherSession.cuda(device="cpu")
    g = PropertyGraph(session, generate_snb(0.02, session, seed=CS.SEED))
    ids, _, src, dst = CS.graph_arrays(g)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    tri = CS.triangle_truth(ids, src, dst, rows_and_cliques=True)
    idsl, srcl, dstl = CS.loopy_arrays(60, 400)
    truth = CS.close_truth(ids, tri, ids, s, d, tri, idsl, srcl, dstl)
    half = truth["Q26_half"]
    graphs = {
        "snb": g,
        "half": interop.graph_from_arrays(session, ids, {}, {"id": PT.CTInteger.nullable},
                                          src[half], dst[half]),
        "loopy": interop.graph_from_arrays(session, idsl, {}, {"id": PT.CTInteger.nullable},
                                           srcl, dstl),
    }
    return CS, graphs, truth, CS.loopy_triangles(srcl, dstl), (ids, src, dst)


def test_chip_close_queries_match_truth(snb_close):
    """Each of chip_smoke.py's close and OPTIONAL queries on the operator
    and the path phase 4 checks, equal to its truth (Q26's page cut to
    1,000 rows)."""
    CS, graphs, truth, loopy_tri, _ = snb_close

    def rows(graph, q, op, mode="auto"):
        PCFG.WCOJ_MODE.set(mode)
        result = graphs[graph].cypher(q)
        assert op in result.plans, q
        return [dict(r) for r in result.records.collect()]

    assert rows("snb", CS.Q22, "CsrExpandIntoOp") == [{"t": truth["Q22"]}]
    assert rows("snb", CS.Q23, "CsrExpandIntoOp", "off") == [{"triangles": truth["Q23"]}]
    got = rows("snb", CS.Q24, "CsrExpandIntoOp")
    assert {r["a"]: r["n"] for r in got} == truth["Q24"] and len(got) == len(truth["Q24"])
    assert rows("snb", CS.Q25, "CsrOptionalExpandOp") == [truth["Q25"]]
    page = rows("half", CS.Q26.replace(str(CS.Q26_ROWS), "1000"), "CsrOptionalExpandOp")
    assert [(r["b"], r["a"]) for r in page] == truth["Q26"][:1000]
    assert any(r["a"] is None for r in page)
    assert rows("loopy", CS.Q6, "CsrExpandIntoOp", "off") == [{"triangles": loopy_tri}]
    assert rows("loopy", CS.LOOPY_2CYCLE, "CsrExpandIntoOp", "off") == [
        {"c": truth["loopy_2cycle"]}]
    assert rows("loopy", CS.Q22, "CsrExpandIntoOp") == [{"t": truth["loopy_undirected"]}]
    for name, q, keys in (("fwd", CS.LOOPY_OPT_FWD, ("a", "b")),
                          ("bwd", CS.LOOPY_OPT_BWD, ("b", "a"))):
        got = Counter((r[keys[0]], r[keys[1]]) for r in rows("loopy", q, "CsrOptionalExpandOp"))
        assert got == truth[f"loopy_opt_{name}"]


def test_chip_close_truths_against_the_reference(snb_close):
    """The brute-force loopy truths themselves, against the reference
    engine on the same arrays (the scipy truths of Q22 and Q24 hold the
    port above, which the reference holds on the graphs before)."""
    CS, _, truth, _, _ = snb_close
    from tpu_cypher.io.ldbc import _graph_from_arrays as ref_graph_from_arrays
    from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

    ids, src, dst = CS.loopy_arrays(60, 400)
    session = R.CypherSession.tpu()
    ref = RefPropertyGraph(session, ref_graph_from_arrays(
        session, ids, {"id": ids}, {"id": R.api.types.CTInteger.nullable}, src, dst, False))
    RCFG.WCOJ_MODE.set("off")
    assert [dict(r) for r in ref.cypher(CS.LOOPY_2CYCLE).records.collect()] == [
        {"c": truth["loopy_2cycle"]}]
    assert [dict(r) for r in ref.cypher(CS.Q22).records.collect()] == [
        {"t": truth["loopy_undirected"]}]


@pytest.mark.parametrize("loopy", [False, True])
def test_undirected_close_pairs(monkeypatch, loopy):
    """On a loop-free graph the uniqueness pairs over an undirected close
    drop by proof in both orientations: the count is the fused close
    count, both probes, no FilterOp. With self-loops the FilterOps stay,
    as in the reference, and the chain materializes (two probe halves)."""
    calls = {}
    for name in ("into_close_queries", "into_probe"):
        _spy(monkeypatch, name, calls)
    create = _random_create(5, 20, 80) if loopy else _random_create_loop_free(5, 20, 80)
    result, _ = _three(_engines(create), UNDIRECTED, mode="auto")
    rel = result.plans.split("=== Relational plan ===")[1].strip().splitlines()
    assert rel[0].startswith("AggregateOp")
    if loopy:
        assert rel[1].strip().startswith("FilterOp")
        assert calls == {"into_probe": 2}
    else:
        assert rel[1].strip().startswith("CsrExpandIntoOp(")
        assert calls == {"into_close_queries": 1}
        assert PD.use_counts()["intersect"]["plain"] == 2


@pytest.mark.parametrize("ret", ["x.v AS x, y.v AS y", "id(r1) AS x, id(r2) AS y"])
def test_uniqueness_expand_into_materializing(ret):
    """``tests/test_rel_uniqueness.py``'s ExpandInto materializing path
    with an enforced close pair: its own rows, the two relationships' ids,
    and the endpoints' properties."""
    create = "CREATE (a:N {v: 1})-[:K]->(b:N {v: 2}), (a)-[:K]->(b)"
    q = f"MATCH (x)-[r1:K]->(y), (x)-[r2:K]->(y) RETURN {ret} ORDER BY x, y"
    result, got = _three(_engines(create), q)
    assert sum(got.values()) == 2
    if ret.startswith("x.v"):
        assert got == Counter({(("x", 1), ("y", 2)): 2})
    else:
        assert all(dict(row)["x"] != dict(row)["y"] for row in got)
    assert "CsrExpandIntoOp(" in result.plans and "uniq(r1<>r2)" in result.plans
