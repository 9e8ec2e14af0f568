"""The WCOJ triangle slice end to end: the port against the JAX package.

The triangle count, the triangle rows and the 4-clique count (``bench.py``
``TRIANGLE`` / ``CLIQUE4``) run through the reference's
``CypherSession.tpu()`` (JAX on the CPU, ``TPU_CYPHER_WCOJ=force``, so it
answers on its multiway-intersect tier too), its ``CypherSession.local()``
oracle and the port's ``CypherSession.cuda(device="cpu")``, on two graphs
carried across as numpy arrays:

* ``generate_snb(0.01)`` (seed 42): loop-free, so the planner proves every
  uniqueness pair redundant and the count tier answers. The oracle's
  4-clique runs the 6-way join cascade over ~8M result rows, past this
  suite's time, so there the 4-clique is held to a scipy count instead;
* a small seeded graph with self-loops and parallel edges: its uniqueness
  pairs cannot be proven redundant, so the port enforces them in the
  operator (``_wcoj_pair_keep``), and a brute-force Python count checks the
  triangles. Its 4-clique count then needs the multi-close materialize,
  whose pairs the operator enforces on the rows it decodes.

Rows must be bag-identical (exact: integers), the port's plan must hold
``MultiwayIntersectOp`` and its WCOJ tier counter must show the tier that
answered; ``expand_rows`` and ``intersect`` run on their CPU (``plain``)
tier with no fallback. A shape the planner hook declines must be
bag-identical to the reference with the same setting: ``off`` and an
undirected close run the binary plan, ``CsrExpandIntoOp`` (its probe on
``intersect``), and an empty graph the classic ``JoinOp`` plan. A
multi-close materialize (rows read from a 4-clique, the loopy 4-clique
count, ``bench.py`` ``CLIQUE4_MAT``) answers through the run-compressed
form under every ``TPU_CYPHER_FACTORIZE`` setting, held to scipy or a
brute-force count.
"""

from collections import Counter

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu.graph_index import GraphIndex as RefGraphIndex
from tpu_cypher.io.ldbc import _graph_from_arrays as ref_graph_from_arrays
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph
from tpu_cypher.utils import config as RCFG

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import interop
from tpu_cypher_torch.api import types as PT
from tpu_cypher_torch.backend.cuda import wcoj as W
from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)

SCALE = 0.01
MATCH_TRI = "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
TRIANGLE = MATCH_TRI + "RETURN count(*) AS triangles"  # bench.py TRIANGLE
TRIANGLE_ROWS = MATCH_TRI + "RETURN a.id AS a, b.id AS b, c.id AS c"
CLIQUE4 = (  # bench.py CLIQUE4
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a), "
    "(a)-[:KNOWS]->(d:Person), (b)-[:KNOWS]->(d), (c)-[:KNOWS]->(d) "
    "RETURN count(*) AS cliques"
)
QUERIES = {"triangle": TRIANGLE, "rows": TRIANGLE_ROWS, "clique4": CLIQUE4}
# rows read from a 4-clique, grouped: the 8.2M flat rows of the SNB graph
# would spend this suite's time decoding Python rows in both engines
CLIQUE4_ROWS = CLIQUE4.replace(
    "RETURN count(*) AS cliques", "RETURN a.id AS a, d.id AS d, count(*) AS n"
)
# bench.py CLIQUE4_MAT
CLIQUE4_MAT = CLIQUE4.replace("RETURN count(*) AS cliques", "RETURN count(DISTINCT d.id) AS hubs")


@pytest.fixture(autouse=True)
def _wcoj_force():
    """Both engines route every cyclic shape to WCOJ; every test leaves
    the routing knobs as it found them."""
    RCFG.WCOJ_MODE.set("force")
    PCFG.WCOJ_MODE.set("force")
    PD.reset()
    yield
    for cfg in (RCFG, PCFG):
        cfg.WCOJ_MODE.reset()
        cfg.WCOJ_MIN_ROWS.reset()
        cfg.FACTORIZE.reset()
    PD.reset()


def _loopy_arrays(seed=7, n=30, e=150):
    """Node ids and KNOWS endpoints with self-loops and parallel edges."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64) * 7 + 1
    src, dst = ids[rng.integers(0, n, e)], ids[rng.integers(0, n, e)]
    assert (src == dst).any()
    return ids, src, dst


def _snb_arrays():
    g = ref_generate_snb(SCALE, R.CypherSession.local())
    node = [et for et in g.scans if et.is_node][0].table
    rel = [et for et in g.scans if not et.is_node][0].table
    return (
        np.asarray(node.column_values("id"), np.int64),
        np.asarray(rel.column_values("source"), np.int64),
        np.asarray(rel.column_values("target"), np.int64),
    )


def _engines(ids, src, dst):
    """(reference tpu, reference local, port) graphs on the same arrays."""
    cols = {"id": ids}
    props = {"id": R.api.types.CTInteger.nullable}
    out = []
    for session in (R.CypherSession.tpu(), R.CypherSession.local()):
        g = ref_graph_from_arrays(session, ids, dict(cols), props, src, dst, False)
        out.append(RefPropertyGraph(session, g))
    port = CypherSession.cuda(device="cpu")
    out.append(interop.graph_from_arrays(
        port, ids, {}, {"id": PT.CTInteger.nullable}, src, dst
    ))
    return tuple(out) + ((ids, src, dst),)


@pytest.fixture(scope="module")
def snb():
    return _engines(*_snb_arrays())


@pytest.fixture(scope="module")
def loopy():
    return _engines(*_loopy_arrays())


def _bag(records):
    return Counter(tuple(sorted(dict(r).items())) for r in records.collect())


def _truth(ids, src, dst):
    """numpy/scipy ground truth, with multiplicity: the triangle row bag
    and the 4-clique count. On a loop-free graph distinct endpoints force
    distinct relationships, so plain adjacency products count the
    relationship-isomorphic matches."""
    assert not (src == dst).any()
    n = len(ids)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    A = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
    A.sum_duplicates()
    AT = A.T.tocsr()
    pa, pb = A.nonzero()
    # per (a, b) edge pair, candidates c with b->c and c->a
    M = A[pb].multiply(AT[pa]).tocoo()
    w = M.data * np.asarray(A[pa[M.row], pb[M.row]]).ravel()
    ta, tb, tc = pa[M.row], pb[M.row], M.col
    rows = Counter()
    for a, b, c, k in zip(ids[ta], ids[tb], ids[tc], w):
        rows[(("a", int(a)), ("b", int(b)), ("c", int(c)))] += int(k)
    closes = np.asarray(A[ta].multiply(A[tb]).multiply(A[tc]).sum(axis=1)).ravel()
    return rows, int((w * closes).sum())


def _clique_truth(ids, src, dst):
    """scipy truth of the 4-clique's (a, d) rows with multiplicity, and its
    distinct d (``CLIQUE4_MAT``): per triangle row (a, b, c) of weight w,
    each d with a->d, b->d and c->d."""
    n = len(ids)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    A = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
    A.sum_duplicates()
    pa, pb = A.nonzero()
    M = A[pb].multiply(A.T.tocsr()[pa]).tocoo()
    w = M.data * np.asarray(A[pa[M.row], pb[M.row]]).ravel()
    ta, tb, tc = pa[M.row], pb[M.row], M.col
    D = A[ta].multiply(A[tb]).multiply(A[tc]).tocoo()
    key = ta[D.row].astype(np.int64) * n + D.col
    uniq, inv = np.unique(key, return_inverse=True)
    mult = np.bincount(inv, weights=w[D.row] * D.data).astype(np.int64)
    rows = Counter({
        (("a", int(ids[k // n])), ("d", int(ids[k % n])), ("n", int(m))): 1
        for k, m in zip(uniq, mult)
    })
    return rows, len(np.unique(D.col))


def _loopy_brute_force(ids, src, dst):
    """Triangle row bag by enumerating relationship triples with pairwise
    distinct relationships (openCypher isomorphism)."""
    out = {}
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        out.setdefault(s, []).append((i, d))
    tri = Counter()
    for r0, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        for r1, c in out.get(b, ()):
            for r2, a2 in out.get(c, ()):
                if a2 == a and len({r0, r1, r2}) == 3:
                    tri[(("a", a), ("b", b), ("c", c))] += 1
    return tri


def _loopy_clique_brute_force(ids, src, dst):
    """The 4-clique count by enumerating the triangle's relationships and
    then d's three, all six pairwise distinct."""
    out = {}
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        out.setdefault(s, []).append((i, d))
    total = 0
    for r0, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        for r1, c in out.get(b, ()):
            for r2, a2 in out.get(c, ()):
                if a2 != a or len({r0, r1, r2}) < 3:
                    continue
                for r3, d in out.get(a, ()):
                    for r4, d4 in out.get(b, ()):
                        if d4 != d:
                            continue
                        for r5, d5 in out.get(c, ()):
                            if d5 == d and len({r0, r1, r2, r3, r4, r5}) == 6:
                                total += 1
    return total


def _check_port_run(result, tiers_before, tier):
    assert "MultiwayIntersectOp" in result.plans
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    assert dict(W.WCOJ_TIER_COUNTS)[tier] > tiers_before[tier]
    counts = PD.use_counts()
    for name in ("expand_rows", "intersect"):
        assert counts[name]["plain"] > 0, (name, counts)
    for name, c in counts.items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)


# the loopy graph's 4-clique keeps unprovable uniqueness pairs, so it needs
# the multi-close materialize: a declined shape (see the end of the file)
CASES = [("snb", q) for q in sorted(QUERIES)] + [
    ("loopy", "triangle"), ("loopy", "rows"),
]


@pytest.mark.parametrize("graph,qname", CASES)
def test_wcoj_bag_identical(request, graph, qname):
    ref, local, port, arrays = request.getfixturevalue(graph)
    query = QUERIES[qname]
    before = dict(W.WCOJ_TIER_COUNTS)
    result = port.cypher(query)
    got = _bag(result.records)
    assert got == _bag(ref.cypher(query).records), qname
    if graph == "loopy":
        tri, cliques = _loopy_brute_force(*arrays), None
    else:
        tri, cliques = _truth(*arrays)
    if qname != "clique4":
        # the oracle's 6-way join cascade for the SNB 4-clique is past this
        # suite's time; scipy's count holds it instead
        assert got == _bag(local.cypher(query).records), qname
    want = {
        "triangle": Counter({(("triangles", sum(tri.values())),): 1}),
        "rows": tri,
        "clique4": Counter({(("cliques", cliques),): 1}),
    }[qname]
    assert got == want and sum(tri.values()) > 0, qname
    # loop-free: proven pairs, pure counts on the count tier; loopy: the
    # pairs are enforced in the op, which takes the materializing tier
    tier = "count" if graph == "snb" and qname != "rows" else "materialize"
    _check_port_run(result, before, tier)


def test_loopy_pairs_enforced_in_op(loopy):
    """The loopy graph's uniqueness pairs survive the redundancy proof and
    ride the op's ``enforced_pairs`` instead of a FilterOp."""
    _, _, port, _ = loopy
    plans = port.cypher(TRIANGLE).plans
    assert "uniq(__r0<>__r1),(__r0<>__r2),(__r1<>__r2)" in plans
    # no FilterOp between the aggregate and the op (the classic child
    # keeps the predicates as real FilterOps, for its header)
    rel = plans.split("=== Relational plan ===")[1].strip().splitlines()
    assert rel[0].startswith("AggregateOp")
    assert rel[1].strip().startswith("MultiwayIntersectOp(")


def test_auto_mode_routes_the_snb_triangle(snb):
    """``auto`` routes the SNB triangle count to WCOJ without ``force``."""
    _, _, port, arrays = snb
    PCFG.WCOJ_MODE.set("auto")
    result = port.cypher(TRIANGLE)
    rows, _ = _truth(*arrays)
    assert list(result.records.collect())[0]["triangles"] == sum(rows.values())
    assert "MultiwayIntersectOp" in result.plans


def test_edge_keys_match_reference(snb):
    """Key position i is CSR position i, in both orientations, and the
    keys equal the reference's (whose keys may carry trailing ``1 << 62``
    pad lanes)."""
    ref, _, port, _ = snb
    ctx = port.session._runtime_context({})
    rctx = ref.session._runtime_context({})
    gi = GraphIndex.of(port._graph)
    rgi = RefGraphIndex.of(ref._graph)
    gi.node_ids(ctx)
    rgi.node_ids(rctx)
    n = gi.num_nodes
    for rev in (False, True):
        rp, ci, _ = gi.csr(("KNOWS",), rev, ctx)
        keys = gi.edge_keys(("KNOWS",), ctx, reverse=rev).numpy()
        anchor = np.repeat(np.arange(n), np.diff(rp.numpy()))
        assert np.array_equal(keys, anchor * n + ci.numpy().astype(np.int64))
        assert (keys[1:] >= keys[:-1]).all()
        rkeys = np.asarray(rgi.edge_keys(("KNOWS",), rctx, reverse=rev))
        assert np.array_equal(rkeys[: len(keys)], keys)
        assert (rkeys[len(keys):] == 1 << 62).all()


def test_device_fault_in_wcoj_reaches_caller_typed(snb):
    from tpu_cypher_torch import errors as ERR
    from tpu_cypher_torch.runtime import faults

    _, _, port, _ = snb
    result = port.cypher(TRIANGLE)
    with faults.scoped_spec("oom@expand:*"):
        with pytest.raises(ERR.DeviceOOM):
            result.records
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and not log[0]["ok"], log


# ---------------------------------------------------------------------------
# declined shapes: the binary plan (CsrExpandIntoOp) or the classic JoinOp
# plan answers, or the typed error names the ROADMAP.md item that ports
# the shape
# ---------------------------------------------------------------------------


def _check_binary_answer(result, ref_result, want=None):
    """The declined shape ran the binary plan, ``CsrExpandIntoOp``, on the
    device rung, with ``expand_rows`` and ``intersect`` on their CPU tiers
    and no join, bag-identical to the reference."""
    assert "MultiwayIntersectOp" not in result.plans
    assert "CsrExpandIntoOp" in result.plans
    got = _bag(result.records)
    assert got == _bag(ref_result.records)
    if want is not None:
        assert got == want
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    counts = PD.use_counts()
    for name in ("expand_rows", "intersect"):
        assert counts[name]["plain"] > 0, counts
    assert counts["join_probe"]["plain"] == 0, counts
    for name, c in counts.items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
    return got


def _check_classic_answer(result, ref_result, want=None):
    """The declined shape ran the classic plan on the device rung, with
    ``join_probe`` on its CPU tier, bag-identical to the reference."""
    assert "MultiwayIntersectOp" not in result.plans
    assert "JoinOp" in result.plans
    got = _bag(result.records)
    assert got == _bag(ref_result.records)
    if want is not None:
        assert got == want
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    counts = PD.use_counts()
    assert counts["join_probe"]["plain"] > 0, counts
    for name, c in counts.items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
    return got


def test_declined_off_mode(snb):
    ref, _, port, arrays = snb
    PCFG.WCOJ_MODE.set("off")
    RCFG.WCOJ_MODE.set("off")
    rows, _ = _truth(*arrays)
    want = Counter({(("triangles", sum(rows.values())),): 1})
    _check_binary_answer(port.cypher(TRIANGLE), ref.cypher(TRIANGLE), want)


@pytest.mark.parametrize("min_rows,plan", [
    (1 << 40, "CsrExpandIntoOp"), (1, "MultiwayIntersectOp"),
])
def test_auto_routes_by_blowup_estimate(loopy, min_rows, plan):
    """``auto`` routes as the reference does: the loopy graph's binary
    blowup (its edges x its max degree) under ``TPU_CYPHER_WCOJ_MIN_ROWS``
    keeps the binary plan, ``CsrExpandIntoOp``'s fused close count; over
    it the triangle goes to WCOJ. Either plan answers as the reference
    does."""
    ref, _, port, arrays = loopy
    for cfg in (PCFG, RCFG):
        cfg.WCOJ_MODE.set("auto")
        cfg.WCOJ_MIN_ROWS.set(min_rows)
    result = port.cypher(TRIANGLE)
    assert plan in result.plans
    if plan == "CsrExpandIntoOp":
        assert "MultiwayIntersectOp" not in result.plans
    want = Counter({(("triangles", sum(_loopy_brute_force(*arrays).values())),): 1})
    assert _bag(result.records) == _bag(ref.cypher(TRIANGLE).records) == want


def test_declined_empty_node_space():
    empty = np.zeros(0, np.int64)
    ref, local, port, _ = _engines(empty, empty, empty)
    got = _check_classic_answer(port.cypher(TRIANGLE), ref.cypher(TRIANGLE))
    assert got == _bag(local.cypher(TRIANGLE).records)
    assert got == Counter({(("triangles", 0),): 1})


def test_declined_undirected_close(snb):
    """The binary plan probes the undirected close in both orientations
    (``CsrExpandIntoOp``'s fused close count)."""
    ref, _, port, _ = snb
    query = (
        "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]-(a) "
        "RETURN count(*) AS t"
    )
    _check_binary_answer(port.cypher(query), ref.cypher(query))


@pytest.mark.parametrize("graph,query", [
    # rows read from a 4-clique
    ("snb", CLIQUE4_ROWS),
    # a 4-clique count whose uniqueness pairs cannot be proven redundant
    ("loopy", CLIQUE4),
])
def test_declined_multi_close_materialize(request, graph, query):
    """Both need the multi-close materialize: under the default ``auto``
    with no memory budget, the runs decode at the output extent (tier
    ``materialize``), and the loopy count's pairs are enforced on the
    decoded rows. Bag-identical to the reference and to scipy or the
    brute force."""
    ref, _, port, arrays = request.getfixturevalue(graph)
    before = dict(W.WCOJ_TIER_COUNTS)
    result = port.cypher(query)
    got = _bag(result.records)
    assert got == _bag(ref.cypher(query).records)
    if graph == "snb":
        want = _clique_truth(*arrays)[0]
    else:
        want = Counter({(("cliques", _loopy_clique_brute_force(*arrays)),): 1})
    assert got == want and sum(want.values()) > 0
    _check_port_run(result, before, "materialize")


@pytest.mark.parametrize("mode,tier", [("force", "factorized"), ("off", "materialize")])
def test_clique4_mat(snb, mode, tier):
    """``bench.py`` ``CLIQUE4_MAT``: under ``force`` the 4-clique stays a
    ``FactorizedTable`` until ``count(DISTINCT d.id)`` reads its prefix;
    under ``off`` it decodes at the output extent. Both equal the
    reference's answer under ``force`` and scipy's."""
    ref, _, port, arrays = snb
    RCFG.FACTORIZE.set("force")
    PCFG.FACTORIZE.set(mode)
    before = dict(W.WCOJ_TIER_COUNTS)
    result = port.cypher(CLIQUE4_MAT)
    got = _bag(result.records)
    assert got == _bag(ref.cypher(CLIQUE4_MAT).records)
    assert got == Counter({(("hubs", _clique_truth(*arrays)[1]),): 1})
    _check_port_run(result, before, tier)


@pytest.mark.parametrize("graph", ["snb", "loopy"])
def test_triangle_rows_on_the_bucket_lattice(request, graph):
    """With the pow2 bucket lattice on, the input expand carries pad
    lanes, and the WCOJ materialize still sizes its own lanes exactly;
    the rows stay the same bag."""
    from tpu_cypher_torch.backend.cuda import bucketing

    _, _, port, arrays = request.getfixturevalue(graph)
    want = _loopy_brute_force(*arrays) if graph == "loopy" else _truth(*arrays)[0]
    bucketing.MODE.set("pow2")
    try:
        got = _bag(port.cypher(TRIANGLE_ROWS).records)
    finally:
        bucketing.MODE.reset()
    assert got == want
