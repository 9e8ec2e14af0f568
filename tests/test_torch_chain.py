"""The chain walk: the port against the JAX package, on the CPU.

* The walk's ``jit_ops`` functions (the var-length hop, emission and
  zero-length frontier, the relationship-id bridge, the DISTINCT-endpoints
  hops and final counts, the relationship-unique hops and final counts)
  against the reference's on the same seeded numpy CSR, which has
  self-loops and parallel edges: an empty frontier, an all-dead frontier,
  a live one, with and without a far-label mask, at the exact lane count
  and at a bucketed one (pad lanes past ``nvalid``). Each hop's lanes are
  merged as the walk merges them (``expand_op._walk_lanes``, on the
  ``expand_rows`` gate); per-lane outputs are compared exactly on the live
  lanes, liveness and counts on every lane.
* ``GraphIndex.csr_undirected`` and ``rel_row_index`` against the
  reference's live prefixes.
* The var-length queries of ``tests/test_var_expand_fused.py`` and the
  uniqueness cases of ``tests/test_rel_uniqueness.py`` across the
  reference's ``CypherSession.tpu()``, its ``local()`` oracle and the
  port, bag-identical, with the plan operator that must answer them and
  ``expand_rows`` on its CPU (``plain``) tier; the two ``QUERIES`` that
  return element values ordered by ``id()`` run beside their forms that
  return a property. Left out: the ``VARLEN_CASES`` with two var-lengths
  of one MATCH or a fixed rel before a var-length; the one that reads a
  relationship list (``min(size(rs))``) runs here, its list emitted by
  ``CsrVarExpandOp`` from the walk.
* ``bench.py``'s ``TWO_HOP_DISTINCT`` and ``VAR_LENGTH`` and the other
  walk queries of ``chip_smoke.py`` at ``generate_snb(0.02)``, and the
  walk truths ``chip_smoke.py`` holds the card to, against the engines
  and a brute-force enumeration.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import tpu_cypher as R
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.backend.tpu.graph_index import GraphIndex as RefGraphIndex
from tpu_cypher.io.ldbc import _graph_from_arrays as ref_graph_from_arrays
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as ERR
from tpu_cypher_torch import interop
from tpu_cypher_torch.api import types as PT
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import expand_op as PX
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb
from tpu_cypher_torch.relational.session import PropertyGraph
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


def _same(want, got, what=""):
    """Exact equality of a reference output and a port tensor."""
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.shape == g.shape, (what, w.shape, g.shape)
    assert np.array_equal(w.astype(np.int64), g.astype(np.int64)), (what, w, g)


def _same_tree(want, got, what=""):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(want) == len(got), what
        for i, (w, g) in enumerate(zip(want, got)):
            _same_tree(w, g, f"{what}[{i}]")
    else:
        _same(want, got, what)


# ---------------------------------------------------------------------------
# the walk's jit_ops functions against the reference's
# ---------------------------------------------------------------------------

N_NODES = 40


def _csr(seed=3, n=N_NODES, e=160):
    """A seeded CSR with self-loops and parallel edges: (rp int32, ci
    int32, eo int64) with eo the canonical row of each edge."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    s = np.concatenate([s, [5, 5, 9, 9], s[:6]])  # loops, parallels
    d = np.concatenate([d, [5, 5, 9, 2], d[:6]])
    order = np.lexsort((d, s))
    rp = np.searchsorted(s[order], np.arange(n + 1)).astype(np.int32)
    return rp, d[order].astype(np.int32), order.astype(np.int64)


# (frontier, label mask, lanes): the frontier kinds of the walk and the
# two lane regimes (exact; bucketed with dead pad lanes past nvalid). An
# empty frontier has no bucketed form: the walk returns before the hop.
CASES = [
    ("empty", False, "exact"),
    ("empty", True, "exact"),
    ("dead", True, "bucketed"),
    ("live", False, "exact"),
    ("live", True, "exact"),
    ("live", False, "bucketed"),
    ("live", True, "bucketed"),
]


def _inputs(kind, with_mask, lanes, seed=11):
    """One walk step's inputs as numpy: rp, ci, eo, pos, deg, akey, mask,
    two carried edge arrays (with collisions), static size, nvalid."""
    rng = np.random.default_rng(seed)
    rp, ci, eo = _csr()
    f = {"empty": 0, "dead": 25, "live": 25}[kind]
    pos = rng.integers(0, N_NODES, f).astype(np.int64)
    pos[:3] = [5, 9, 9][:f]  # the loop and parallel-edge rows
    present = rng.random(f) < 0.85 if kind == "live" else np.zeros(f, bool)
    deg = np.where(present, rp[pos + 1] - rp[pos], 0).astype(np.int64)
    total = int(deg.sum())
    akey = rng.integers(0, N_NODES, f).astype(np.int64)
    mask = rng.random(N_NODES) < 0.6 if with_mask else None
    # carried edges drawn from the edges themselves, so the masks bite
    prevs = tuple(eo[rng.integers(0, len(eo), f)] for _ in range(2))
    size = total if lanes == "exact" else max(32, 1 << max(total - 1, 0).bit_length())
    nvalid = None if lanes == "exact" else total
    return rp, ci, eo, pos, deg, akey, mask, prevs, size, nvalid


def _both(arrays):
    """(reference jnp arrays, port tensors) of a tuple of numpy arrays
    (None and nested tuples kept)."""
    def ref(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(ref(x) for x in a)
        return jnp.asarray(a)

    def port(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(port(x) for x in a)
        return torch.from_numpy(np.ascontiguousarray(a))

    return tuple(ref(a) for a in arrays), tuple(port(a) for a in arrays)


def _same_lanes(want, got, nvalid, what=""):
    """A hop's per-lane outputs: equal on the live lanes (the first
    ``nvalid``, every lane at the exact count), and the liveness output
    (the last) on every lane, pad lanes dead in both."""
    def cut(t):
        if isinstance(t, (tuple, list)):
            return tuple(cut(x) for x in t)
        return t if nvalid is None else t[:nvalid]

    _same(want[-1], got[-1], (what, "liveness"))
    _same_tree(cut(want), cut(got), what)


def _call(fn_name, kind, with_mask, lanes):
    rp, ci, eo, pos, deg, akey, mask, prevs, size, nvalid = _inputs(kind, with_mask, lanes)
    (r_rp, r_ci, r_eo, r_pos, r_deg, r_akey, r_mask, r_prevs), (
        p_rp, p_ci, p_eo, p_pos, p_deg, p_akey, p_mask, p_prevs
    ) = _both((rp, ci, eo, pos, deg, akey, mask, prevs))
    r_nv = None if nvalid is None else jnp.asarray(nvalid, jnp.int64)
    kw = dict(total=size)

    def merged(with_orig):
        # the hop's merge as the walk makes it, on the expand_rows gate
        return PX._walk_lanes(p_rp, p_ci, p_eo, p_pos, p_deg, size, nvalid, with_orig)

    if fn_name == "varlen_hop":
        for row0 in (None, np.arange(len(pos), dtype=np.int64)[::-1].copy()):
            r_row0 = None if row0 is None else jnp.asarray(row0)
            p_row0 = None if row0 is None else torch.from_numpy(row0)
            want = RJ.varlen_hop(r_rp, r_ci, r_eo, r_pos, r_deg, r_row0, r_prevs,
                                 nvalid=r_nv, **kw)
            got = PJ.varlen_hop(merged(True), p_row0, p_prevs)
            _same_lanes(want, got, nvalid, fn_name)
        return got
    if fn_name == "distinct_hop_materialize":
        want = RJ.distinct_hop_materialize(r_rp, r_ci, r_pos, r_deg, r_akey, r_mask,
                                           nvalid=r_nv, **kw)
        got = PJ.distinct_hop_materialize(merged(False), p_akey, p_mask)
        _same_lanes(want, got, nvalid, fn_name)
    elif fn_name == "distinct_pairs_count_final":
        for use_a, use_c in ((True, True), (True, False), (False, True)):
            extra = dict(use_a=use_a, use_c=use_c, num_nodes=N_NODES)
            want = RJ.distinct_pairs_count_final(r_rp, r_ci, r_pos, r_deg, r_akey, r_mask,
                                                 nvalid=r_nv, **kw, **extra)
            got = PJ.distinct_pairs_count_final(merged(False), p_akey, p_mask, **extra)
            _same(want, got, (fn_name, use_a, use_c))
    elif fn_name == "unique_hop_materialize":
        for midx in ((), (0,), (0, 1)):
            want = RJ.unique_hop_materialize(r_rp, r_ci, r_eo, r_pos, r_deg, r_akey,
                                             r_mask, r_prevs, mask_idx=midx,
                                             nvalid=r_nv, **kw)
            got = PJ.unique_hop_materialize(merged(True), p_akey, p_mask, p_prevs,
                                            mask_idx=midx)
            _same_lanes(want, got, nvalid, (fn_name, midx))
    elif fn_name == "chain_count_final_unique":
        for midx in ((), (1,), (0, 1)):
            want = RJ.chain_count_final_unique(r_rp, r_ci, r_eo, r_pos, r_deg, r_mask,
                                               r_prevs, mask_idx=midx, nvalid=r_nv, **kw)
            got = PJ.chain_count_final_unique(merged(bool(midx)), p_mask, p_prevs,
                                              mask_idx=midx)
            _same(want, got, (fn_name, midx))
    elif fn_name == "distinct_pairs_count_final_unique":
        for use_a, use_c, midx in ((True, True, (0,)), (True, False, (0, 1)),
                                   (False, True, ())):
            extra = dict(use_a=use_a, use_c=use_c, num_nodes=N_NODES, mask_idx=midx)
            want = RJ.distinct_pairs_count_final_unique(
                r_rp, r_ci, r_eo, r_pos, r_deg, r_akey, r_mask, r_prevs,
                nvalid=r_nv, **kw, **extra)
            got = PJ.distinct_pairs_count_final_unique(
                merged(bool(midx)), p_akey, p_mask, p_prevs, **extra)
            _same(want, got, (fn_name, use_a, use_c, midx))
    else:
        raise AssertionError(fn_name)
    return got


WALK_FNS = [
    "varlen_hop", "distinct_hop_materialize", "distinct_pairs_count_final",
    "unique_hop_materialize", "chain_count_final_unique",
    "distinct_pairs_count_final_unique",
]


@pytest.mark.parametrize("fn_name", WALK_FNS)
@pytest.mark.parametrize("kind,with_mask,lanes", CASES)
def test_walk_fn_matches_reference(fn_name, kind, with_mask, lanes):
    _call(fn_name, kind, with_mask, lanes)
    # every merge went through the expand_rows gate (its CPU tier)
    assert PD.use_counts()["expand_rows"]["plain"] > 0


@pytest.mark.parametrize("kind,with_mask,lanes", CASES)
def test_varlen_emit_and_zero_match_reference(kind, with_mask, lanes):
    rp, ci, eo, pos, deg, akey, mask, prevs, size, nvalid = _inputs(kind, with_mask, lanes)
    rng = np.random.default_rng(5)
    row_map = np.where(rng.random(N_NODES) < 0.7, np.arange(N_NODES), -1).astype(np.int64)
    present = deg > 0
    (r_pos, r_pres, r_map), (p_pos, p_pres, p_map) = _both((pos, present, row_map))
    _same_tree(RJ.varlen_zero(r_pos, r_pres, r_map), PJ.varlen_zero(p_pos, p_pres, p_map))
    _, nbr, _, _, iso = _call("varlen_hop", kind, with_mask, lanes)
    _same_tree(RJ.varlen_emit(jnp.asarray(nbr.numpy()), jnp.asarray(iso.numpy()), r_map),
               PJ.varlen_emit(nbr, iso, p_map))
    parts = ((np.arange(3), np.arange(3) * 2), (np.arange(2) + 7, np.arange(2) - 1))
    r_parts, p_parts = _both(parts)
    _same_tree(RJ.concat_rows(r_parts), PJ.concat_rows(p_parts))


@pytest.mark.parametrize("valid", [False, True])
def test_rel_rows_of_ids_matches_reference(valid):
    rng = np.random.default_rng(2)
    ids = np.sort(rng.choice(1000, 60, replace=False)).astype(np.int64)
    perm = rng.permutation(60).astype(np.int64)
    q = np.concatenate([ids[rng.integers(0, 60, 30)], rng.integers(0, 1000, 30)])
    v = rng.random(60) < 0.8 if valid else None
    (r_ids, r_perm, r_q, r_v), (p_ids, p_perm, p_q, p_v) = _both((ids, perm, q, v))
    _same(RJ.rel_rows_of_ids(r_ids, r_perm, r_q, r_v), PJ.rel_rows_of_ids(p_ids, p_perm, p_q, p_v))
    empty = np.zeros(0, np.int64)
    (r_e, r_q2), (p_e, p_q2) = _both((empty, q))
    _same(RJ.rel_rows_of_ids(r_e, r_e, r_q2, None), PJ.rel_rows_of_ids(p_e, p_e, p_q2, None))
    assert PJ._KEY_SENTINEL == RJ._KEY_SENTINEL


# ---------------------------------------------------------------------------
# the graph index
# ---------------------------------------------------------------------------


def _loopy_arrays(seed=7, n=30, e=150):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64) * 7 + 1
    src, dst = ids[rng.integers(0, n, e)], ids[rng.integers(0, n, e)]
    assert (src == dst).any()
    return ids, src, dst


def _array_engines(ids, src, dst):
    """(reference tpu, reference local, port) graphs on the same arrays."""
    out = []
    for session in (R.CypherSession.tpu(), R.CypherSession.local()):
        g = ref_graph_from_arrays(session, ids, {"id": ids},
                                  {"id": R.api.types.CTInteger.nullable}, src, dst, False)
        out.append(RefPropertyGraph(session, g))
    port = CypherSession.cuda(device="cpu")
    out.append(interop.graph_from_arrays(port, ids, {}, {"id": PT.CTInteger.nullable}, src, dst))
    return tuple(out)


@pytest.fixture(scope="module")
def loopy():
    return _array_engines(*_loopy_arrays())


def test_graph_index_walk_arrays_match_reference(loopy):
    ref, _, port = loopy
    ctx = port.session._runtime_context({})
    rctx = ref.session._runtime_context({})
    gi, rgi = GraphIndex.of(port._graph), RefGraphIndex.of(ref._graph)
    gi.node_ids(ctx)
    rgi.node_ids(rctx)
    rp, ci, eo = gi.csr_undirected(("KNOWS",), ctx)
    rrp, rci, reo = (np.asarray(a) for a in rgi.csr_undirected(("KNOWS",), rctx))
    live = int(rp[-1])
    _same(rrp, rp)
    _same(rci[:live], ci)
    _same(reo[:live], eo)
    _, src, dst = _loopy_arrays()
    assert live == 2 * 150 - int((src == dst).sum())
    ids, perm = gi.rel_row_index(("KNOWS",), ctx)
    rids, rperm = (np.asarray(a) for a in rgi.rel_row_index(("KNOWS",), rctx))
    _same(rids[:150], ids)
    _same(rperm[:150], perm)


# ---------------------------------------------------------------------------
# queries across the three engines
# ---------------------------------------------------------------------------


def _value(v):
    """An element as its kind, id and printed form: the two packages'
    element classes never compare equal to each other."""
    if type(v).__name__ in ("Node", "Relationship"):
        return (type(v).__name__, v.id, repr(v))
    return v


def _bag(result):
    return Counter(tuple(sorted((c, _value(v)) for c, v in dict(r).items()))
                   for r in result.records.collect())


def _three(port, ref, local, query, params=None):
    """Bag-identical rows across the engines (``local`` None: the port and
    the reference alone); returns the port's result and rows."""
    PD.reset()
    result = port.cypher(query, params)
    got = _bag(result)
    assert got == _bag(ref.cypher(query, params)), query
    if local is not None:
        assert got == _bag(local.cypher(query, params)), query
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    for name, c in PD.use_counts().items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
    return result, got


def _fused_at_top(plans, op):
    """The relational plan reaches ``op`` from its root through no
    FilterOp (the classic child below keeps its FilterOps, for its
    header)."""
    rel = plans.split("=== Relational plan ===")[1].strip().splitlines()
    for line in rel:
        name = line.strip()
        if name.startswith(op + "("):
            return True
        if name.startswith("FilterOp"):
            return False
    return False


def _create(seed, n, e):
    """tests/test_var_expand_fused.py's graph, each node with a property."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e)
    dst = r.integers(0, n, e)
    parts = [f"(n{i}:{'N' if i % 2 else 'M'} {{v: {i}}})" for i in range(n)]
    parts += [f"(n{s})-[:K]->(n{d})" for s, d in zip(src, dst)]
    parts += [f"(n{i})-[:K]->(n{i})" for i in range(0, n, 7)]  # self-loops
    return "CREATE " + ", ".join(parts)


VAR_QUERIES = [
    # undirected walks (the both-orientation CSR)
    "MATCH (a)-[:K*1..3]-(b) RETURN count(*) AS c",
    "MATCH (a:N)-[:K*1..2]-(b:M) RETURN count(*) AS c",
    "MATCH (a)-[:K*2..3]-(b) RETURN a.v AS a, b.v AS b",
    "MATCH (a)-[:K*2..3]-(b) RETURN a, b ORDER BY id(a), id(b) LIMIT 5",
    # zero-length lower bounds (the identity frontier)
    "MATCH (a)-[:K*0..2]->(b) RETURN count(*) AS c",
    "MATCH (a:N)-[:K*0..1]-(b:N) RETURN count(*) AS c",
    "MATCH (a)-[:K*0..0]->(b:M) RETURN count(*) AS c",
    # target-labelled plans
    "MATCH (a)-[:K*1..2]->(b:M) RETURN count(*) AS c",
    "MATCH (a)-[:K*1..2]->(b:M) RETURN a.v AS a, b.v AS b",
    "MATCH (a)-[:K*1..2]->(b:M) RETURN a, b ORDER BY id(a), id(b) LIMIT 4",
    "MATCH (a)-[:K*0..2]->(b:M) RETURN count(*) AS c",
]


@pytest.fixture(scope="module", params=[(1, 14, 30), (2, 20, 60), (3, 9, 18)])
def var_graphs(request):
    create = _create(*request.param)
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
    )


@pytest.mark.parametrize("query", VAR_QUERIES)
def test_var_expand_across_engines(var_graphs, query):
    result, got = _three(*var_graphs, query)
    assert "CsrVarExpandOp" in result.plans
    # every hop of the walk merges its lanes on the expand_rows gate
    assert (PD.use_counts()["expand_rows"]["plain"] > 0) == ("*0..0" not in query)


ONE_EDGE = "CREATE (x:N)-[:K]->(y:N)"
TWO_CYCLE = "CREATE (a:N)-[:K]->(b:N), (b)-[:K]->(a)"
FORK3 = "CREATE (x1:N)-[:K]->(y:N), (x2:N)-[:K]->(y), (x3:N)-[:K]->(y)"


def _creates(create):
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
    )


def test_undirected_rel_uniqueness_across_directions():
    """A single edge admits exactly two undirected 1-walks and no 2-walk."""
    engines = _creates(ONE_EDGE)
    for q, want in (
        ("MATCH (a)-[:K*1..1]-(b) RETURN count(*) AS c", 2),
        ("MATCH (a)-[:K*2..2]-(b) RETURN count(*) AS c", 0),
    ):
        _, got = _three(*engines, q)
        assert got == Counter({(("c", want),): 1})


@pytest.mark.parametrize("create,want", [
    (TWO_CYCLE, 4), (FORK3, 3),
    ("CREATE (a:N)-[:K]->(b:N)-[:K]->(c:N)-[:K]->(a), (a)-[:K]->(a)", 19),
])
def test_unbounded_var_expand(create, want):
    """``*`` resolves to the edge count; the walk stops at the empty
    frontier (tiny graphs only: the walk set grows with the trails)."""
    result, got = _three(*_creates(create),
                         "MATCH (a)-[:K*]->(b) RETURN count(*) AS c")
    assert got == Counter({(("c", want),): 1})
    assert "CsrVarExpandOp" in result.plans


# tests/test_rel_uniqueness.py's CASES and VARLEN_CASES the port answers:
# (create, query, expected count, the operator that must answer at the top
# of the plan, with no FilterOp above it)
UNIQ_CASES = [
    ("CREATE (a:N)-[:K]->(b:N)",
     "MATCH (x)-[r1:K]->(y)<-[r2:K]-(z) RETURN count(*) AS c", 0, "CsrExpandOp"),
    ("CREATE (a:N)-[:K]->(b:N)",
     "MATCH (x)<-[r1:K]-(y)-[r2:K]->(z) RETURN count(*) AS c", 0, "CsrExpandOp"),
    ("CREATE (a:N)-[:K]->(b:N)",
     "MATCH (x)-[r1:K]->(y), (x)-[r2:K]->(y) RETURN count(*) AS c", 0,
     "MultiwayIntersectOp"),
    ("CREATE (a:N)-[:K]->(b:N), (a)-[:K]->(b)",
     "MATCH (x)-[r1:K]->(y), (x)-[r2:K]->(y) RETURN count(*) AS c", 2,
     "MultiwayIntersectOp"),
    (FORK3, "MATCH (a)-[r1:K]->(b)<-[r2:K]-(c) RETURN count(*) AS c", 6, "CsrExpandOp"),
    (FORK3, "MATCH (a)-->(b)<--(c) RETURN count(*) AS c", 6, "CsrExpandOp"),
    ("CREATE (a:N)-[:K]->(b:N)-[:L]->(c:N), (a)-[:K]->(c), (b)-[:L]->(b)",
     "MATCH (x)-[r1:K]->(y)-[r2:L]->(z), (x)-[r3:K]->(z) RETURN count(*) AS c", 1,
     "MultiwayIntersectOp"),
    ("CREATE (a:N)-[:K]->(b:N), (b)-[:K]->(a)",
     "MATCH (x)-[:K]->(y)-[:K]->(z)-[:K]->(w)-[:K]->(x) RETURN count(*) AS c", 0,
     "MultiwayIntersectOp"),
    ("CREATE (a:N)-[:K]->(b:N)-[:K]->(c:N)-[:K]->(a), (a)-[:K]->(a)",
     "MATCH (x)-[:K]->(y)-[:K]->(z)-[:K]->(x) RETURN count(*) AS c", 3,
     "MultiwayIntersectOp"),
    ("CREATE (x:N)-[:K]->(x), (x)-[:K]->(x)",
     "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS c", 0,
     "MultiwayIntersectOp"),
    ("CREATE (x:N)-[:K]->(x), (x)-[:K]->(x), (x)-[:K]->(x)",
     "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS c", 6,
     "MultiwayIntersectOp"),
    (FORK3, "MATCH (a)-[r1:K]->(b)<-[r2:K]-(c) WITH DISTINCT a, c "
     "RETURN count(*) AS c", 6, "AggregateOp"),
    ("CREATE (a:N)-[:K]->(b:N)-[:K]->(c:N), (b)-[:K]->(b)",
     "MATCH (x)-[:K]->(y)-[:K]->(z) RETURN count(*) AS c", 3, "CsrExpandOp"),
    ("CREATE (u:N)-[:K]->(u)",
     "MATCH (a)-[r1:K]->(b) MATCH (b)-[r2:K]->(c) MATCH (a)-[r3:K]->(c) "
     "WHERE id(r3) <> id(r1) AND id(r3) <> id(r2) RETURN count(*) AS c", 0,
     "MultiwayIntersectOp"),
    ("CREATE (u:N)-[:K]->(u), (u)-[:K]->(u)",
     "MATCH (a)-[r1:K]->(b) MATCH (b)-[r2:K]->(c) MATCH (a)-[r3:K]->(c) "
     "WHERE id(r3) <> id(r1) AND id(r3) <> id(r2) RETURN count(*) AS c", 2,
     "MultiwayIntersectOp"),
    # VARLEN_CASES
    (ONE_EDGE, "MATCH (a)-[r:K]->(b), (c)-[rs:K*1..2]->(d) RETURN count(*) AS c", 0,
     "CsrVarExpandOp"),
    (TWO_CYCLE, "MATCH (x)-[r:K]->(y), (c)-[rs:K*1..2]->(d) RETURN count(*) AS c", 2,
     "CsrVarExpandOp"),
    (TWO_CYCLE, "MATCH (c)-[rs:K*1..2]->(d), (x)-[r:K]->(y) RETURN count(*) AS c", 2,
     "CsrVarExpandOp"),
    (ONE_EDGE, "MATCH (x)-[r:K]->(y), (c)-[rs:K*1..1]-(d) RETURN count(*) AS c", 0,
     "CsrVarExpandOp"),
    (ONE_EDGE, "MATCH (x)-[r:K]->(y), (c)-[rs:K*0..1]->(d) RETURN count(*) AS c", 2,
     "CsrVarExpandOp"),
    ("CREATE (a:N)-[:K]->(b:N), (a)-[:L]->(b)",
     "MATCH (x)-[r:L]->(y), (c)-[rs:K*1..2]->(d) RETURN count(*) AS c", 1,
     "CsrVarExpandOp"),
    ("CREATE (a:N)-[:K]->(b:N), (a)-[:L]->(b)",
     "MATCH (x)-[r]->(y), (c)-[rs:K*1..1]->(d) RETURN count(*) AS c", 1,
     "CsrVarExpandOp"),
    (ONE_EDGE, "MATCH (a)-[r:K]->(b) MATCH (c)-[rs:K*1..2]->(d) RETURN count(*) AS c", 1,
     "CsrVarExpandOp"),
]


@pytest.mark.parametrize("create,query,expected,top", UNIQ_CASES)
def test_uniqueness_across_engines(create, query, expected, top):
    """A WCOJ case pins ``force``: under ``auto`` these tiny graphs keep the
    binary plan, as the reference's do."""
    if top == "MultiwayIntersectOp":
        PCFG.WCOJ_MODE.set("force")
    try:
        result, got = _three(*_creates(create), query)
    finally:
        PCFG.WCOJ_MODE.reset()
    assert got == Counter({(("c", expected),): 1})
    assert _fused_at_top(result.plans, top), result.plans


def test_chain_pair_enforced_in_op():
    """A chain on a graph with a self-loop cannot prove its pair redundant:
    the pair rides ``CsrExpandOp.enforced_pairs`` and the count takes the
    edge-carrying walk, not a FilterOp over materialized rows."""
    port = _creates(UNIQ_CASES[12][0])[0]
    result = port.cypher(UNIQ_CASES[12][1])
    assert "uniq(__r0<>__r1)" in result.plans
    assert _fused_at_top(result.plans, "CsrExpandOp")


def test_uniqueness_materializing_paths():
    """Row-returning consumers run the materializing fused paths, which
    enforce the pairs by element-id masks (``_apply_enforced_pairs``)."""
    create = FORK3.replace("(x1:N)", "(x1:N {v: 1})").replace(
        "(x2:N)", "(x2:N {v: 2})").replace("(x3:N)", "(x3:N {v: 3})")
    q = "MATCH (a)-[r1:K]->(b)<-[r2:K]-(c) RETURN a.v AS x, c.v AS z"
    result, got = _three(*_creates(create), q)
    assert sum(got.values()) == 6
    assert all(dict(r)["x"] != dict(r)["z"] for r in got)
    assert "uniq(r1<>r2)" in result.plans


def _spy(monkeypatch, module, name, calls):
    inner = getattr(module, name)

    def spy(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_varlen_forbid_keeps_fused_count(monkeypatch):
    """The fixed rel is enforced as a seeded forbidden edge
    (``rel_rows_of_ids``), not by a filter over a materialized rel list."""
    calls = {}
    _spy(monkeypatch, PJ, "rel_rows_of_ids", calls)
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(TWO_CYCLE)
    rows = [dict(r) for r in port.cypher(
        "MATCH (x)-[r:K]->(y), (c)-[rs:K*1..2]->(d) RETURN count(*) AS c"
    ).records.collect()]
    assert rows == [{"c": 2}]
    assert calls.get("rel_rows_of_ids", 0) >= 1


def test_proof_preserves_spmv_on_loop_free(monkeypatch):
    """On a loop-free graph the pair drops by proof, so the 2-hop count(*)
    keeps the SpMV chain (no edge-carrying walk)."""
    calls = {}
    _spy(monkeypatch, PJ, "path_count_chain", calls)
    _spy(monkeypatch, PJ, "chain_count_final_unique", calls)
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        "CREATE (a:N)-[:K]->(b:N)-[:K]->(c:N), (c)-[:K]->(a), (b)-[:K]->(a)"
    )
    rows = [dict(r) for r in port.cypher(
        "MATCH (x)-[:K]->(y)-[:K]->(z) RETURN count(*) AS c").records.collect()]
    assert rows == [{"c": 5}]
    assert calls == {"path_count_chain": 1}


def test_rel_list_value_raises_naming_roadmap_item():
    """A var-length relationship list as a value (it raised, naming
    ROADMAP.md queue 1, item 6.3, before the port's list columns): the
    walk emits it, with the fixed rel enforced inside the walk, and the
    answer equals the reference's and the oracle's."""
    q = ("MATCH (x)-[r:K]->(y), (c)-[rs:K*1..2]->(d) "
         "RETURN count(*) AS c, min(size(rs)) AS m")
    result, got = _three(*_creates(TWO_CYCLE), q)
    assert got == Counter({(("c", 2), ("m", 1)): 1})
    assert "CsrVarExpandOp" in result.plans and "uniq" in result.plans


# ---------------------------------------------------------------------------
# bench.py's shapes and chip_smoke.py's walk queries at generate_snb(0.02)
# ---------------------------------------------------------------------------

TWO_HOP_DISTINCT = (  # bench.py TWO_HOP_DISTINCT, chip_smoke.py Q13/Q17
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "WITH DISTINCT a, c RETURN count(*) AS pairs"
)


@pytest.fixture(scope="module")
def snb():
    port_session = CypherSession.cuda(device="cpu")
    ref_session = R.CypherSession.tpu()
    local_session = R.CypherSession.local()
    port = PropertyGraph(port_session, port_generate_snb(0.02, port_session))
    node = [et for et in port._graph.scans if et.is_node][0].table
    rel = [et for et in port._graph.scans if not et.is_node][0].table
    ids = np.asarray(node.column_values("id"), np.int64)
    s = np.searchsorted(ids, rel.column_values("source"))
    d = np.searchsorted(ids, rel.column_values("target"))
    return (
        port,
        RefPropertyGraph(ref_session, ref_generate_snb(0.02, ref_session)),
        RefPropertyGraph(local_session, ref_generate_snb(0.02, local_session)),
        (ids, s, d),
    )


def _window(ids, s, d, k, budget):
    """bench.py's source window over the <= k-walk estimate."""
    n = len(ids)
    est = sum(CS.walk_estimates(s, d, n, k))
    start = n // 2
    w = CS.walk_window(est, budget, start)
    return {"lo": int(ids[start]), "hi": int(ids[start + w - 1]) + 1}, start, w


SNB_WALKS = {
    # (query, walk lengths for the truth, budget); chip_smoke.py's Q18-Q21.
    # Q19's one source already has 3.4M walks of length <= 4 on this dense
    # graph, past what the local oracle's join cascade answers in minutes:
    # it is held to the reference and the brute-force enumeration only
    "Q18": (CS.Q18, 3, 20_000),
    "Q19": (CS.Q19, 4, 60_000),
    "Q20": (CS.Q20, 2, 3_000),
    "Q21_undirected": (CS.Q21_UNDIRECTED, 2, 5_000),
    "Q21_zero": (CS.Q21_ZERO, 2, 5_000),
}


@pytest.mark.parametrize("qname", sorted(SNB_WALKS))
def test_snb_walks_across_engines_and_truth(snb, qname):
    port, ref, local, (ids, s, d) = snb
    query, k, budget = SNB_WALKS[qname]
    params, start, w = _window(ids, s, d, k, budget)
    result, got = _three(port, ref, None if qname == "Q19" else local, query, params)
    assert "CsrVarExpandOp" in result.plans
    n = len(ids)
    window = np.zeros(n, bool)
    window[start:start + w] = True
    sources = np.flatnonzero(window)
    if qname == "Q20":
        counts, keys = CS.brute_walks(CS.directed_steps(s, d), n, sources, 2, pairs=True)
        want = Counter()
        for key in np.concatenate(keys):
            want[(("a", int(ids[key // n])), ("b", int(ids[key % n])))] += 1
        assert got == want
        return
    if qname == "Q21_undirected":
        want = sum(CS.brute_walks(CS.undirected_steps(s, d), n, sources, 2))
    else:
        brute = CS.brute_walks(CS.directed_steps(s, d), n, sources, k)
        assert CS.unique_walk_counts(s, d, n, window, k) == brute
        want = sum(brute) + (w if qname == "Q21_zero" else 0)
    assert got == Counter({(("walks", want),): 1})


def test_two_hop_distinct_across_engines(snb, monkeypatch):
    """``TWO_HOP_DISTINCT`` reaches ``distinct_endpoints_count`` (no
    ``distinct_count`` call); its final hop is the packed-key sort, the
    form the card runs."""
    port, ref, local, (ids, s, d) = snb
    answered = []
    inner = PX.CsrExpandOp.distinct_endpoints_count

    def spy(self, fields):
        answered.append(inner(self, fields))
        return answered[-1]

    monkeypatch.setattr(PX.CsrExpandOp, "distinct_endpoints_count", spy)
    calls = {}
    for name in ("distinct_pairs_count_final", "distinct_hop_materialize"):
        _spy(monkeypatch, PJ, name, calls)
    monkeypatch.setattr(CudaTable, "distinct_count",
                        lambda *a, **k: pytest.fail("distinct_count called"))
    _, got = _three(port, ref, local, TWO_HOP_DISTINCT)
    want, _ = CS.two_hop_distinct_pairs(s, d, len(ids))
    assert got == Counter({(("pairs", want),): 1})
    assert answered == [want]
    assert calls == {"distinct_hop_materialize": 1, "distinct_pairs_count_final": 1}
    assert want == CS.two_hop_distinct_scipy(s, d, len(ids))


def test_walk_device_fault_reaches_caller(snb, monkeypatch):
    """A device fault inside the fused DISTINCT count is not taken for
    "pattern doesn't fit": it reaches the caller typed, and the
    materialized distinct never runs."""
    port = snb[0]

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(PJ, "distinct_pairs_count_final", oom)
    monkeypatch.setattr(CudaTable, "distinct_count",
                        lambda *a, **k: pytest.fail("distinct_count called"))
    result = port.cypher(TWO_HOP_DISTINCT)
    with pytest.raises(ERR.DeviceOOM):
        result.records
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["error"] == "DeviceOOM"


BUCKET_QUERIES = [
    "MATCH (a)-[:K*1..3]-(b) RETURN count(*) AS c",
    "MATCH (a)-[:K*1..3]->(b:M) RETURN a.v AS a, b.v AS b",
    "MATCH (a)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c",
    "MATCH (a)-[:K]->(b)-[:K]->(c) WITH DISTINCT a, c RETURN count(*) AS c",
    "MATCH (a)-[r1:K]->(b)<-[r2:K]-(c) RETURN a.v AS x, c.v AS z",
    "MATCH (x)-[r:K]->(y), (c)-[rs:K*1..2]->(d) RETURN count(*) AS c",
    # ExpandInto's probe over a tail-padded chain, and the fused OPTIONAL
    # expand: both size their lanes exactly in every mode
    "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]-(a) RETURN a.v AS a, b.v AS b, c.v AS c",
    "MATCH (a) OPTIONAL MATCH (a)-[:K]->(b) RETURN a.v AS a, b.v AS b",
]


def test_bucketed_walks_match_exact():
    """On the bucket lattice the walks' pad lanes stay dead: every answer
    equals the exact-size one (the materializing pair masks, the closing
    probe and the optional expand included)."""
    create = _create(1, 14, 30)

    def answers():
        port = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
        return [_bag(port.cypher(q)) for q in BUCKET_QUERIES]

    exact = answers()
    PCFG.BUCKET_MODE.set("pow2")
    try:
        bucketed = answers()
    finally:
        PCFG.BUCKET_MODE.reset()
    assert bucketed == exact
    assert all(sum(b.values()) for b in exact)
