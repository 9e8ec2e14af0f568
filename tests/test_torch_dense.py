"""The dense count tier: the port against the JAX package, on the CPU.

The counterpart of ``tests/test_mxu_dense.py``. On the CPU the tier is off
by default (``auto`` turns it on where the session's device is CUDA), so
these tests force it (``TPU_CYPHER_MXU_DENSE=force``; both packages read
the same variable). Every entry of the dense matrices is a small exact
integer and every cell of a product an integer of at most 2**24, so the
counts must equal the reference's ``tpu()`` and its ``local()`` oracle
exactly, and the port must route the same shapes to the same tier:

* the seven queries of ``tests/test_mxu_dense.py`` on seeds 7 and 19,
  parallel edges, a route spy (the dense function once, the walk never)
  and ``auto`` off on the CPU;
* the tiled tier with ``dense_adj`` declined, over one and several row
  blocks, and ``mxu_*_tiled`` equal to the dense functions;
* ``mxu_close_count``, ``mxu_distinct_pairs``, ``frontier_multiplicity``
  and ``dense_adj`` held to the reference's on the same bf16-exact arrays;
* the float32 guard: a close whose cells reach 2**24 exactly runs dense,
  one past it keeps the walk, in both packages;
* ``bench.py``'s shapes on ``generate_snb(0.02)``: the same tier in both
  packages, the WCOJ count handed back to the dense tier included;
* a device fault in the dense and the tiled tier reaches the caller typed.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu import expand_op as RX
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.backend.tpu import wcoj as RW
from tpu_cypher.backend.tpu.graph_index import DenseTiles as RefDenseTiles
from tpu_cypher.backend.tpu.graph_index import GraphIndex as RefGraphIndex

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as ERR
from tpu_cypher_torch import interop
from tpu_cypher_torch.api.types import CTInteger
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import expand_op as PX
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda import wcoj as PW
from tpu_cypher_torch.backend.cuda.graph_index import DenseTiles, GraphIndex

torch.set_num_threads(1)

TRIANGLE = "MATCH (a)-[:K]->(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS t"

QUERIES = [
    TRIANGLE,
    # labelled middle and far nodes: masks fold into the product operands
    "MATCH (a:N)-[:K]->(b:M)-[:K]->(c:N)-[:K]->(a) RETURN count(*) AS t",
    # a backwards hop: the reversed dense adjacency
    "MATCH (a)<-[:K]-(b)-[:K]->(c)-[:K]->(a) RETURN count(*) AS t",
    # a 2-cycle close: a one-hop chain stays on the walk
    "MATCH (a)-[:K]->(b)-[:K]->(a) RETURN count(*) AS t",
    # a restricted frontier with multiplicity through a prior expansion
    "MATCH (s {v: 1})-[:K]->(a) WITH a "
    "MATCH (a)-[:K]->(b)-[:K]->(c), (a)-[:K]->(c) RETURN count(*) AS t",
    # DISTINCT endpoints over the boolean product
    "MATCH (a)-[:K]->(b)-[:K]->(c) WITH DISTINCT a, c RETURN count(*) AS t",
    "MATCH (a:N)-[:K]->(b:M)-[:K]->(c) WITH DISTINCT a, c RETURN count(*) AS t",
]

TILED_QUERIES = [QUERIES[0], QUERIES[1], QUERIES[2], QUERIES[5], QUERIES[6]]


@pytest.fixture(autouse=True)
def _force_dense(monkeypatch):
    PDEV.use("cpu")
    monkeypatch.setenv("TPU_CYPHER_MXU_DENSE", "force")


def _random_create(seed, n, e, labels=("N",), loops=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if not loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    parts = [f"(n{i}:{labels[i % len(labels)]} {{v: {i}}})" for i in range(n)]
    parts += [f"(n{s})-[:K]->(n{d})" for s, d in zip(src, dst)]
    return "CREATE " + ", ".join(parts)


def _tiers():
    return dict(RX.MXU_TIER_COUNTS), dict(PX.MXU_TIER_COUNTS)


def _moved(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def _three(create, query):
    """(local rows, reference tpu() rows, port rows, reference tier moves,
    port tier moves) of one query on one CREATE graph."""
    gl = R.CypherSession.local().create_graph_from_create_query(create)
    gt = R.CypherSession.tpu().create_graph_from_create_query(create)
    gp = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
    lv = [dict(r) for r in gl.cypher(query).records.collect()]
    r0, p0 = _tiers()
    tv = [dict(r) for r in gt.cypher(query).records.collect()]
    r1 = dict(RX.MXU_TIER_COUNTS)
    pv = [dict(r) for r in gp.cypher(query).records.collect()]
    return lv, tv, pv, _moved(r0, r1), _moved(p0, dict(PX.MXU_TIER_COUNTS))


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("seed", [7, 19])
def test_dense_differential(query, seed):
    lv, tv, pv, rt, pt = _three(_random_create(seed, 30, 140, labels=("N", "M")), query)
    assert pv == tv == lv, f"{query}: port {pv}, tpu {tv}, local {lv}"
    assert pt == rt, f"{query}: port tiers {pt}, reference {rt}"


def test_dense_parallel_edges_and_multiplicity():
    """Parallel edges enter the products as their exact multiplicities."""
    create = (
        "CREATE (a:N {v: 0})-[:K]->(b:N {v: 1}), (a)-[:K]->(b), "
        "(b)-[:K]->(c:N {v: 2}), (c)-[:K]->(a), (c)-[:K]->(a)"
    )
    for q in (TRIANGLE, QUERIES[5]):
        lv, tv, pv, rt, pt = _three(create, q)
        assert pv == tv == lv and pt == rt == {"dense": 1, "tiled": 0}, (q, pv, lv, pt)


def test_dense_route_spy(monkeypatch):
    """The triangle count goes through ``mxu_close_count`` once and never
    through the walk's closing probe."""
    calls = Counter()
    for name in ("mxu_close_count", "into_close_queries"):
        orig = getattr(PJ, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(PJ, name, spy)
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        _random_create(3, 25, 100)
    )
    g.cypher(TRIANGLE).records.collect()
    assert calls == {"mxu_close_count": 1}


def test_dense_auto_off_on_cpu(monkeypatch):
    monkeypatch.setenv("TPU_CYPHER_MXU_DENSE", "auto")
    calls = Counter()
    orig = PJ.mxu_close_count
    monkeypatch.setattr(PJ, "mxu_close_count",
                        lambda *a, **k: calls.update(["mxu"]) or orig(*a, **k))
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        _random_create(4, 20, 60)
    )
    before = dict(PX.MXU_TIER_COUNTS)
    g.cypher(TRIANGLE).records.collect()
    assert not calls and dict(PX.MXU_TIER_COUNTS) == before
    assert not PX._mxu_dense_mode()


# ---------------------------------------------------------------------------
# the tiled tier: no (Npad, Npad) matrix, forced by declining dense_adj
# ---------------------------------------------------------------------------


@pytest.fixture
def _tiled_only(monkeypatch):
    monkeypatch.setattr(RefGraphIndex, "dense_adj", lambda self, *a, **k: None)
    monkeypatch.setattr(GraphIndex, "dense_adj", lambda self, *a, **k: None)


@pytest.mark.parametrize("query", TILED_QUERIES)
def test_tiled_differential(query, _tiled_only):
    lv, tv, pv, rt, pt = _three(_random_create(11, 40, 200, labels=("N", "M")), query)
    assert pv == tv == lv, f"{query}: port {pv}, tpu {tv}, local {lv}"
    assert pt == rt == {"dense": 0, "tiled": 1}, (pt, rt)


def test_tiled_multi_block(_tiled_only):
    """More nodes than one 256-wide block: the contraction loops over
    several (block, block) @ (block, Npad) products."""
    lv, tv, pv, rt, pt = _three(_random_create(13, 300, 900), TRIANGLE)
    assert pv == tv == lv and pt == rt == {"dense": 0, "tiled": 1}, (pv, lv, pt, rt)


def _adjacency(seed, n, e, block):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int64)
    d = rng.integers(0, n, e).astype(np.int64)
    npad = -(-n // block) * block
    dense = np.zeros((npad, npad), np.int32)
    np.add.at(dense, (s, d), 1)
    return s, d, dense


def _tiles(cls, s, d, n, block, **kw):
    order = np.argsort(s, kind="stable")
    _, counts = np.unique(s * np.int64(n) + d, return_counts=True)
    return cls(n, block, s[order], d[order], int(counts.max()),
               int(np.bincount(s, minlength=n).max()), **kw)


def test_tiled_matches_dense_functions():
    """Kernel level: tiled == dense == the reference on random adjacencies."""
    n, block = 70, 256
    s, d, dense = _adjacency(5, n, 400, block)
    t = _tiles(DenseTiles, s, d, n, block, device="cpu")
    a = torch.from_numpy(dense).to(torch.bfloat16)
    assert torch.equal(t.tile(0), a)
    mult = torch.ones(t.npad, dtype=torch.int64)
    pres = torch.ones(t.npad, dtype=torch.bool)
    close = int(PJ.mxu_close_count(a, a, a, mult, None, None, block=block))
    assert PJ.mxu_close_count_tiled(t, t, t, mult, None, None) == close
    dist = int(PJ.mxu_distinct_pairs(a, a, pres, None, None, block=block))
    assert PJ.mxu_distinct_pairs_tiled(t, t, pres, None, None) == dist
    rt = _tiles(RefDenseTiles, s, d, n, block)
    ra = jnp.asarray(dense).astype(jnp.bfloat16)
    assert RJ.mxu_close_count_tiled(rt, rt, rt, jnp.ones(t.npad, jnp.int64), None, None) == close
    assert int(RJ.mxu_distinct_pairs(ra, ra, jnp.ones(t.npad, bool), None, None,
                                     block=block)) == dist


# ---------------------------------------------------------------------------
# the functions against the reference's, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [256, 2048])
def test_mxu_functions_match_reference(masked, block):
    """Integer equality with the reference on the same bf16-exact arrays:
    multiplicities up to 40 (cells past bf16's 256, below 2**24), a
    frontier with repeats and absent rows, label masks. The port's row
    block does not change the answer."""
    rng = np.random.default_rng(23)
    n, npad = 300, 512
    mats = []
    for _ in range(3):
        m = np.zeros((npad, npad), np.int32)
        k = rng.integers(0, n, (2, 3000))
        np.add.at(m, (k[0], k[1]), rng.integers(1, 6, 3000))
        mats.append(np.minimum(m, 40))
    pos = rng.integers(0, n, 500).astype(np.int64)
    present = rng.random(500) < 0.8
    mult = PJ.frontier_multiplicity(torch.from_numpy(pos), torch.from_numpy(present), n=npad)
    want = RJ.frontier_multiplicity(jnp.asarray(pos), jnp.asarray(present), n=npad)
    assert np.array_equal(mult.numpy(), np.asarray(want))
    masks = (None, None)
    if masked:
        masks = tuple((rng.random(npad) < 0.6).astype(np.float32) for _ in range(2))
    pm = [None if x is None else torch.from_numpy(x).to(torch.bfloat16) for x in masks]
    rm = [None if x is None else jnp.asarray(x).astype(jnp.bfloat16) for x in masks]
    pt = [torch.from_numpy(m).to(torch.bfloat16) for m in mats]
    rt = [jnp.asarray(m).astype(jnp.bfloat16) for m in mats]
    got = int(PJ.mxu_close_count(*pt, mult, *pm, block=block))
    ref = int(RJ.mxu_close_count(*rt, want, *rm, block=256))
    assert got == ref > 0
    pres = mult > 0
    got = int(PJ.mxu_distinct_pairs(pt[0], pt[1], pres, *pm, block=block))
    ref = int(RJ.mxu_distinct_pairs(rt[0], rt[1], want > 0, *rm, block=256))
    assert got == ref > 0


def _parallel_graphs(extra):
    """x->y 256 times, y->z, z->x (and x->w with ``extra``), as Person/KNOWS
    arrays in both packages."""
    from tpu_cypher.io.ldbc import _graph_from_arrays as ref_graph_from_arrays
    from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

    ids = np.array([1, 2, 3, 4], np.int64)
    src = np.array([1] * 256 + [2, 3] + ([1] if extra else []), np.int64)
    dst = np.array([2] * 256 + [3, 1] + ([4] if extra else []), np.int64)
    port = interop.graph_from_arrays(CypherSession.cuda(device="cpu"), ids, {},
                                     {"id": CTInteger.nullable}, src, dst)
    ref = []
    for s in (R.CypherSession.tpu(), R.CypherSession.local()):
        g = ref_graph_from_arrays(s, ids, {"id": ids.tolist()},
                                  {"id": R.api.types.CTInteger.nullable}, src, dst, False)
        ref.append(RefPropertyGraph(s, g))
    return port, ref


@pytest.mark.parametrize("extra,tier", [(False, 1), (True, 0)])
def test_float32_guard_at_2_24(extra, tier, monkeypatch):
    """rowsum 256 x entry 256 x closing entry 256 = 2**24: the close runs
    dense; one more out-edge of x passes it, and both packages keep the
    walk."""
    monkeypatch.setenv("TPU_CYPHER_WCOJ", "off")
    q = ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
         "RETURN count(*) AS t")
    port, (rt, rl) = _parallel_graphs(extra)
    r0, p0 = _tiers()
    tv = [dict(r) for r in rt.cypher(q).records.collect()]
    r1 = dict(RX.MXU_TIER_COUNTS)
    pv = [dict(r) for r in port.cypher(q).records.collect()]
    p1 = dict(PX.MXU_TIER_COUNTS)
    lv = [dict(r) for r in rl.cypher(q).records.collect()]
    assert pv == tv == lv == [{"t": 768}]
    assert _moved(p0, p1) == _moved(r0, r1) == {"dense": tier, "tiled": 0}


@pytest.mark.parametrize("reverse", [False, True])
def test_dense_adj_matches_reference(reverse):
    """The device-built matrix and its metadata equal the reference's host
    build, parallel edges included; past the node cap both decline."""
    create = _random_create(29, 40, 300)
    out = []
    for session, index in ((R.CypherSession.tpu(), RefGraphIndex),
                           (CypherSession.cuda(device="cpu"), GraphIndex)):
        plan = session.create_graph_from_create_query(create).cypher(
            QUERIES[5]).relational_plan
        gi, ctx = index.of(plan.graph), plan.context
        out.append((gi.dense_adj(("K",), reverse, ctx),
                    gi.dense_adj(("K",), reverse, ctx, max_nodes=39)))
    (want, ref_capped), (got, capped) = out
    assert np.array_equal(np.asarray(want[0].astype(jnp.float32)),
                          got[0].to(torch.float32).numpy())
    assert want[1:] == got[1:] and want[1] > 1
    assert capped is None and ref_capped is None


# ---------------------------------------------------------------------------
# bench.py's shapes on a generated SNB graph, and faults
# ---------------------------------------------------------------------------

SNB_SHAPES = {
    "TWO_HOP": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) RETURN count(*) AS c",
    "TWO_HOP_DISTINCT": ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
                         "WITH DISTINCT a, c RETURN count(*) AS pairs"),
    "TRIANGLE": ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
                 "RETURN count(*) AS triangles"),
    "CLIQUE4": ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a), "
                "(a)-[:KNOWS]->(d:Person), (b)-[:KNOWS]->(d), (c)-[:KNOWS]->(d) "
                "RETURN count(*) AS cliques"),
}


@pytest.fixture(scope="module")
def snb():
    from tpu_cypher.io.ldbc import generate_snb as ref_snb
    from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    PDEV.use("cpu")
    rs, ps = R.CypherSession.tpu(), CypherSession.cuda(device="cpu")
    return (RefPropertyGraph(rs, ref_snb(0.02, rs)), PropertyGraph(ps, generate_snb(0.02, ps)))


@pytest.mark.parametrize("shape", sorted(SNB_SHAPES))
def test_snb_shapes_route_alike(shape, snb):
    """Under ``force`` both packages answer each shape alike on the same
    tier; the triangle, which ``auto`` routes to WCOJ at this size, is
    handed back to the dense tier by both (the reference counts that as
    its WCOJ ``shadow`` tier, the port as ``handback``)."""
    ref, port = snb
    q = SNB_SHAPES[shape]
    r0, p0 = _tiers()
    w0, v0 = dict(RW.WCOJ_TIER_COUNTS), dict(PW.WCOJ_TIER_COUNTS)
    tv = [dict(r) for r in ref.cypher(q).records.collect()]
    r1 = dict(RX.MXU_TIER_COUNTS)
    pv = [dict(r) for r in port.cypher(q).records.collect()]
    assert pv == tv
    dense = {"dense": 1, "tiled": 0} if shape in ("TWO_HOP_DISTINCT", "TRIANGLE") else \
        {"dense": 0, "tiled": 0}
    assert _moved(p0, dict(PX.MXU_TIER_COUNTS)) == _moved(r0, r1) == dense
    handed = _moved(v0, dict(PW.WCOJ_TIER_COUNTS)).get("handback", 0)
    assert handed == _moved(w0, dict(RW.WCOJ_TIER_COUNTS)).get("shadow", 0)
    assert handed == (shape == "TRIANGLE")


@pytest.mark.parametrize("site,tiled", [("expand", False), ("mxu_tile", True)])
def test_device_fault_in_dense_tier_reaches_caller(site, tiled, monkeypatch):
    """A device fault inside either tier is raised typed after one device
    attempt; nothing answers in its place."""
    from tpu_cypher_torch.runtime import faults

    if tiled:
        monkeypatch.setattr(GraphIndex, "dense_adj", lambda self, *a, **k: None)
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        _random_create(3, 25, 100)
    )
    before = dict(PX.MXU_TIER_COUNTS)
    result = g.cypher(TRIANGLE)
    with faults.scoped_spec(f"oom@{site}:*"):
        with pytest.raises(ERR.DeviceOOM):
            result.records
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["error"] == "DeviceOOM"
    if tiled:
        assert PX.MXU_TIER_COUNTS["tiled"] == before["tiled"] + 1
