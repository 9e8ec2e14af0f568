"""The mesh layer (``tpu_cypher_torch/parallel/``) against the JAX package,
on the CPU.

The port's mesh is an ordered tuple of devices; a list that repeats
``"cpu"`` is its virtual mesh, the counterpart of the reference's
8-device CPU mesh that ``tests/conftest.py`` forces. Held here:

* the reference's seven engine queries (``tests/test_mesh_engine.py``) on
  its 64-node/256-edge and 61-node/243-edge graphs, through the port
  under ``use_mesh(make_row_mesh(["cpu"] * 8))``, bag-identical to the
  reference under its 8-device mesh and to ``CypherSession.local()``;
* each sharded function against the reference's on the same numpy inputs
  at 8 shards, and at 3 and 5 shards (uneven slices) against the port's
  single-device answer, with one ``plain`` gate call per shard of the
  tier's kernel;
* the tier counters advancing on the reference's tier tests and frozen
  by the ``off`` gates; the joins and the DISTINCT count keep the single
  device's path under a mesh (the tables are whole on the home device);
* the surroundings: context restore, ``resolve_mesh``, bucket rounding
  and admission unchanged by a mesh, ``CypherSession.cuda(mesh=...)`` and
  the launch gate making the call's device current.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cypher.parallel import agg as RA
from tpu_cypher.parallel import mesh as RM
from tpu_cypher.parallel import shuffle as RS

import test_mesh_engine as RTM

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.api.mapping import NodeMappingBuilder, RelationshipMappingBuilder
from tpu_cypher_torch.backend.cuda import bucketing as PB
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.column import Column
from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.errors import AdmissionRejected
from tpu_cypher_torch.obs.metrics import REGISTRY as POBS
from tpu_cypher_torch.parallel import agg as PA
from tpu_cypher_torch.parallel import mesh as PM
from tpu_cypher_torch.parallel import shuffle as PS
from tpu_cypher_torch.relational.graphs import ElementTable
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _reset():
    yield
    PM.activate_mesh(None)
    for opt in (PCFG.MESH_AGG, PCFG.MESH_WCOJ, PCFG.WCOJ_MODE, PCFG.BUCKET_MODE,
                PCFG.MEM_BUDGET, PCFG.BROADCAST_LIMIT):
        opt.reset()
    PDEV.use("cpu")


def _port_graph(ids, src, dst, ages):
    s = CypherSession.cuda(device="cpu")
    node_t = s.table_cls.from_columns({"id": ids.tolist(), "age": ages})
    node_m = (NodeMappingBuilder.on("id").with_implied_label("Person")
              .with_property_key("age").build())
    rel_ids = np.arange(len(src), dtype=np.int64) + int(ids.max()) + 1
    rel_t = s.table_cls.from_columns(
        {"rid": rel_ids.tolist(), "s": ids[src].tolist(), "t": ids[dst].tolist()}
    )
    rel_m = (RelationshipMappingBuilder.on("rid").from_("s").to("t")
             .with_relationship_type("KNOWS").build())
    return s.read_from(ElementTable(node_m, node_t), ElementTable(rel_m, rel_t))


def _engines(n, e):
    """(reference mesh, local graph, reference graph, port graph) from one
    set of arrays, as ``test_mesh_engine._meshed_pair`` builds them."""
    mesh, g_local, g_ref = RTM._meshed_pair(n, e)
    ids = np.arange(n, dtype=np.int64) * 7 + 3
    ages = (np.arange(n) * 13 % 60 + 20).tolist()
    src, dst = RTM._edges(n=n, e=e)
    return mesh, g_local, g_ref, _port_graph(ids, src, dst, ages)


@pytest.fixture(scope="module")
def graphs():
    return {
        "even": _engines(RTM.N_NODES, RTM.N_EDGES),
        "odd": _engines(RTM.N_NODES_ODD, RTM.N_EDGES_ODD),
    }


def _bag(result):
    return Counter(tuple(sorted(dict(r).items())) for r in result.records.collect())


def _port_on_mesh(g, q, mesh=None):
    with PM.use_mesh(mesh or PM.make_row_mesh(CPU8)):
        return _bag(g.cypher(q))


@pytest.mark.parametrize("shape", ["even", "odd"])
@pytest.mark.parametrize("query", RTM.QUERIES)
def test_engine_differential_on_mesh(graphs, shape, query):
    rmesh, g_local, g_ref, g_port = graphs[shape]
    expected = _bag(g_local.cypher(query))
    with RM.use_mesh(rmesh):
        ref = _bag(g_ref.cypher(query))
    got = _port_on_mesh(g_port, query)
    assert ref == expected
    assert got == expected, f"\nquery: {query}\nport: {got!r}\nlocal: {expected!r}"


def _counter(name):
    return POBS.counter(name).value()


# ---------------------------------------------------------------------------
# the tiers through the engine, and their gates
# ---------------------------------------------------------------------------

AGG_Q = (
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN b.age AS k, count(*) AS c, "
    "sum(a.age) AS s, min(a.age) AS lo, max(a.age) AS hi, "
    "avg(a.age) AS m ORDER BY k LIMIT 7"
)
TRI_Q = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) "
    "RETURN count(*) AS t"
)


def test_sharded_agg_tier_runs_and_matches(graphs):
    _, g_local, _, g_port = graphs["odd"]
    before = _counter("tpu_cypher_mesh_agg_total")
    PD.reset()
    got = _port_on_mesh(g_port, AGG_Q)
    assert got == _bag(g_local.cypher(AGG_Q))
    # sum, min, max: one gate call a shard; avg two (its sum and count)
    assert _counter("tpu_cypher_mesh_agg_total") == before + 4
    assert PD.use_counts()["segment_agg"]["plain"] == 8 * 5


def test_sharded_distinct_count_tier(monkeypatch):
    """Under a mesh the DISTINCT pushdown keeps the single packed sort."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 97, 1001).astype(np.int64)
    t = CudaTable({"x": Column.from_numpy(vals)})
    single = t.distinct_count(["x"])
    assert single == len(np.unique(vals))
    calls = []
    inner = PJ.distinct_count_packed
    monkeypatch.setattr(PJ, "distinct_count_packed",
                        lambda *a: calls.append(1) or inner(*a))
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        sharded = t.distinct_count(["x"])
    assert sharded == single
    assert calls == [1]


def test_sharded_wcoj_triangle(graphs):
    _, g_local, _, g_port = graphs["odd"]
    before = _counter("tpu_cypher_mesh_wcoj_total")
    PCFG.WCOJ_MODE.set("force")
    PD.reset()
    got = _port_on_mesh(g_port, TRI_Q)
    assert got == _bag(g_local.cypher(TRI_Q))
    assert _counter("tpu_cypher_mesh_wcoj_total") == before + 1
    probes = PD.use_counts()["intersect"]["plain"]
    assert probes > 0 and probes % 8 == 0  # one gate call a shard per probe


def test_mesh_gates_disable_tiers(graphs):
    _, g_local, _, g_port = graphs["odd"]
    q = ("MATCH (a:Person)-[:KNOWS]->(b) RETURN b.age AS k, count(*) AS c, "
         "sum(a.age) AS s ORDER BY k LIMIT 5")
    PCFG.MESH_AGG.set("off")
    PCFG.MESH_WCOJ.set("off")
    PCFG.WCOJ_MODE.set("force")
    a0 = _counter("tpu_cypher_mesh_agg_total")
    w0 = _counter("tpu_cypher_mesh_wcoj_total")
    assert _port_on_mesh(g_port, q) == _bag(g_local.cypher(q))
    assert _port_on_mesh(g_port, TRI_Q) == _bag(g_local.cypher(TRI_Q))
    t = CudaTable({"x": Column.from_numpy(np.arange(50) % 7)})
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        assert t.distinct_count(["x"]) == 7
    assert _counter("tpu_cypher_mesh_agg_total") == a0
    assert _counter("tpu_cypher_mesh_wcoj_total") == w0


def test_count_chain_reads_uneven_csr_slices(graphs):
    """The 2-hop count runs the sharded SpMV over ``col_idx`` slices cached
    on the GraphIndex; tables stay whole (no mesh pad rows)."""
    _, g_local, _, g_port = graphs["odd"]
    q = RTM.QUERIES[0]
    assert _port_on_mesh(g_port, q) == _bag(g_local.cypher(q))
    gi = GraphIndex.of(g_port._graph)
    entries = [v for k, v in gi._shards.items() if k[0] == "csr" and k[3].size == 8]
    assert entries
    rp_parts, ci = entries[0]
    assert len(ci.parts) == 8 and len(rp_parts) == 8
    assert ci.bounds == PM.shard_bounds(RTM.N_EDGES_ODD, 8)
    assert len({b - a for a, b in zip(ci.bounds, ci.bounds[1:])}) == 2  # uneven
    scan = g_port._graph.scans[0].table
    assert all(len(c) == RTM.N_NODES_ODD for c in scan._cols.values())


# ---------------------------------------------------------------------------
# each sharded function against the reference's
# ---------------------------------------------------------------------------


def _edge_case(seed=7, n=50, e=173):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return n, src, dst


def _port_mesh(nsh):
    return PM.make_mesh(["cpu"] * nsh)


@pytest.mark.parametrize("nsh", [8, 3, 5])
def test_sharded_graph_programs(nsh):
    n, src, dst = _edge_case()
    deg = np.bincount(src, minlength=n).astype(np.int64)
    p0 = np.random.default_rng(1).integers(0, 5, n).astype(np.int64)
    if nsh == 8:
        rmesh = RM.make_mesh(jax.devices()[:8])
        sp, cp, _ = RM.pad_edges(src, dst, 8)
        r_src, r_col = RM.shard_edge_arrays(rmesh, sp, cp)
        want_two = int(RM.sharded_two_hop_count(rmesh, jnp.asarray(deg), r_col))
        want_walk = np.asarray(RM.sharded_walk_step(rmesh, n)(jnp.asarray(p0), r_src, r_col))
        want_train = [np.asarray(x) for x in RM.sharded_training_step(rmesh, n, 3)(
            jnp.asarray(p0), jnp.asarray(deg), r_src, r_col)]
    else:
        one = _port_mesh(1)
        t_src, t_col = torch.from_numpy(src.astype(np.int64)), torch.from_numpy(dst.astype(np.int64))
        want_two = int(PM.sharded_two_hop_count(one, torch.from_numpy(deg), t_col))
        want_walk = PM.sharded_walk_step(one, n)(torch.from_numpy(p0), t_src, t_col).numpy()
        want_train = [x.numpy() for x in PM.sharded_training_step(one, n, 3)(
            torch.from_numpy(p0), torch.from_numpy(deg), t_src, t_col)]
    # the port's slices may be uneven: no sentinel pad edges
    p_src, p_col, pad = PM.pad_edges(src.astype(np.int64), dst.astype(np.int64), nsh)
    assert pad == 0 and len(p_src) == len(src)
    pmesh = _port_mesh(nsh)
    ps, pc = PM.shard_edge_arrays(pmesh, p_src, p_col)
    assert len(ps.parts) == nsh
    assert int(PM.sharded_two_hop_count(pmesh, torch.from_numpy(deg), pc)) == want_two
    assert want_two == int(deg[dst].sum())
    walk = PM.sharded_walk_step(pmesh, n)(torch.from_numpy(p0), ps, pc).numpy()
    assert np.array_equal(walk, want_walk)
    train = PM.sharded_training_step(pmesh, n, 3)(torch.from_numpy(p0), torch.from_numpy(deg), ps, pc)
    for got, want in zip(train, want_train):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nsh", [8, 3, 5])
def test_sharded_range_count(nsh):
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 300, 997)).astype(np.int64)
    q = rng.integers(-5, 310, 400).astype(np.int64)
    qok = rng.random(400) > 0.2
    if nsh == 8:
        rrow = RM.make_row_mesh(jax.devices()[:8])
        with RM.use_mesh(rrow):
            r_keys, pad = RM.padded_to_mesh(keys, 1 << 62)
        assert pad > 0
        want = np.asarray(RM.sharded_range_count(rrow)(r_keys, jnp.asarray(q), jnp.asarray(qok)))
    else:
        want = PM.sharded_range_count(_port_mesh(1))(
            torch.from_numpy(keys), torch.from_numpy(q), torch.from_numpy(qok)).numpy()
    PD.reset()
    got = PM.sharded_range_count(PM.make_row_mesh(["cpu"] * nsh))(
        torch.from_numpy(keys), torch.from_numpy(q), torch.from_numpy(qok))
    assert np.array_equal(got.numpy(), want)
    assert PD.use_counts()["intersect"]["plain"] == nsh


def _agg_case(kind):
    """203 rows over 12 groups: rows reach groups 0-9 only (10 and 11 are
    empty) and every row of group 9 is masked."""
    rng = np.random.default_rng(3)
    n, k = 203, 12
    seg = rng.integers(0, 10, n).astype(np.int64)
    valid = (rng.random(n) > 0.25) & (seg != 9)
    data = rng.random(n) > 0.5 if kind == "BOOL" else rng.integers(-1000, 1000, n).astype(np.int64)
    return data, valid, seg, k


AGG_CASES = [(k, a) for k in ("I64", "BOOL") for a in ("count", "sum", "min", "max", "avg")
             if k == "I64" or a in ("count", "min", "max")]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("nsh", [8, 3, 5])
@pytest.mark.parametrize("kind,name", AGG_CASES)
def test_sharded_segment_agg(kind, name, nsh):
    data, valid, seg, k = _agg_case(kind)
    is_bool = kind == "BOOL"
    t = [torch.from_numpy(x) for x in (data, valid, seg)]
    if nsh == 8:
        with RM.use_mesh(RM.make_row_mesh(jax.devices()[:8])):
            want = RA.sharded_segment_agg(jnp.asarray(data), jnp.asarray(valid),
                                          jnp.asarray(seg), name, is_bool, k)
    else:
        out, ok, _, _ = PJ.segment_aggregate(t[0], t[1], None, t[2], name,
                                             "bool" if is_bool else "i64", k)
        want = (out, None if name in ("count", "sum") else ok)
    PD.reset()
    with PM.use_mesh(PM.make_row_mesh(["cpu"] * nsh)):
        got = PA.sharded_segment_agg(t[0], t[1], t[2], name, is_bool, k)
    assert _same_bits(got[0], want[0]), (got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    calls = 2 if name == "avg" else 1
    assert PD.use_counts()["segment_agg"]["plain"] == nsh * calls


def test_segment_agg_tier_declines():
    data, valid, seg, k = _agg_case("I64")
    t = [torch.from_numpy(x) for x in (data, valid, seg)]
    assert PA.sharded_segment_agg(t[0], t[1], t[2], "sum", False, k) is None  # no mesh
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        assert PA.sharded_segment_agg(t[0], t[1], t[2], "stdev", False, k) is None
        assert PA.sharded_segment_agg(t[0][:0], None, t[2][:0], "sum", False, k) is None
        PCFG.MESH_AGG.set("off")
        assert PA.sharded_segment_agg(t[0], t[1], t[2], "sum", False, k) is None


def _join_case(n_r):
    rng = np.random.default_rng(23)
    lk = rng.integers(-20, 40, 300).astype(np.int64)
    rk = rng.integers(-20, 40, n_r).astype(np.int64)
    lv = rng.random(300) > 0.1
    rv = rng.random(n_r) > 0.1
    return lk, lv, rk, rv


def _pairs(got):
    return Counter(zip(np.asarray(got[0]).tolist(), np.asarray(got[1]).tolist()))


def _truth_pairs(lk, lv, rk, rv):
    return Counter((i, j) for i in range(len(lk)) for j in range(len(rk))
                   if lv[i] and rv[j] and lk[i] == rk[j])


@pytest.mark.parametrize("nsh", [8, 3, 5])
@pytest.mark.parametrize("fn", ["broadcast_join", "hash_repartition_join"])
def test_sharded_joins(fn, nsh):
    lk, lv, rk, rv = _join_case(120)
    truth = _truth_pairs(lk, lv, rk, rv)
    if nsh == 8:
        with RM.use_mesh(RM.make_row_mesh(jax.devices()[:8])):
            ref = getattr(RS, fn)(*(jnp.asarray(x) for x in (lk, lv, rk, rv)))
        assert _pairs(ref) == truth
    PD.reset()
    with PM.use_mesh(PM.make_row_mesh(["cpu"] * nsh)):
        got = getattr(PS, fn)(*(torch.from_numpy(x) for x in (lk, lv, rk, rv)))
    assert _pairs(got) == truth
    # the single device's join: one probe, whatever the shard count
    assert PD.use_counts()["join_probe"]["plain"] == 1


def test_broadcast_declines_a_large_build():
    lk, lv, rk, rv = _join_case(120)
    PCFG.BROADCAST_LIMIT.set(100)  # pinned: honoured verbatim
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        args = [torch.from_numpy(x) for x in (lk, lv, rk, rv)]
        assert PS.broadcast_join(*args) is None
        assert _pairs(PS.hash_repartition_join(*args)) == _truth_pairs(lk, lv, rk, rv)
    assert PS.hash_repartition_join(*args) is None  # no mesh


def test_composite_key_join_verifies_every_column():
    """Two-column int64 keys under a mesh: the single device's join,
    whose matches hold on both columns."""
    rng = np.random.default_rng(4)
    a = CudaTable({"x": Column.from_numpy(rng.integers(0, 6, 80)),
                   "y": Column.from_numpy(rng.integers(0, 4, 80))})
    b = CudaTable({"u": Column.from_numpy(rng.integers(0, 6, 50)),
                   "v": Column.from_numpy(rng.integers(0, 4, 50))})
    single = a._join_device(b, "inner", [("x", "u"), ("y", "v")])
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        sharded = a._join_device(b, "inner", [("x", "u"), ("y", "v")])

    def rows(t):
        return Counter(tuple(r[c] for c in ("x", "y", "u", "v")) for r in t.rows())

    assert rows(sharded) == rows(single)
    assert all(r[0] == r[2] and r[1] == r[3] for r in rows(sharded))


@pytest.mark.parametrize("nsh", [8, 3, 5])
def test_sharded_distinct_count(nsh):
    rng = np.random.default_rng(5)
    keys = rng.integers(-(1 << 62), 1 << 62, 1001).astype(np.int64)
    keys[::3] = keys[1::3][: len(keys[::3])]  # repeats
    valid = rng.random(1001) > 0.1
    truth = len(np.unique(keys[valid]))
    if nsh == 8:
        with RM.use_mesh(RM.make_row_mesh(jax.devices()[:8])):
            assert RS.sharded_distinct_count(jnp.asarray(keys), jnp.asarray(valid)) == truth
    with PM.use_mesh(PM.make_row_mesh(["cpu"] * nsh)):
        got = PS.sharded_distinct_count(torch.from_numpy(keys), torch.from_numpy(valid))
    assert got == truth
    assert PS.sharded_distinct_count(torch.from_numpy(keys)) is None  # no mesh


def test_mix64_and_combine_keys_bit_for_bit():
    rng = np.random.default_rng(9)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096, dtype=np.int64)
    keys[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    ref = np.asarray(RS._mix64(jnp.asarray(keys))).view(np.int64)
    assert np.array_equal(PS._mix64(torch.from_numpy(keys)).numpy(), ref)
    cols = [keys, keys[::-1].copy(), rng.integers(0, 7, 4096).astype(np.int64)]
    ref_c = np.asarray(RS.combine_keys(tuple(jnp.asarray(c) for c in cols)))
    got_c = PS.combine_keys([torch.from_numpy(c) for c in cols]).numpy()
    assert np.array_equal(got_c, ref_c)


# ---------------------------------------------------------------------------
# the surroundings
# ---------------------------------------------------------------------------


def test_mesh_context_restores():
    assert PM.current_mesh() is None
    mesh = PM.make_row_mesh(CPU8)
    assert mesh.shape == {PM.ROW_AXIS: 8} and mesh.home == torch.device("cpu")
    assert hash(mesh) == hash(PM.make_row_mesh(CPU8))
    with PM.use_mesh(mesh):
        assert PM.current_mesh() is mesh and PM.mesh_size() == 8
        a = torch.arange(17)
        x = PM.shard_rows(a)
        assert isinstance(x, PM.ShardedRows) and x.bounds == PM.shard_bounds(17, 8)
        assert torch.equal(torch.cat(x.parts), a)
        assert x.parts[1]._base is a  # on the home device a slice is a view
        got, pad = PM.padded_to_mesh(np.arange(5))
        assert pad == 0 and len(got.parts) == 8
        with PM.use_mesh(None):
            assert PM.current_mesh() is None
        assert PM.current_mesh() is mesh
    assert PM.current_mesh() is None and PM.mesh_size() == 1
    assert torch.equal(PM.shard_rows(torch.arange(4)), torch.arange(4))


def test_resolve_mesh_specs():
    mesh = PM.make_row_mesh(CPU8)
    assert PM.resolve_mesh(mesh) is mesh
    assert PM.resolve_mesh(["cpu", "cpu"]).size == 2
    for spec in (None, "", "off", "none", "0", "1", 1, 0, "bogus"):
        assert PM.resolve_mesh(spec) is None
    if not torch.cuda.is_available():
        # integer and "auto" specs take cards only, never a virtual mesh
        for spec in (4, "4", "auto", "all"):
            assert PM.resolve_mesh(spec) is None
        with pytest.raises(PDEV.DeviceUnavailable):
            PM.make_row_mesh()
        with pytest.raises(PDEV.DeviceUnavailable):
            PM.make_row_mesh(["cuda:0", "cuda:0"])


def test_env_default_mesh_is_memoized(monkeypatch):
    monkeypatch.setenv("TPU_CYPHER_MESH", "off")
    assert PM.current_mesh() is None
    assert PM._ENV_MESH_CACHE["off"] is None


def test_session_mesh_sets_home_device():
    s = CypherSession.cuda(mesh=["cpu"] * 4)
    assert PM.current_mesh().size == 4 and PDEV.get() == torch.device("cpu")
    g = s.create_graph_from_create_query("CREATE (:P {v: 1})-[:K]->(:P {v: 2})-[:K]->(:P {v: 3})")
    assert [dict(r) for r in g.cypher(
        "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c").records.collect()] == [{"c": 1}]
    CypherSession.cuda(device="cpu", mesh=["cpu"] * 2)
    PM.activate_mesh(None)
    if not torch.cuda.is_available():
        with pytest.raises(PDEV.DeviceUnavailable):
            CypherSession.cuda(mesh=4)  # no cards: no mesh, and no CPU asked for
        with pytest.raises(PDEV.DeviceUnavailable):
            CypherSession.cuda(mesh=["cuda:0", "cuda:0"])
        with pytest.raises(PDEV.DeviceUnavailable):
            CypherSession.cuda(device="cuda:0", mesh=["cpu"] * 2)
    assert PM.current_mesh() is None or PM.current_mesh().home == torch.device("cpu")


def test_per_shard_bucket_lattice():
    """Tables stay whole on the home device, so a mesh leaves the lattice
    as it is: no per-shard extent to round."""
    PCFG.BUCKET_MODE.set("pow2")
    plain = {n: PB.round_size(n) for n in (1, 5, 31, 100, 1000, 12345)}
    for nsh in (4, 8):
        with PM.use_mesh(PM.make_row_mesh(["cpu"] * nsh)):
            assert {n: PB.round_size(n) for n in plain} == plain


def test_per_shard_admission_budget():
    PCFG.MEM_BUDGET.set(8 * 1024 * 1024)
    PCFG.BUCKET_MODE.set("pow2")
    rows, bpr = 2 * 1024 * 1024, 16
    with pytest.raises(AdmissionRejected) as e1:
        PB.admit(rows, bpr, "test-site")
    assert "per shard" not in str(e1.value)
    with PM.use_mesh(PM.make_row_mesh(CPU8)):
        with pytest.raises(AdmissionRejected) as e2:
            PB.admit(rows, bpr, "test-site")
        PB.admit(64, 16, "test-site")  # small: admitted
    # the whole table lives on the home device: judged as without a mesh
    assert str(e2.value) == str(e1.value)
    assert e2.value.budget_bytes == 8 * 1024 * 1024
    assert e2.value.estimated_bytes > e2.value.budget_bytes


def test_launch_makes_the_call_device_current(monkeypatch):
    """``dispatch.launch`` enters ``torch.cuda.device(<the call's device>)``
    before the kernel wrapper runs and leaves it after: a wrapper's ctypes
    launch then meets the context of its tensors' card."""
    events = []

    class Recorder:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            events.append(("enter", self.dev))

        def __exit__(self, *exc):
            events.append(("exit", self.dev))

    def wrapper():
        events.append(("kernel",))
        return "launched"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    dev = torch.device("cuda", 1)
    got = PD.launch("segment_agg", wrapper, lambda: "plain", device=dev)
    assert got == "launched"
    assert events == [("enter", dev), ("kernel",), ("exit", dev)]
    events.clear()
    assert PD.launch("segment_agg", wrapper, lambda: "plain", device=torch.device("cpu")) == "plain"
    assert events == []
