"""The classic equi-join and WHERE filter slice: the port against the JAX
package, on the CPU.

* ``join_probe``: the plain PyTorch version (what a CPU tensor runs, and
  what the CUDA kernel is held to on the card by ``chip_smoke.py``) against
  the reference's ``jit_ops.join_probe`` and its Pallas kernel
  (``join_probe_bucketed``, interpret mode) on the same seeded numpy
  inputs. The contract: ``counts``, ``total`` and the valid build rows are
  equal on every lane, ``lo`` where the count is positive (the port zeroes
  it elsewhere; the reference leaves the insertion point there).
* The port's hash build against the reference's ``_hash_build`` at the
  same size, slot for slot, and every key reachable within the recorded
  probe bound (the kernel's probe, emulated by torch ops).
* ``CudaTable.join`` of every kind and ``CudaTable.filter`` with the
  three-valued predicates against ``TpuTable`` on tables made from one
  numpy seed.
* Q9-Q12 (``chip_smoke.py``'s join/filter queries) at ``generate_snb(0.02)``
  bag-identical across the reference's ``CypherSession.tpu()``, its
  ``local()`` oracle and the port.

Every comparison is exact: the data is integers, strings and floats
compared bit for bit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu import bucketing as RB
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.backend.tpu.pallas import dispatch as RD
from tpu_cypher.backend.tpu.pallas import join as RPJ
from tpu_cypher.backend.tpu.table import TpuTable
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.ir import expr as RE
from tpu_cypher.relational.header import RecordHeader as RHeader
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.hopper import join as PK
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb
from tpu_cypher_torch.ir import expr as PE
from tpu_cypher_torch.relational.header import RecordHeader as PHeader
from tpu_cypher_torch.relational.session import PropertyGraph

torch.set_num_threads(1)

TAG = 7 << 54  # graph-tagged ids: keys far past int32


@pytest.fixture(autouse=True)
def _clean():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()
    RD.MODE.reset()
    RD.reset()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# join_probe: the plain version against the reference
# ---------------------------------------------------------------------------

# (name, probe rows, mask density): the reference's fuzz-corpus shapes
SHAPES = [
    ("empty", 0, 0.0),
    ("all_masked", 300, 0.0),
    ("single_bucket", 9, 0.9),
    ("dense", 1000, 0.85),
    ("max_bucket", 1025, 0.5),
]


def _probe_case(name, n, density, kind="i64"):
    rng = np.random.default_rng(sum(map(ord, name)) + len(kind))
    nr = max(n // 3, 1)
    if kind == "bool":
        rd, ld = rng.random(nr) < 0.3, rng.random(n) < 0.5
    elif kind == "f64":
        rd = rng.integers(-3, 4, nr).astype(np.float64)
        rd[rng.random(nr) < 0.1] = np.nan
        rd[rng.random(nr) < 0.2] = -0.0
        ld = rng.integers(-3, 4, n).astype(np.float64)
        ld[rng.random(n) < 0.1] = np.nan
        ld[rng.random(n) < 0.1] = -0.0
    else:
        rd = rng.integers(0, max(nr // 2, 1), nr) + TAG
        ld = rng.integers(0, max(nr, 1), n) + TAG
    rvalid = rng.random(nr) < max(density, 0.2 if name != "all_masked" else 0.0)
    lvalid = rng.random(n) < max(density, 0.5)
    return rd, rvalid, ld, lvalid


def _check_probe(want, got, nvalid, what):
    """The contract above, with the reference's outputs ``want``."""
    r_idx, lo, counts, total = (np.asarray(x) for x in want)
    g_idx, g_lo, g_counts, g_total = (x.numpy() for x in got)
    assert g_counts.dtype == g_lo.dtype == np.int64, what
    assert np.array_equal(counts, g_counts), what
    assert int(total) == int(g_total), what
    assert np.array_equal(r_idx[:nvalid], g_idx), what
    hit = counts > 0
    assert np.array_equal(lo[hit], g_lo[hit]), what
    assert not g_lo[~hit].any(), what


@pytest.mark.parametrize("kind", ["i64", "bool", "f64"])
@pytest.mark.parametrize("shape_name,n,density", SHAPES)
def test_join_probe_plain_matches_reference(shape_name, n, density, kind):
    rd, rvalid, ld, lvalid = _probe_case(shape_name, n, density, kind)
    is_f64, is_bool = kind == "f64", kind == "bool"
    rd_s, r_order, nv = RJ.join_build(
        np.asarray(rd), (np.asarray(rvalid),), is_f64=is_f64, is_bool=is_bool
    )
    p_rd_s, p_order, p_nv = PJ.join_build(
        _t(rd), (_t(rvalid),), is_f64=is_f64, is_bool=is_bool
    )
    nvalid = int(nv)
    # the build order matches jnp.lexsort's on the valid lanes, ties and
    # the -0.0 vs 0.0 order included
    assert int(p_nv) == nvalid
    assert np.array_equal(np.asarray(r_order)[:nvalid], p_order.numpy()[:nvalid])
    want = RJ.join_probe(
        rd_s, r_order, np.asarray(ld), (np.asarray(lvalid),), nvalid=nvalid,
        is_f64=is_f64, is_bool=is_bool,
    )
    got = PK.join_probe(
        p_rd_s, p_order, _t(ld), (_t(lvalid),), nvalid, is_f64=is_f64, is_bool=is_bool
    )
    _check_probe(want, got, nvalid, (shape_name, kind))
    assert PD.use_counts()["join_probe"] == {"kernel": 0, "plain": 1, "fallback": 0}
    if kind == "i64" and nvalid:
        # the Pallas hash probe, interpreted
        RD.MODE.set("interpret")
        cap = min(RB.round_up_pow2(nvalid, 32), len(rd))
        want_k = RPJ.join_probe_bucketed(
            rd_s, r_order, np.asarray(ld), (np.asarray(lvalid),), nv,
            nvalid_cap=cap, is_f64=False, is_bool=False,
        )
        _check_probe(want_k, got, nvalid, (shape_name, "pallas"))
    # the match pairs the shared materialize emits
    total = int(want[3])
    pairs_w = RJ.join_materialize(want[0], want[1], want[2], total=total)
    pairs_g = PJ.join_materialize(got[0], got[1], got[2], total)
    for w, g in zip(pairs_w, pairs_g):
        assert np.array_equal(np.asarray(w), g.numpy()), shape_name


def _probe_table(table, max_off, q, qvalid):
    """The ``hash_probe.cu`` probe, emulated lane-parallel by torch ops."""
    size = table.shape[0]
    keys = table.view(torch.int64)[:, 0]
    h = PK.slot_hash(q, size)
    lo = torch.zeros_like(q)
    counts = torch.zeros_like(q)
    live = qvalid.clone()
    for t in range(max_off + 1):
        s = (h + t) & (size - 1)
        cnt = table[s, 3].to(torch.int64)
        hit = live & (cnt > 0) & (keys[s] == q)
        lo = torch.where(hit, table[s, 2].to(torch.int64), lo)
        counts = torch.where(hit, cnt, counts)
        live = live & ~hit & (cnt > 0)
    return lo, counts


@pytest.mark.parametrize("nr,spread,ref_ok", [
    (50, 1, True),         # one key repeated
    (2000, 600, True),     # runs of duplicates
    (4096, 1 << 40, True), # all unique, tagged
    (6000, 1 << 40, False),  # a table at load 3/4: more than 16 rounds
])
def test_hash_build_matches_reference_slot_for_slot(nr, spread, ref_ok):
    rng = np.random.default_rng(nr)
    rd = rng.integers(0, spread, nr) + TAG
    if spread > 1:  # negative keys: hi32 with the sign bit
        rd[: nr // 10] = -rd[: nr // 10]
    rvalid = rng.random(nr) < 0.9
    rvalid[0] = True
    rd_s, r_order, nv = RJ.join_build(rd, (rvalid,), is_f64=False, is_bool=False)
    nvalid = int(nv)
    nunique = len(np.unique(rd[rvalid]))
    size = RB.round_up_pow2(2 * nunique, 2) // (1 if ref_ok else 2)
    keys = _t(np.asarray(rd_s, np.int64)[np.asarray(r_order)[:nvalid]])
    table, max_off = PK.hash_build(keys, size)
    assert table.shape == (size, 4) and int((table[:, 3] > 0).sum()) == nunique
    ref = RPJ._hash_build(
        np.asarray(rd_s, np.int64), r_order, nv, cap=nvalid, size=size
    )
    assert bool(ref[4]) == ref_ok
    if ref_ok:
        assert max_off < 16
        for j in range(4):
            assert np.array_equal(np.asarray(ref[j]), table[:, j].numpy()), j
    else:
        assert max_off >= 16
    # every build key, every missing key, and the invalid lanes
    q = np.concatenate([rd, rng.integers(0, spread, 3000) + TAG + 1, [0, -1, TAG]])
    qvalid = rng.random(len(q)) < 0.8
    qvalid[0] = True
    want = PJ.join_probe(
        _t(rd_s), _t(np.asarray(r_order)), _t(q), (_t(qvalid),), nvalid,
        is_f64=False, is_bool=False,
    )
    lo, counts = _probe_table(table, max_off, _t(q), _t(qvalid))
    assert torch.equal(counts, want[2]) and torch.equal(lo, want[1])
    assert int(counts.sum()) > 0


def test_slot_hash_matches_reference_uint32_mix():
    rng = np.random.default_rng(5)
    keys = np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64),
        np.array([0, -1, 2**63 - 1, -(2**63), TAG, 2**32, 2**32 - 1], np.int64),
    ])
    for size in (2, 1024, 1 << 22):
        klo, khi = RPJ._split64(np.asarray(keys))
        want = np.asarray(RPJ._slot_hash(klo, khi, size))
        assert np.array_equal(PK.slot_hash(_t(keys), size).numpy(), want), size


def _as_cuda(launch):
    def wrapped(name, kernel_fn, plain_fn, *, device, eligible=True):
        return launch(name, kernel_fn, plain_fn, device=torch.device("cuda", 0),
                      eligible=eligible)

    return wrapped


def _emulated_build(rd, r_order, nvalid, size, is_f64):
    keys = PK.plain_keys(rd, r_order, nvalid, rd[:0], (), is_f64)[0]
    table, max_off = PK.hash_build(keys, size)
    return torch.cat([table, torch.tensor([[max_off, 0, 0, 0]], dtype=torch.int32)])


def _emulated_probe(table, ld, lvalids, is_f64):
    _, q, qvalid = PK.plain_keys(ld[:0], torch.zeros(0, dtype=torch.int64), 0, ld,
                                 lvalids, is_f64)
    if qvalid is None:
        qvalid = torch.ones_like(q, dtype=torch.bool)
    lo, counts = _probe_table(table[:-1], int(table[-1, 0]), q, qvalid)
    return lo, counts, counts.sum()


@pytest.mark.parametrize("kind", ["i64", "bool", "f64"])
@pytest.mark.parametrize("shape_name,n,density", SHAPES[1:])
def test_join_probe_kernel_tier_matches_reference(monkeypatch, shape_name, n, density, kind):
    """On a CUDA tensor every call with a probe lane takes the kernel tier:
    float keys (their int64 bits once -0.0 is made 0.0, NaN keys invalid)
    and a build with no valid key (``all_masked``) included. The table
    size is the kernel tier's own; the CUDA build is its plain version
    ``hash_build`` over ``plain_keys`` and the CUDA probe is emulated by
    torch ops. The reference is ``jit_ops.join_probe`` under the contract
    above."""
    monkeypatch.setattr(PK, "hash_build_cuda", _emulated_build)
    monkeypatch.setattr(PK, "hash_probe_cuda", _emulated_probe)
    monkeypatch.setattr(PK.dispatch, "launch", _as_cuda(PD.launch))
    rd, rvalid, ld, lvalid = _probe_case(shape_name, n, density, kind)
    is_f64, is_bool = kind == "f64", kind == "bool"
    rd_s, r_order, nv = RJ.join_build(
        np.asarray(rd), (np.asarray(rvalid),), is_f64=is_f64, is_bool=is_bool
    )
    want = RJ.join_probe(
        rd_s, r_order, np.asarray(ld), (np.asarray(lvalid),), nvalid=int(nv),
        is_f64=is_f64, is_bool=is_bool,
    )
    p_rd_s, p_order, p_nv = PJ.join_build(
        _t(rd), (_t(rvalid),), is_f64=is_f64, is_bool=is_bool
    )
    got = PK.join_probe(
        p_rd_s, p_order, _t(ld), (_t(lvalid),), int(p_nv), is_f64=is_f64,
        is_bool=is_bool,
    )
    _check_probe(want, got, int(nv), (shape_name, kind))
    assert PD.use_counts()["join_probe"] == {"kernel": 1, "plain": 0, "fallback": 0}


@pytest.mark.parametrize("case", ["empty_probe"])
def test_join_probe_ineligible_cuda_call_takes_fallback_tier(monkeypatch, case):
    """An empty probe side is no call for the kernel: on a CUDA tensor it
    runs the plain version on the ``fallback`` tier."""
    monkeypatch.setattr(PK, "_join_probe_kernel_tier", lambda *a: pytest.fail("kernel ran"))
    monkeypatch.setattr(PK.dispatch, "launch", _as_cuda(PD.launch))
    rd, rvalid, ld, lvalid = _probe_case("dense", 1000, 0.85)
    ld, lvalid = ld[:0], lvalid[:0]
    rd_s, order, nv = PJ.join_build(_t(rd), (_t(rvalid),), is_f64=False, is_bool=False)
    out = PK.join_probe(rd_s, order, _t(ld), (_t(lvalid),), int(nv),
                        is_f64=False, is_bool=False)
    assert out[2].shape == (0,) and int(out[3]) == 0
    assert PD.use_counts()["join_probe"] == {"kernel": 0, "plain": 0, "fallback": 1}


# ---------------------------------------------------------------------------
# CudaTable.join and CudaTable.filter against TpuTable
# ---------------------------------------------------------------------------


def _null(vals, rng, p=0.2):
    return [None if rng.random() < p else v for v in vals]


def _sides(seed=11, nl=60, nr=45):
    """Two tables of mixed key kinds with nulls, from one numpy seed."""
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog", "eel", "fox"]

    def side(p, n, wset):
        return {
            f"{p}i": _null([int(x) + TAG for x in rng.integers(0, 12, n)], rng),
            f"{p}j": _null([int(x) for x in rng.integers(0, 3, n)], rng),
            f"{p}f": _null([float(x) if x < 9 else x + 0.5 for x in rng.integers(0, 12, n)], rng),
            f"{p}s": _null([wset[x] for x in rng.integers(0, len(wset), n)], rng),
            f"{p}b": _null([bool(x) for x in rng.integers(0, 2, n)], rng),
        }

    left = side("l", nl, words[:4])
    right = side("r", nr, words[2:])
    # a small integer key for the mixed I64/F64 join (floats stay exact)
    left["lk"] = _null([int(x) for x in rng.integers(0, 12, nl)], rng)
    return left, right


def _bag(table):
    return Counter(tuple(sorted(r.items())) for r in table.rows())


JOIN_CASES = [
    ("inner", [("li", "ri")]),
    ("left_outer", [("li", "ri")]),
    ("right_outer", [("li", "ri")]),
    ("full_outer", [("li", "ri")]),
    ("inner", [("li", "ri"), ("lj", "rj")]),       # multi-key
    ("full_outer", [("lj", "rj"), ("ls", "rs")]),  # multi-key, STR extra
    ("inner", [("ls", "rs")]),                     # STR, different vocabs
    ("left_outer", [("lk", "rf")]),                # mixed I64/F64
    ("inner", [("lf", "rf")]),                     # F64 (fallback-tier keys)
    ("inner", [("lb", "rb")]),                     # bool
    ("left_outer", [("ls", "ri")]),                # cross-kind: never equal
    ("cross", []),
    ("inner", []),                                 # keyless
    ("left_outer", []),
]


@pytest.mark.parametrize("kind,cols", JOIN_CASES)
@pytest.mark.parametrize("empty", ["", "left", "right"])
def test_join_kinds_match_reference(kind, cols, empty):
    left, right = _sides()
    if empty == "left":
        left = {c: v[:0] for c, v in left.items()}
    if empty == "right":
        right = {c: v[:0] for c, v in right.items()}
    want = TpuTable.from_columns(left).join(TpuTable.from_columns(right), kind, cols)
    got = CudaTable.from_columns(left).join(CudaTable.from_columns(right), kind, cols)
    assert got.physical_columns == want.physical_columns
    assert _bag(got) == _bag(want)
    if empty == "" and kind in ("inner", "left_outer") and cols:
        assert sum(_bag(got).values()) > 0


def _expr(E, spec):
    """Build one expression from a nested tuple spec with either package's
    ``ir.expr`` module: column names are str, literals are wrapped."""
    if isinstance(spec, str):
        return E.Var(spec)
    op, *args = spec
    if op == "lit":
        return E.Lit(args[0])
    if op == "list":
        return E.ListLit(tuple(E.Lit(v) for v in args[0]))
    sub = [_expr(E, a) for a in args]
    if op in ("Ands", "Ors"):
        return getattr(E, op)(tuple(sub))
    return getattr(E, op)(*sub)


PREDICATES = [
    ("Ands", "b", "c"), ("Ors", "b", "c"), ("Xor", "b", "c"), ("Not", "b"),
    ("Ands", "b", ("Not", "c"), ("lit", True)),
    ("LessThan", "x", "y"), ("GreaterThanOrEqual", "x", "y"),
    ("LessThanOrEqual", "x", "f"),                  # mixed I64/F64
    ("GreaterThan", "f", ("lit", 1.5)),             # NaN compares false
    ("Equals", "f", "f"), ("Neq", "f", "f"),        # NaN = NaN is false
    ("Equals", "x", "s"),                           # cross-kind =: false
    ("LessThan", "x", "s"),                         # cross-kind <: null
    ("Equals", "s", "t"), ("LessThan", "s", "t"),   # vocab unification
    ("GreaterThan", "s", ("lit", "cat")),
    ("Equals", "b", "c"), ("LessThan", "b", "c"),   # false < true
    ("In", "x", ("list", [1, 2, None])),            # a null item
    ("In", "x", ("list", [3, 4.0])),
    ("In", "f", ("list", [1, 2.5])),
    ("In", "s", ("list", ["dog", "zebra"])),
    ("In", "x", ("list", [])),
    ("Equals", "x", ("lit", None)),
]


def _filter_table():
    rng = np.random.default_rng(23)
    n = 200
    words = ["ant", "bee", "cat", "dog"]
    f = [float(v) for v in rng.integers(0, 5, n)]
    for i in rng.integers(0, n, 20):
        f[i] = float("nan")
    for i in rng.integers(0, n, 10):
        f[i] = 2.5
    return {
        "x": _null([int(v) for v in rng.integers(0, 5, n)], rng),
        "y": _null([int(v) for v in rng.integers(0, 5, n)], rng),
        "f": _null(f, rng),
        "b": _null([bool(v) for v in rng.integers(0, 2, n)], rng),
        "c": _null([bool(v) for v in rng.integers(0, 2, n)], rng),
        "s": _null([words[v] for v in rng.integers(0, 4, n)], rng),
        "t": _null([words[v] for v in rng.integers(1, 4, n)], rng),
    }


def _nan_safe_bag(table):
    """Rows with NaN replaced by a marker (NaN != NaN would split a bag)."""
    def fix(v):
        return "NaN" if isinstance(v, float) and v != v else v

    return Counter(tuple(sorted((k, fix(v)) for k, v in r.items())) for r in table.rows())


@pytest.mark.parametrize("spec", PREDICATES, ids=lambda s: repr(s)[:60])
def test_filter_predicates_match_reference(spec):
    cols = _filter_table()
    tables, outs = {}, {}
    for name, E, H, Table in (
        ("ref", RE, RHeader, TpuTable), ("port", PE, PHeader, CudaTable)
    ):
        header = H({E.Var(c): c for c in cols})
        expr = _expr(E, spec)
        t = Table.from_columns(cols)
        # the predicate's value, nulls included, and the filter it drives
        outs[name] = t.with_columns([(expr, "p")], header, {}).column_values("p")
        tables[name] = t.filter(expr, header, {})
    assert outs["port"] == outs["ref"]
    assert _nan_safe_bag(tables["port"]) == _nan_safe_bag(tables["ref"])


# ---------------------------------------------------------------------------
# the slice's queries end to end
# ---------------------------------------------------------------------------

# chip_smoke.py's Q9-Q12; Q10 is IS3-shaped with a person of this graph
QUERIES = {
    "Q9": ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.birthday < b.birthday "
           "RETURN count(*) AS n", "FilterOp"),
    "Q10": ("MATCH (n:Person {id: $personId})-[:KNOWS]-(friend:Person) "
            "RETURN friend.id AS friendId, friend.firstname AS firstName", "FilterOp"),
    "Q11": ("MATCH (a:Person)-[:KNOWS]->(b:Person), (c:Person) "
            "WHERE b.birthday = c.birthday RETURN count(*) AS n", "JoinOp(inner"),
    "Q12": ("MATCH (a:Person) WHERE a.birthday < 1000 "
            "OPTIONAL MATCH (a)-[:KNOWS]->(b:Person) WHERE b.birthday > 9000 "
            "RETURN a.id AS a, b.id AS b", "JoinOp(left_outer"),
}
PARAMS = {"personId": 701}


@pytest.fixture(scope="module")
def engines():
    ref_session = R.CypherSession.tpu()
    local_session = R.CypherSession.local()
    port_session = CypherSession.cuda(device="cpu")
    return (
        RefPropertyGraph(ref_session, ref_generate_snb(0.02, ref_session)),
        RefPropertyGraph(local_session, ref_generate_snb(0.02, local_session)),
        PropertyGraph(port_session, port_generate_snb(0.02, port_session)),
    )


def _qbag(records):
    return Counter(tuple(sorted(dict(r).items())) for r in records.collect())


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_slice_query_bag_identical(engines, qname):
    query, op = QUERIES[qname]
    ref, local, port = engines
    PD.reset()
    result = port.cypher(query, PARAMS)
    got = _qbag(result.records)
    assert got == _qbag(ref.cypher(query, PARAMS).records), qname
    assert got == _qbag(local.cypher(query, PARAMS).records), qname
    assert sum(got.values()) > 0 and got != Counter({(("n", 0),): 1})
    assert op in result.plans and "CsrExpandOp" in result.plans
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    counts = PD.use_counts()
    for name, c in counts.items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
    assert (counts["join_probe"]["plain"] > 0) == (qname in ("Q11", "Q12")), counts
