"""Row shaping and grouping: the port against the JAX package, on the CPU.

* The ported ``jit_ops`` functions (the equivalence keys and the group
  factorization, ORDER BY and its packed top-k, percentiles and two
  helpers) against the reference's on the same seeded numpy inputs: nulls
  with arbitrary payloads, NaN, -0.0, bools, STR codes, DESC, all-tie keys,
  empty and one-row inputs, packed and unpacked key sets. Every output is
  compared exactly (float64 bit for bit).
* ``CudaTable`` ``distinct``, ``distinct_count``, ``order_by``,
  ``order_by_limit``, ``skip``, ``limit``, ``with_row_index``, grouped
  ``group`` and ``union_all`` kind promotion against ``TpuTable`` on the
  same columns, rows in order.
* The row-shaping and grouping queries of ``tests/test_tpu_backend.py``
  on its CREATE graph, and ``chip_smoke.py``'s Q10 and Q13-Q16 at
  ``generate_snb(0.02)``, across the reference's ``CypherSession.tpu()``,
  its ``local()`` oracle and the port: bag-identical, and in the same order
  wherever the ORDER BY keys decide it.
"""

import math
import struct
from collections import Counter

import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.backend.tpu.table import TpuTable
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.ir import expr as RE
from tpu_cypher.relational.header import RecordHeader as RHeader
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb
from tpu_cypher_torch.ir import expr as PE
from tpu_cypher_torch.relational.header import RecordHeader as PHeader
from tpu_cypher_torch.relational.session import PropertyGraph

torch.set_num_threads(1)

TAG = 7 << 54  # graph-tagged ids


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _same(want, got, what=""):
    """Exact equality of a reference output and a port tensor: dtype family,
    shape and value, float64 bit for bit."""
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.shape == g.shape, (what, w.shape, g.shape)
    if w.dtype == np.float64:
        assert g.dtype == np.float64, what
        assert np.array_equal(w.view(np.int64), g.view(np.int64)), (what, w, g)
    else:
        assert np.array_equal(w.astype(np.int64), g.astype(np.int64)), (what, w, g)


# ---------------------------------------------------------------------------
# seeded key columns
# ---------------------------------------------------------------------------


def _column(kind, n, rng, masked, spread=4):
    """One key column with arbitrary payloads under its nulls."""
    if kind == "i64":
        d = rng.integers(-spread, spread, n).astype(np.int64)
    elif kind == "tagged":
        d = (rng.integers(0, spread, n) + TAG).astype(np.int64)
    elif kind == "wide":
        d = rng.integers(-(2**40), 2**40, n).astype(np.int64)
        d[rng.random(n) < 0.5] = 17
    elif kind == "tie":
        d = np.full(n, 5, np.int64)
    elif kind == "f64":
        d = rng.integers(-2, 3, n).astype(np.float64)
        d[rng.random(n) < 0.15] = np.nan
        d[rng.random(n) < 0.15] = -0.0
        d[rng.random(n) < 0.05] = np.inf
        d[rng.random(n) < 0.05] = 0.5
    elif kind == "bool":
        d = rng.random(n) < 0.5
    elif kind == "str":
        d = rng.integers(0, spread, n).astype(np.int32)
    else:
        raise ValueError(kind)
    v = rng.random(n) < 0.75 if masked else None
    if masked and n:
        # arbitrary payloads under the nulls (outer-join leftovers)
        junk = rng.integers(-50, 50, n)
        d = np.where(v, d, junk.astype(d.dtype) if kind != "bool" else junk > 0)
        if kind == "str":
            d = np.where(v, d, -1).astype(np.int32)
    kmap = {"tagged": "i64", "wide": "i64", "tie": "i64"}
    return d, v, kmap.get(kind, kind)


KEY_SETS = {
    "i64": [("i64", True)],
    "i64_nomask": [("tagged", False)],
    "f64": [("f64", True)],
    "f64_nomask": [("f64", False)],
    "bool": [("bool", True)],
    "str": [("str", True)],
    "mixed": [("i64", True), ("str", True), ("bool", False)],
    "f64_i64": [("f64", False), ("i64", True)],
    "all_tie": [("tie", False), ("tie", True)],
    "wide": [("wide", False), ("wide", True)],  # packing exceeds 63 bits
}
SIZES = [0, 1, 300]


def _keys(name, n):
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    cols = [_column(kind, n, rng, masked) for kind, masked in KEY_SETS[name]]
    return (
        tuple(d for d, _, _ in cols),
        tuple(v for _, v, _ in cols),
        tuple(k for _, _, k in cols),
    )


def _ref_pack(datas, valids, kinds, extras=()):
    """The packing the reference's table would choose (``_equiv_pack`` with
    min_keys=1), or None."""
    if not datas[0].shape[0] or any(k == "f64" for k in kinds):
        return None
    mins, maxs = RJ.equivalence_minmax(datas, valids, extras, kinds)
    bits = [(int(hi) - int(lo)).bit_length() for lo, hi in zip(mins, maxs)]
    if sum(bits) > 63:
        return None
    return tuple((int(lo), b) for lo, b in zip(np.asarray(mins), bits))


def _port(datas, valids):
    return tuple(_t(d) for d in datas), tuple(_t(v) for v in valids)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(KEY_SETS))
def test_equivalence_factorization_matches_reference(name, n):
    """equivalence_sort (packed and unpacked), equivalence_minmax,
    distinct_count_packed, first_occurrence_rows and group_index."""
    datas, valids, kinds = _keys(name, n)
    pdatas, pvalids = _port(datas, valids)
    pack = _ref_pack(datas, valids, kinds)
    if pack is not None:
        mins, maxs = RJ.equivalence_minmax(datas, valids, (), kinds)
        pmins, pmaxs = PJ.equivalence_minmax(pdatas, pvalids, (), kinds)
        _same(mins, pmins, "min")
        _same(maxs, pmaxs, "max")
        if n:
            want = RJ.distinct_count_packed(datas, valids, (), kinds, pack)
            got = PJ.distinct_count_packed(pdatas, pvalids, (), kinds, pack)
            assert int(want) == int(got)
    unpackable = name.startswith("f64") or (name == "wide" and n > 1)
    assert (pack is None) == (unpackable or n == 0)
    for p in {None, pack}:
        order, flags, cnt = RJ.equivalence_sort(datas, valids, (), kinds, pack=p)
        porder, pflags, pcnt = PJ.equivalence_sort(pdatas, pvalids, (), kinds, pack=p)
        _same(order, porder, f"order pack={p}")
        _same(flags, pflags, "flags")
        assert int(cnt) == int(pcnt)
        k = int(cnt)
        _same(RJ.first_occurrence_rows(order, flags, k=k),
              PJ.first_occurrence_rows(porder, pflags, k=k), "first rows")
        if n:
            seg, first = RJ.group_index(order, flags, k=k)
            pseg, pfirst = PJ.group_index(porder, pflags, k=k)
            _same(seg, pseg, "seg_j")
            _same(first, pfirst, "first_rows")


def test_equivalence_classes_and_extra_keys():
    """NaN is one class, -0.0 equals 0.0, a null payload is ignored, and an
    extra (group id) key splits classes: against the reference."""
    d = np.array([0.0, -0.0, np.nan, np.nan, 1.0, 7.0, 8.0, 0.0])
    v = np.array([True, True, True, True, True, False, False, True])
    seg = np.array([0, 0, 0, 1, 1, 1, 1, 1], np.int64)
    for extras in ((), (seg,)):
        want = RJ.equivalence_sort((d,), (v,), extras, ("f64",))
        got = PJ.equivalence_sort((_t(d),), (_t(v),), tuple(_t(e) for e in extras), ("f64",))
        for w, g in zip(want, got):
            _same(w, g)
    assert int(got[2]) == 6  # {0,-0}, {nan}, {nan,1,null,0} split by seg


ORDER_CASES = {
    "i64": ("i64", [True], [False]),
    "f64": ("f64", [True], [False]),
    "bool": ("bool", [True], [False]),
    "str": ("str", [True], [False]),
    "mixed": ("mixed", [True, False, True], [False, True, False]),
    "f64_i64": ("f64_i64", [False, True], [True, True]),
    "all_tie": ("all_tie", [True, False], [False, False]),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_order_permutation_matches_reference(case, n):
    name, *asc_sets = ORDER_CASES[case]
    datas, valids, kinds = _keys(name, n)
    pdatas, pvalids = _port(datas, valids)
    for ascs in asc_sets:
        ascs = tuple(ascs)
        want = RJ.order_permutation(datas, valids, kinds, ascs)
        got = PJ.order_permutation(pdatas, pvalids, kinds, ascs)
        _same(want, got, f"{case} {ascs}")


def _topk_pack(mins, maxs):
    pack = []
    for lo, hi in zip(np.asarray(mins), np.asarray(maxs)):
        lo, hi = int(lo), int(hi)
        if lo > hi:
            lo, hi = 0, 0
        pack.append((lo, hi - lo, (hi - lo).bit_length()))
    return tuple(pack)


@pytest.mark.parametrize(
    "case", ["i64", "i64_nomask", "str", "bool", "mixed", "all_tie", "all_null"]
)
def test_order_topk_matches_reference(case):
    """The packed top-k: the same rows as the reference's ``lax.top_k``,
    ties (all-tie keys included) broken by the row index."""
    n = 300
    if case == "all_null":
        datas, valids, kinds = _keys("i64", n)
        valids = (np.zeros(n, bool),)
    else:
        datas, valids, kinds = _keys(case, n)
    pdatas, pvalids = _port(datas, valids)
    mins, maxs = RJ.order_minmax(datas, valids)
    pmins, pmaxs = PJ.order_minmax(pdatas, pvalids)
    _same(mins, pmins, "mins")
    _same(maxs, pmaxs, "maxs")
    pack = _topk_pack(mins, maxs)
    for ascs in ((True,) * len(datas), (False,) * len(datas)):
        for k in (1, 7, n):
            want = RJ.order_topk(datas, valids, ascs, pack, k=k)
            got = PJ.order_topk(pdatas, pvalids, ascs, pack, k=k)
            _same(want, got, f"{case} {ascs} k={k}")
            # the same rows a stable ORDER BY puts first, where those are
            # not null (the sort orders null rows by their payload)
            perm = PJ.order_permutation(pdatas, pvalids, kinds, ascs)[:k]
            if all(v is None or v[perm.numpy()].all() for v in valids):
                _same(perm, got, "topk vs sort")


PERCENTILE_KINDS = ["i64", "f64", "str"]


def _percentile_case(kind, n, k):
    rng = np.random.default_rng(n * 7 + len(kind))
    if kind == "f64":
        d = rng.integers(-20, 20, n) / 4.0
        d[rng.random(n) < 0.1] = -0.0
    elif kind == "str":
        d = rng.integers(0, 30, n).astype(np.int32)
    else:
        d = rng.integers(-(2**40), 2**40, n)
    v = rng.random(n) < 0.8
    seg = rng.integers(0, k, n).astype(np.int64)
    seg[seg == k - 1] = 0  # the last group is empty
    return d, v, seg


@pytest.mark.parametrize("n", [0, 1, 200])
@pytest.mark.parametrize("kind", PERCENTILE_KINDS)
def test_segment_percentile_matches_reference(kind, n):
    k = 6
    d, v, seg = _percentile_case(kind, n, k)
    names = ("percentiledisc",) if kind == "str" else ("percentiledisc", "percentilecont")
    for name in names:
        for p in (0.0, 0.25, 0.5, 1 / 3, 1.0):
            want = RJ.segment_percentile(d, v, seg, p, name=name, k=k)
            got = PJ.segment_percentile(_t(d), _t(v), _t(seg), p, name=name, k=k)
            for w, g, what in zip(want[1:], got[1:], ("valid", "order", "pos")):
                _same(w, g, f"{name} p={p} {what}")
            if name == "percentiledisc":
                _same(want[0], got[0], f"disc p={p}")
            else:
                _check_cont(want[0], got[0], d, v, seg, np.asarray(want[2]), p, k)


def _check_cont(want, got, d, v, seg, order, p, k):
    """percentileCont: bit for bit equal to ``vlo * (1 - frac) + vhi * frac``
    evaluated by numpy, one rounding per operation, as the local oracle
    evaluates it; and within one ulp of the reference, whose XLA CPU program
    may contract the expression into a fused multiply-add (ROADMAP.md queue
    3)."""
    n = len(d)
    cnt = np.bincount(seg[v], minlength=k) if n else np.zeros(k, np.int64)
    sizes = np.bincount(seg, minlength=k) if n else np.zeros(k, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    safe = np.maximum(cnt, 1)
    fidx = p * (safe.astype(np.float64) - 1)
    lo, hi = np.floor(fidx).astype(np.int64), np.ceil(fidx).astype(np.int64)
    frac = fidx - lo
    if n:
        sv = d[order].astype(np.float64)
        vlo = sv[np.clip(starts + lo, 0, n - 1)]
        vhi = sv[np.clip(starts + hi, 0, n - 1)]
        plain = vlo * (1 - frac) + vhi * frac
    else:
        plain = np.zeros(k)
    _same(plain, got, f"cont p={p} vs numpy")
    w = np.asarray(want)
    assert (np.abs(w - got.numpy()) <= np.spacing(np.abs(w))).all(), (w, got)


def test_helpers_match_reference():
    rng = np.random.default_rng(3)
    d = rng.normal(size=50)
    for v in (None, rng.random(50) < 0.5):
        for nan_at in (None, 7):
            x = d.copy()
            if nan_at is not None:
                x[nan_at] = np.nan
            assert bool(RJ.any_nan_valid(x, v)) == bool(PJ.any_nan_valid(_t(x), _t(v)))
    a = rng.integers(0, 100, 50)
    outer = rng.permutation(50)
    inner = rng.integers(0, 50, 20)
    _same(RJ.take_take(a, outer, inner), PJ.take_take(_t(a), _t(outer), _t(inner)))


# ---------------------------------------------------------------------------
# CudaTable against TpuTable
# ---------------------------------------------------------------------------


def _canon(v):
    """A value in a form that keeps int against float, -0.0 against 0.0 and
    NaN equal to NaN."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return (type(v).__name__, v)
    if isinstance(v, int):
        return ("int", v)
    if isinstance(v, float):
        return ("nan",) if v != v else ("float", struct.pack("<d", v))
    if isinstance(v, (list, tuple)):
        return ("list", tuple(_canon(x) for x in v))
    return ("other", repr(v))


def _rows(table):
    return [tuple((c, _canon(v)) for c, v in sorted(r.items())) for r in table.rows()]


def _null(vals, rng, p=0.2):
    return [None if rng.random() < p else v for v in vals]


def _table_cols(n=120, seed=5):
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog"]
    f = [float(x) / 2 for x in rng.integers(-3, 4, n)]
    for i in rng.integers(0, n, 8):
        f[i] = float("nan")
    for i in rng.integers(0, n, 8):
        f[i] = -0.0
    return {
        "i": _null([int(x) for x in rng.integers(0, 5, n)], rng),
        "t": [int(x) + TAG for x in rng.integers(0, 40, n)],
        "f": _null(f, rng),
        "s": _null([words[x] for x in rng.integers(0, 4, n)], rng),
        "b": _null([bool(x) for x in rng.integers(0, 2, n)], rng),
        "m": _null([int(x) if x % 2 else x + 0.5 for x in rng.integers(0, 6, n)], rng),
    }


def _both(cols):
    return TpuTable.from_columns(cols), CudaTable.from_columns(cols)


DISTINCT_ON = [None, ["i"], ["f"], ["s", "b"], ["i", "s", "b"], ["t"], ["f", "m"]]


@pytest.mark.parametrize("on", DISTINCT_ON, ids=str)
def test_distinct_and_count_match_reference(on):
    ref, port = _both(_table_cols())
    want, got = ref.distinct(on), port.distinct(on)
    assert got.physical_columns == want.physical_columns
    assert _rows(got) == _rows(want)
    if on is not None:
        assert port.distinct_count(on) == ref.distinct_count(on) == want.size
    empty = CudaTable.from_columns({c: [] for c in _table_cols()})
    assert empty.distinct(on).size == 0


ORDER_ITEMS = [
    [("i", True)], [("i", False)], [("f", True)], [("f", False)],
    [("s", True), ("i", False)], [("b", False), ("f", True)],
    [("m", True)], [("t", False), ("s", True)],
]


@pytest.mark.parametrize("items", ORDER_ITEMS, ids=str)
def test_order_by_and_limit_hook_match_reference(items):
    ref, port = _both(_table_cols())
    assert _rows(port.order_by(items)) == _rows(ref.order_by(items))
    for k in (1, 10, 500):
        want, got = ref.order_by_limit(items, k), port.order_by_limit(items, k)
        assert (want is None) == (got is None)
        if got is not None:
            assert _rows(got) == _rows(want)
            assert _rows(got) == _rows(port.order_by(items).limit(k))


def test_order_by_limit_declines_where_reference_does():
    """A float key, and integer keys past 62 bits with the row bits, give
    None (the caller sorts and limits)."""
    wide = {"a": [0, 2**40], "b": [0, 2**20]}
    for cols, items in (
        (_table_cols(), [("f", True)]),
        (wide, [("a", True), ("b", True)]),
    ):
        ref, port = _both(cols)
        assert ref.order_by_limit(items, 1) is None
        assert port.order_by_limit(items, 1) is None


def test_skip_limit_row_index_match_reference():
    ref, port = _both(_table_cols(n=30))
    for op, arg in (("skip", 0), ("skip", 7), ("skip", 99), ("limit", 0),
                    ("limit", 5), ("limit", 99), ("with_row_index", "__row")):
        want, got = getattr(ref, op)(arg), getattr(port, op)(arg)
        assert got.size == want.size
        assert _rows(got) == _rows(want), (op, arg)


def _aggs(E, specs):
    out = []
    for col, name, arg, distinct, extra in specs:
        out.append((col, E.Agg(name, E.Var(arg) if arg else None, distinct,
                               tuple(E.Lit(x) for x in extra))))
    return out


GROUP_SPECS = [
    ("n", "count", None, False, ()),
    ("ci", "count", "i", False, ()),
    ("si", "sum", "i", False, ()),
    ("sm", "sum", "m", False, ()),
    ("ai", "avg", "i", False, ()),
    ("lo", "min", "f", False, ()),
    ("hi", "max", "s", False, ()),
    ("mm", "max", "m", False, ()),
    ("bt", "min", "b", False, ()),
    ("sd", "stdev", "i", False, ()),
    ("pc", "percentileCont", "i", False, (0.5,)),
    ("pd", "percentileDisc", "m", False, (0.25,)),
    ("ps", "percentileDisc", "s", False, (0.75,)),
    ("cl", "collect", "s", False, ()),
    ("dc", "count", "f", True, ()),
    ("ds", "sum", "i", True, ()),
    ("dl", "collect", "i", True, ()),
    ("dm", "min", "s", True, ()),
]


@pytest.mark.parametrize("by", [[], ["i"], ["s", "b"], ["f"], ["t"]], ids=str)
def test_group_matches_reference(by):
    cols = _table_cols()
    cols["pf"] = [abs(x) if x == x else 1.0 for x in (v or 0.0 for v in cols["f"])]
    specs = GROUP_SPECS + [("pf", "percentileCont", "pf", False, (0.3,))]
    out = {}
    for name, E, H, Table in (("ref", RE, RHeader, TpuTable), ("port", PE, PHeader, CudaTable)):
        header = H({E.Var(c): c for c in cols})
        t = Table.from_columns(cols)
        out[name] = t.group(by, _aggs(E, specs), header, {})
        # zero rows with keys: no group, the same columns
        empty = Table.from_columns({c: v[:0] for c, v in cols.items()})
        if by:
            g = empty.group(by, _aggs(E, specs), header, {})
            assert g.size == 0 and g.physical_columns == out[name].physical_columns
    assert out["port"].physical_columns == out["ref"].physical_columns
    assert _rows(out["port"]) == _rows(out["ref"])


def test_group_refusals_raise():
    """What the reference answers on its host oracle raises here: a
    percentile over NaN values. A fraction outside [0, 1] raises the
    oracle's error, as the reference does. Lists of mixed kinds (``o``)
    raised too until they were device columns (ROADMAP.md item 6.4): they
    group, deduplicate and order as the reference's host oracle does."""
    from tpu_cypher_torch.backend.cuda.compiler import TpuUnsupportedExpr
    from tpu_cypher_torch.ir.functions import CypherTypeError

    cols = {"o": [[1, "a"], [2], None, [1, "a"]], "f": [1.0, float("nan"), 2.0, 3.0],
            "i": [1, 2, 3, 4]}
    t = CudaTable.from_columns(cols)
    ref = TpuTable.from_columns(cols)
    header = PHeader({PE.Var(c): c for c in cols})
    rheader = RHeader({RE.Var(c): c for c in cols})
    with pytest.raises(TpuUnsupportedExpr):
        t.group([], _aggs(PE, [("p", "percentileDisc", "f", False, (0.5,))]), header, {})
    with pytest.raises(CypherTypeError):
        t.group([], _aggs(PE, [("p", "percentileCont", "i", False, (1.5,))]), header, {})
    spec = [("n", "count", None, False, ())]
    assert _rows(t.group(["o"], _aggs(PE, spec), header, {})) == _rows(
        ref.group(["o"], _aggs(RE, spec), rheader, {}))
    assert _rows(t.distinct(["o"])) == _rows(ref.distinct(["o"]))
    assert _rows(t.order_by([("o", True)])) == _rows(ref.order_by([("o", True)]))
    assert t.distinct_count(["o"]) == 3


UNIONS = {
    "i64+f64 keeps intness": ([1, None, 3], [0.5, 2.0, None]),
    "all-null side adopts": ([None, None], ["x", "y"]),
    "all-null str side": (["x", None], [None]),
    "ints beyond 2**53": ([2**60, 1], [0.5]),
    "str+i64 to obj": (["a", "b"], [1, 2]),
    "bool+str to obj": ([True], ["t"]),
    "str vocabs": (["b", "a"], ["c", "a", None]),
    "same kind": ([1, 2], [3, None]),
}


@pytest.mark.parametrize("case", sorted(UNIONS))
def test_union_all_promotion_matches_reference(case):
    left, right = UNIONS[case]
    want = TpuTable.from_columns({"x": left}).union_all(TpuTable.from_columns({"x": right}))
    got = CudaTable.from_columns({"x": left}).union_all(CudaTable.from_columns({"x": right}))
    assert _rows(got) == _rows(want)
    # the reference keeps values of two kinds as host objects ("to obj");
    # the port keeps them on the device, one part per kind
    assert got._cols["x"].kind == ("mix" if case.endswith("to obj") else want._cols["x"].kind)
    assert str(got.column_type("x")) == str(want.column_type("x"))


# ---------------------------------------------------------------------------
# queries across the three engines
# ---------------------------------------------------------------------------

CREATE = (
    "CREATE (a:Person {name:'Alice', age:23, score: 1.5})-[:KNOWS {since:2019}]->"
    "(b:Person {name:'Bob', age:42}),"
    "(b)-[:KNOWS {since:2020}]->(c:Person {name:'Carol', age:55, score: 2.5}),"
    "(a)-[:KNOWS {since:2021}]->(c),"
    "(a)-[:READS]->(k:Book {title:'Graphs'}),"
    "(c)-[:READS]->(k),"
    "(c)-[:KNOWS]->(a)"
)

# the queries of tests/test_tpu_backend.py that use only ported operations
BACKEND_QUERIES = [
    "MATCH (a:Person) RETURN DISTINCT a.age > 30 AS old",
    "MATCH (a:Person) RETURN a.name ORDER BY a.age DESC LIMIT 2",
    "MATCH (a:Person) RETURN a.name AS name ORDER BY name SKIP 1",
    "MATCH (a:Person) RETURN a.score ORDER BY a.score",
    "MATCH (a:Person) RETURN a.age AS age, count(*) AS c ORDER BY age",
    # test_tpu_backend.py's own forms, counting the element variables a, x
    # and p, then the same groupings counting a property or count(*)
    "MATCH (a:Person)-[:KNOWS]->(b) WITH b, count(a) AS fans WHERE fans > 1 RETURN b.name, fans",
    "MATCH (a:Person) OPTIONAL MATCH (a)-[:READS]->(x) RETURN a.name, count(x) AS reads",
    "MATCH (b:Book) OPTIONAL MATCH (p:Person) RETURN b.title, count(p) AS n",
    "MATCH (a:Person) OPTIONAL MATCH (x:Nope) WITH DISTINCT a RETURN count(a) AS n",
    "MATCH (a:Person)-[:KNOWS]->(b) WITH b.name AS name, count(*) AS fans "
    "WHERE fans > 1 RETURN name, fans",
    "MATCH (a:Person) OPTIONAL MATCH (a)-[:READS]->(x) RETURN a.name, count(x.title) AS reads",
    "MATCH (b:Book) OPTIONAL MATCH (p:Person) RETURN b.title, count(p.name) AS n",
    "MATCH (a:Person) OPTIONAL MATCH (x:Nope) WITH DISTINCT a RETURN count(*) AS n",
    "MATCH (p:Person) RETURN p.name AS n UNION ALL MATCH (b:Book) RETURN b.title AS n",
    "MATCH (a:Person)-[k:KNOWS]->(b) RETURN b.name, count(*) AS c, min(k.since) AS lo, max(k.since) AS hi",
    "MATCH (a:Person) RETURN a.age > 30 AS old, count(*) AS c, avg(a.age) AS m",
    "MATCH (a:Person) RETURN a.score AS key, count(*) AS c",
    "MATCH (a:Person)-[k:KNOWS]->() RETURN a.name, sum(k.since) AS total, max(k.since) AS last",
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WITH DISTINCT a, c RETURN count(*) AS pairs",
    "MATCH (a:Person)-[k:KNOWS]->(b) RETURN b.name, stDev(k.since) AS sd ORDER BY b.name",
    "MATCH (a:Person) RETURN percentileCont(a.age, 0.5) AS m, percentileDisc(a.age, 0.5) AS d",
    "MATCH (a:Person) RETURN percentileCont(a.age, 0.0) AS lo, percentileCont(a.age, 1.0) AS hi",
    "MATCH (a:Person)-[k:KNOWS]->(b) RETURN b.name, percentileDisc(k.since, 0.75) AS p ORDER BY b.name",
    "MATCH (a:Person) RETURN percentileDisc(a.name, 0.5) AS mid",
    "MATCH (a:Person) RETURN collect(a.age) AS ages",
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name, collect(b.name) AS friends ORDER BY a.name",
    "MATCH (a:Person) RETURN count(DISTINCT a.age > 30) AS d",
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN sum(DISTINCT b.age) AS s, avg(DISTINCT b.age) AS m",
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name, collect(DISTINCT b.name) AS ns ORDER BY a.name",
    "MATCH (a:Person) RETURN min(DISTINCT a.name) AS lo, max(DISTINCT a.age) AS hi",
    # test_tpu_backend.py's x.v of an absent label, then the same aggregates
    # over no rows, and grouping keys over no rows
    "MATCH (x:Nope) RETURN stDev(x.v) AS sd, percentileCont(x.v, 0.5) AS p, collect(x.v) AS c",
    "MATCH (a:Person) WHERE a.age > 99 "
    "RETURN stDev(a.age) AS sd, percentileCont(a.age, 0.5) AS p, collect(a.age) AS c",
    "MATCH (a:Person) WHERE a.age > 99 RETURN a.name AS n, count(*) AS c",
    "MATCH (a:Person) RETURN a.score AS s, collect(a.name) AS names ORDER BY s",
]


def _records(result):
    return [tuple((c, _canon(v)) for c, v in sorted(dict(r).items()))
            for r in result.records.collect()]


def _unordered_lists(rows):
    """Rows with each collected list as a sorted multiset: ``collect``
    follows its engine's row order, which the local oracle's plan does not
    share."""
    def fix(v):
        return ("list", tuple(sorted(v[1], key=repr))) if v[0] == "list" else v

    return [tuple((c, fix(v)) for c, v in r) for r in rows]


def _check_three(port, ref, local, query, params=None, ordered=False):
    """The port's rows against both reference engines: bag-identical, and
    row for row where the ORDER BY keys decide the order. The port's
    collected lists equal the reference's element for element."""
    got = _records(port.cypher(query, params))
    want = _records(ref.cypher(query, params))
    assert Counter(got) == Counter(want), query
    oracle = _unordered_lists(_records(local.cypher(query, params)))
    assert Counter(_unordered_lists(got)) == Counter(oracle), query
    if ordered:
        assert got == want, query
        assert _unordered_lists(got) == oracle, query
    return got


@pytest.fixture(scope="module")
def create_engines():
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(CREATE),
        R.CypherSession.tpu().create_graph_from_create_query(CREATE),
        R.CypherSession.local().create_graph_from_create_query(CREATE),
    )


@pytest.mark.parametrize("query", BACKEND_QUERIES)
def test_backend_queries_across_engines(create_engines, query):
    port, ref, local = create_engines
    PDEV.use("cpu")
    _check_three(port, ref, local, query, ordered="ORDER BY" in query)


# chip_smoke.py's Q10 (IS3 with its ORDER BY) and Q13-Q16
Q_SNB = {
    "Q10": "MATCH (n:Person {id: $personId})-[:KNOWS]-(friend:Person) "
           "RETURN friend.id AS friendId, friend.firstname AS firstName ORDER BY friendId",
    "Q13": "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
           "WITH DISTINCT a, c RETURN count(*) AS pairs",
    "Q14": "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id AS id, count(*) AS deg "
           "ORDER BY deg DESC, id LIMIT 20",
    "Q15": "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.id < 1793 RETURN a.id AS id, "
           "count(*) AS n, min(b.birthday) AS lo, max(b.birthday) AS hi, "
           "percentileDisc(b.birthday, 0.5) AS med ORDER BY id",
    "Q16": "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN DISTINCT b.birthday AS d "
           "ORDER BY d SKIP 100 LIMIT 50",
    # answered since this slice: the aggregate and the grouping key that the
    # port refused before
    "collect": "MATCH (a:Person)-[:KNOWS]->(b) RETURN collect(b.birthday) AS xs",
    "firstname": "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.firstname AS f, count(*) AS c",
}
KERNELS = {
    "Q10": ("expand_rows",), "Q13": ("expand_rows",), "Q14": ("expand_rows",),
    "Q15": ("expand_rows", "segment_agg"), "Q16": ("expand_rows",),
    "collect": ("expand_rows",), "firstname": ("expand_rows",),
}


@pytest.fixture(scope="module")
def snb_engines():
    port_session = CypherSession.cuda(device="cpu")
    ref_session = R.CypherSession.tpu()
    local_session = R.CypherSession.local()
    return (
        PropertyGraph(port_session, port_generate_snb(0.02, port_session)),
        RefPropertyGraph(ref_session, ref_generate_snb(0.02, ref_session)),
        RefPropertyGraph(local_session, ref_generate_snb(0.02, local_session)),
    )


@pytest.mark.parametrize("qname", sorted(Q_SNB))
def test_snb_queries_across_engines(snb_engines, qname):
    port, ref, local = snb_engines
    PDEV.use("cpu")
    query = Q_SNB[qname]
    params = {"personId": 701}
    got = _check_three(port, ref, local, query, params, ordered="ORDER BY" in query)
    assert got and got[0] != (("pairs", ("int", 0)),)
    PD.reset()
    result = port.cypher(query, params)
    result.records.collect()
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    for name, c in PD.use_counts().items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
        assert (c["plain"] > 0) == (name in KERNELS[qname]), (qname, name, c)


def test_snb_answers_from_numpy(snb_engines):
    """Q13-Q16's answers from the generator's arrays."""
    port = snb_engines[0]
    node = [et for et in port._graph.scans if et.is_node][0].table
    rel = [et for et in port._graph.scans if not et.is_node][0].table
    ids = np.asarray(node.column_values("id"), np.int64)
    bday = np.asarray(node.column_values("birthday"), np.int64)
    s = np.searchsorted(ids, rel.column_values("source"))
    d = np.searchsorted(ids, rel.column_values("target"))
    n = len(ids)

    def rows(q):
        return [dict(r) for r in port.cypher(Q_SNB[q]).records.collect()]

    # Q13: distinct (a, c) over the 2-hop paths
    out = np.bincount(s, minlength=n)
    starts = np.concatenate([[0], np.cumsum(out)])
    by_src = d[np.argsort(s, kind="stable")]
    pairs = np.concatenate([
        s[e] * n + by_src[starts[d[e]]:starts[d[e] + 1]] for e in range(len(s))
    ])
    assert rows("Q13") == [{"pairs": len(np.unique(pairs))}]
    # Q14: out-degree descending, then id
    deg = np.bincount(s, minlength=n)
    top = np.lexsort((ids, -deg))[:20]
    assert rows("Q14") == [{"id": int(ids[i]), "deg": int(deg[i])} for i in top if deg[i]]
    # Q15: per source, count, min, max and the lower median of the far ends
    want = []
    for i in np.flatnonzero((ids < 1793) & (deg > 0)):
        b = np.sort(bday[d[s == i]])
        want.append({"id": int(ids[i]), "n": len(b), "lo": int(b[0]), "hi": int(b[-1]),
                     "med": int(b[math.ceil(0.5 * len(b)) - 1])})
    assert rows("Q15") == want
    # Q16: distinct far-end birthdays, paged
    assert rows("Q16") == [{"d": int(x)} for x in np.unique(bday[d])[100:150]]


def test_two_hop_distinct_takes_packed_count(snb_engines, monkeypatch):
    """Q13 (bench.py TWO_HOP_DISTINCT) is answered by the aggregate
    pushdown's deepest hook, the chain walk's DISTINCT-endpoints count: the
    final hop counts packed (a, c) keys by a sort, and no
    ``distinct_count``, first-occurrence factorization or materialized
    distinct row is left."""
    port = snb_engines[0]
    calls = []
    for name in ("distinct_count_packed", "equivalence_sort", "distinct_pairs_count_final"):
        inner = getattr(PJ, name)

        def spy(*args, _name=name, _inner=inner, **kwargs):
            calls.append(_name)
            return _inner(*args, **kwargs)

        monkeypatch.setattr(PJ, name, spy)
    PDEV.use("cpu")
    port.cypher(Q_SNB["Q13"]).records.collect()
    assert calls == ["distinct_pairs_count_final"]
