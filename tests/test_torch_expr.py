"""The expression compiler and elements as values: the port against the JAX
package, on the CPU.

* Every expression kind ``CudaEvaluator`` compiles (arithmetic, CASE,
  coalesce, the numeric functions, the vocab and distinct-value routes,
  string predicates, ``type(r)``, element identity,
  a property the header lacks) against the reference's ``TpuEvaluator``
  (host islands included) on the same seeded columns: nulls with arbitrary
  payloads, NaN, -0.0, +-inf, 0 divisors, INT64_MIN and INT64_MAX, a
  column mixing INTEGER and FLOAT values, at 64 rows, one row and none.
  Kinds and decoded values are compared exactly (int against float, -0.0
  against 0.0, NaN equal to NaN), except that ``exp``, ``log``, ``log10``,
  ``sin``, ``cos``, ``tan`` and ``^`` may differ by 4 ulp.
* List, map and element values (``LST`` and ``STRUCT`` columns) against
  the reference's host island on the same columns, values compared in
  order (the reference holds them as host objects, so kinds are not
  compared).
* One test per kind the port still refuses, naming its ROADMAP.md item,
  and ``rand()``; the temporal cases it once refused (ROADMAP.md queue 1,
  item 7) now answer as the reference does, or raise the reference's
  error.
* The queries of ``tests/test_tpu_backend.py`` without list values that
  no other port test runs, and ``chip_smoke.py``'s Q27-Q30 at
  ``generate_snb(0.02)``, across the reference's ``CypherSession.tpu()``,
  its ``local()`` oracle and the port: bag-identical.
"""

import math
import struct
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import tpu_cypher as R
from tpu_cypher.api import types as RT
from tpu_cypher.backend.tpu.column import Column as RColumn
from tpu_cypher.backend.tpu.compiler import TpuEvaluator
from tpu_cypher.backend.tpu.table import TpuTable
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.ir import expr as RE
from tpu_cypher.relational.header import RecordHeader as RHeader
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.api import types as PT
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda.column import Column as PColumn
from tpu_cypher_torch.backend.cuda.compiler import CudaEvaluator, TpuUnsupportedExpr
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb
from tpu_cypher_torch.ir import expr as PE
from tpu_cypher_torch.relational.header import RecordHeader as PHeader
from tpu_cypher_torch.relational.session import PropertyGraph

torch.set_num_threads(1)

I64_MIN, I64_MAX = -(2**63), 2**63 - 1


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


# ---------------------------------------------------------------------------
# the evaluator against TpuEvaluator
# ---------------------------------------------------------------------------

VOCAB_S = sorted(["", "Alpha", "alpha", "beta", " b e ", "12", "-3.5", "x1", "p13", "p1"])
VOCAB_T = sorted(["beta", "gamma", "Alpha", "zz"])


def _arrays(n=64, seed=11):
    """name -> (kind, data, valid or None, vocab, int flags or None); null
    rows keep whatever payload the generator drew."""
    rng = np.random.default_rng(seed)

    def valid(p=0.2):
        return rng.random(n) >= p

    i = rng.integers(-50, 51, n)
    i[[5, 9, 17]] = [I64_MIN, I64_MAX, 0]
    specials = [np.nan, -0.0, 0.0, np.inf, -np.inf, 2.5, -2.5, 0.5, -0.5, 1e300]
    f = rng.choice(np.concatenate([np.arange(-7, 8) / 2, specials]), n)
    f[[0, 1, 2]] = [-0.0, np.nan, 2.5]
    g = rng.uniform(-1, 100, n)
    g[[3, 4]] = [0.0, 1.0]
    m_int = rng.random(n) < 0.5
    m = np.where(m_int, rng.integers(-9, 10, n), rng.integers(-9, 10, n) + 0.5).astype(float)
    ids = rng.integers(0, 12, n)
    knows = rng.random(n) < 0.6
    return {
        "i": ("i64", i, valid(0.15), None, None),
        "j": ("i64", rng.integers(-3, 4, n), valid(), None, None),
        "k": ("i64", rng.integers(-1000, 1001, n), None, None, None),
        "f": ("f64", f, valid(0.15), None, None),
        "g": ("f64", g, None, None, None),
        "m": ("f64", m, valid(0.1), None, m_int),
        "s": ("str", rng.integers(0, len(VOCAB_S), n).astype(np.int32), valid(), VOCAB_S, None),
        "t": ("str", rng.integers(0, len(VOCAB_T), n).astype(np.int32), valid(0.4), VOCAB_T, None),
        "b": ("bool", rng.random(n) < 0.5, valid(), None, None),
        "n_id": ("i64", np.arange(n), None, None, None),
        "a": ("i64", ids, valid(0.3), None, None),
        "c": ("i64", rng.integers(0, 12, n), None, None, None),
        "r": ("i64", rng.integers(0, 12, n), valid(0.3), None, None),
        "r_src": ("i64", ids, None, None, None),
        "r_dst": ("i64", rng.integers(0, 12, n), None, None, None),
        "r_knows": ("bool", knows, None, None, None),
        "r_reads": ("bool", ~knows, None, None, None),
    }


PROPS = ("i", "j", "k", "f", "g", "m", "s", "t", "b")


def _header(H, E):
    n, a, c, r = (E.Var(x) for x in "nacr")
    m = {E.Property(n, p): p for p in PROPS}
    m.update({E.Id(n): "n_id", E.Id(a): "a", E.Id(c): "c", E.Id(r): "r",
              E.StartNode(r): "r_src", E.EndNode(r): "r_dst",
              E.HasType(r, "KNOWS"): "r_knows", E.HasType(r, "READS"): "r_reads"})
    return H(m)


def _ref_table(arrays, n):
    cols = {}
    for name, (kind, d, v, vocab, iflag) in arrays.items():
        cols[name] = RColumn(
            kind, jnp.asarray(d[:n]), None if v is None else jnp.asarray(v[:n]), vocab,
            int_flag=None if iflag is None else jnp.asarray(iflag[:n]),
        )
    return TpuTable(cols, n)


def _port_table(arrays, n):
    cols = {}
    for name, (kind, d, v, vocab, iflag) in arrays.items():
        cols[name] = PColumn(
            kind, torch.from_numpy(d[:n].copy()),
            None if v is None else torch.from_numpy(v[:n].copy()), vocab,
            int_flag=None if iflag is None else torch.from_numpy(iflag[:n].copy()),
        )
    return CudaTable(cols, n)


def _canon(v):
    """A value in a form that keeps int against float, -0.0 against 0.0 and
    NaN equal to NaN."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return (type(v).__name__, v)
    if isinstance(v, int):
        return ("int", v)
    if isinstance(v, float):
        return ("nan",) if v != v else ("float", struct.pack("<d", v))
    return ("other", repr(v))


def _ulps(a: float, b: float) -> int:
    if math.isnan(a) or math.isnan(b):
        return 0 if math.isnan(a) and math.isnan(b) else 1 << 62
    if a == b:
        return 0
    ia, ib = (struct.unpack("<q", struct.pack("<d", x))[0] for x in (a, b))
    if (ia < 0) != (ib < 0):
        return 1 << 62
    return abs(ia - ib)


def _p(E, key):
    T = RT if E is RE else PT
    return E.Property(E.Var("n").with_type(T.CTNode()), key)


def _v(E, T, name):
    t = T.CTRelationship() if name == "r" else T.CTNode()
    return E.Var(name).with_type(t)


# name -> (a function of (expr module, types module) making the expression,
#          compared within 4 ulp)
EXPRS = {
    # arithmetic
    "add_int": (lambda E, T: E.Add(_p(E, "i"), _p(E, "j")), False),
    "sub_int": (lambda E, T: E.Subtract(_p(E, "i"), _p(E, "k")), False),
    "mul_int": (lambda E, T: E.Multiply(_p(E, "i"), _p(E, "j")), False),
    "div_int": (lambda E, T: E.Divide(_p(E, "i"), _p(E, "j")), False),
    "mod_int": (lambda E, T: E.Modulo(_p(E, "i"), _p(E, "j")), False),
    "div_lit_zero": (lambda E, T: E.Divide(_p(E, "k"), E.Lit(0)), False),
    "mod_lit": (lambda E, T: E.Modulo(E.Lit(-7), _p(E, "j")), False),
    "neg_int": (lambda E, T: E.Neg(_p(E, "i")), False),
    "neg_float": (lambda E, T: E.Neg(_p(E, "f")), False),
    "neg_mixed": (lambda E, T: E.Neg(_p(E, "m")), False),
    "add_mixed": (lambda E, T: E.Add(_p(E, "i"), _p(E, "f")), False),
    "add_intness": (lambda E, T: E.Add(_p(E, "m"), E.Lit(1)), False),
    "sub_float": (lambda E, T: E.Subtract(_p(E, "f"), _p(E, "g")), False),
    "mul_float": (lambda E, T: E.Multiply(_p(E, "f"), _p(E, "f")), False),
    "div_float": (lambda E, T: E.Divide(_p(E, "f"), _p(E, "j")), False),
    "mod_float": (lambda E, T: E.Modulo(_p(E, "f"), _p(E, "g")), False),
    "mod_float_int": (lambda E, T: E.Modulo(_p(E, "f"), _p(E, "j")), False),
    "mod_int_float": (lambda E, T: E.Modulo(_p(E, "k"), _p(E, "f")), False),
    "pow_float": (lambda E, T: E.Pow(_p(E, "g"), E.Lit(0.5)), True),
    "pow_int": (lambda E, T: E.Pow(_p(E, "j"), _p(E, "j")), True),
    # CASE
    "case_str": (lambda E, T: E.CaseExpr(
        None, (E.LessThan(_p(E, "i"), E.Lit(0)), E.Equals(_p(E, "b"), E.Lit(True))),
        (E.Lit("neg"), _p(E, "t")), None), False),
    "case_simple_mixed": (lambda E, T: E.CaseExpr(
        _p(E, "j"), (E.Lit(0), E.Lit(1), E.Lit(2.0)),
        (_p(E, "k"), _p(E, "f"), E.Lit(7)), _p(E, "m")), False),
    "case_str_columns": (lambda E, T: E.CaseExpr(
        None, (_p(E, "b"),), (_p(E, "s"),), _p(E, "t")), False),
    "case_bool": (lambda E, T: E.CaseExpr(
        None, (E.GreaterThan(_p(E, "f"), E.Lit(0)),), (_p(E, "b"),), E.Lit(False)), False),
    "case_no_else_float": (lambda E, T: E.CaseExpr(
        None, (E.IsNull(_p(E, "i")),), (_p(E, "g"),), None), False),
    # coalesce
    "coalesce_float": (lambda E, T: E.FunctionCall("coalesce", (_p(E, "f"), _p(E, "g"))), False),
    "coalesce_mixed": (lambda E, T: E.FunctionCall(
        "coalesce", (_p(E, "j"), _p(E, "m"), _p(E, "k"))), False),
    "coalesce_str": (lambda E, T: E.FunctionCall("coalesce", (_p(E, "s"), _p(E, "t"))), False),
    "coalesce_str_lit": (lambda E, T: E.FunctionCall("coalesce", (_p(E, "t"), E.Lit("zz"))), False),
    "coalesce_bool": (lambda E, T: E.FunctionCall("coalesce", (_p(E, "b"), E.Lit(True))), False),
    "coalesce_null_lit": (lambda E, T: E.FunctionCall(
        "coalesce", (_p(E, "i"), E.Lit(None), _p(E, "k"))), False),
    "coalesce_absent": (lambda E, T: E.FunctionCall(
        "coalesce", (_p(E, "nick"), _p(E, "s"))), False),
    # the numeric functions
    "abs_int": (lambda E, T: E.FunctionCall("abs", (_p(E, "i"),)), False),
    "abs_float": (lambda E, T: E.FunctionCall("abs", (_p(E, "f"),)), False),
    "sign_int": (lambda E, T: E.FunctionCall("sign", (_p(E, "i"),)), False),
    "sign_float": (lambda E, T: E.FunctionCall("sign", (_p(E, "f"),)), False),
    "ceil": (lambda E, T: E.FunctionCall("ceil", (_p(E, "f"),)), False),
    "floor": (lambda E, T: E.FunctionCall("floor", (_p(E, "m"),)), False),
    "round": (lambda E, T: E.FunctionCall("round", (_p(E, "f"),)), False),
    "round_int": (lambda E, T: E.FunctionCall("round", (_p(E, "j"),)), False),
    "sqrt": (lambda E, T: E.FunctionCall("sqrt", (_p(E, "g"),)), False),
    "exp": (lambda E, T: E.FunctionCall("exp", (_p(E, "f"),)), True),
    "log": (lambda E, T: E.FunctionCall("log", (_p(E, "g"),)), True),
    "log10": (lambda E, T: E.FunctionCall("log10", (_p(E, "g"),)), True),
    "sin": (lambda E, T: E.FunctionCall("sin", (_p(E, "g"),)), True),
    "cos": (lambda E, T: E.FunctionCall("cos", (_p(E, "f"),)), True),
    "tan": (lambda E, T: E.FunctionCall("tan", (_p(E, "g"),)), True),
    "tofloat_int": (lambda E, T: E.FunctionCall("tofloat", (_p(E, "i"),)), False),
    "tofloat_mixed": (lambda E, T: E.FunctionCall("tofloat", (_p(E, "m"),)), False),
    "tointeger_float": (lambda E, T: E.FunctionCall("tointeger", (_p(E, "g"),)), False),
    "tointeger_int": (lambda E, T: E.FunctionCall("tointeger", (_p(E, "j"),)), False),
    "fold_pi": (lambda E, T: E.FunctionCall("pi", ()), False),
    "fold_upper": (lambda E, T: E.FunctionCall("toupper", (E.Lit("abc"),)), False),
    "fold_null": (lambda E, T: E.FunctionCall("abs", (E.Lit(None),)), False),
    # the vocab route
    "toupper": (lambda E, T: E.FunctionCall("toupper", (_p(E, "s"),)), False),
    "trim": (lambda E, T: E.FunctionCall("trim", (_p(E, "s"),)), False),
    "replace": (lambda E, T: E.FunctionCall(
        "replace", (_p(E, "s"), E.Lit("a"), E.Lit("o"))), False),
    "substring": (lambda E, T: E.FunctionCall("substring", (_p(E, "s"), E.Lit(1))), False),
    "substring_len": (lambda E, T: E.FunctionCall(
        "substring", (_p(E, "s"), E.Lit(0), E.Lit(2))), False),
    "substring_null": (lambda E, T: E.FunctionCall(
        "substring", (_p(E, "s"), E.Lit(None))), False),
    "size": (lambda E, T: E.FunctionCall("size", (_p(E, "s"),)), False),
    "tointeger_str": (lambda E, T: E.FunctionCall("tointeger", (_p(E, "s"),)), False),
    "tofloat_str": (lambda E, T: E.FunctionCall("tofloat", (_p(E, "s"),)), False),
    "exists_str": (lambda E, T: E.FunctionCall("exists", (_p(E, "s"),)), False),
    "tostring_bool": (lambda E, T: E.FunctionCall("tostring", (_p(E, "b"),)), False),
    # the distinct-value route
    "tostring_int": (lambda E, T: E.FunctionCall("tostring", (_p(E, "i"),)), False),
    "tostring_float": (lambda E, T: E.FunctionCall("tostring", (_p(E, "f"),)), False),
    "tostring_mixed": (lambda E, T: E.FunctionCall("tostring", (_p(E, "m"),)), False),
    "exists_int": (lambda E, T: E.FunctionCall("exists", (_p(E, "i"),)), False),
    "substring_by_int": (lambda E, T: E.FunctionCall(
        "substring", (E.Lit("abcdef"), _p(E, "j"))), False),
    # string predicates
    "starts_with": (lambda E, T: E.StartsWith(_p(E, "s"), E.Lit("al")), False),
    "ends_with": (lambda E, T: E.EndsWith(_p(E, "s"), E.Lit("a")), False),
    "contains": (lambda E, T: E.Contains(_p(E, "t"), E.Lit("e")), False),
    "regex": (lambda E, T: E.RegexMatch(_p(E, "s"), E.Lit("[a-z]+[0-9]*")), False),
    "starts_with_null": (lambda E, T: E.StartsWith(_p(E, "s"), E.Lit(None)), False),
    # elements
    "node_eq": (lambda E, T: E.Equals(_v(E, T, "a"), _v(E, T, "c")), False),
    "node_neq": (lambda E, T: E.Neq(_v(E, T, "c"), _v(E, T, "a")), False),
    "node_eq_rel": (lambda E, T: E.Equals(_v(E, T, "a"), _v(E, T, "r")), False),
    "node_eq_value": (lambda E, T: E.Equals(_v(E, T, "a"), _p(E, "k")), False),
    "node_is_null": (lambda E, T: E.IsNull(_v(E, T, "a")), False),
    "rel_is_not_null": (lambda E, T: E.IsNotNull(_v(E, T, "r")), False),
    "ends_eq": (lambda E, T: E.Equals(
        E.StartNode(_v(E, T, "r")), E.EndNode(_v(E, T, "r"))), False),
    "type": (lambda E, T: E.FunctionCall("type", (_v(E, T, "r"),)), False),
    "absent_property": (lambda E, T: _p(E, "nick"), False),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_reference(name):
    build, ulp = EXPRS[name]
    arrays = _arrays()
    for n in (64, 1, 0):
        want = TpuEvaluator(_ref_table(arrays, n), _header(RHeader, RE), {}).eval(build(RE, RT))
        got = CudaEvaluator(_port_table(arrays, n), _header(PHeader, PE), {}).eval(build(PE, PT))
        wv, gv = want.to_values()[:n], got.to_values()[:n]
        if any(v is not None for v in wv):
            # the kind of a column of nulls is the engine's choice
            assert got.kind == want.kind, (n, got.kind, want.kind)
        if ulp:
            assert [x is None for x in gv] == [x is None for x in wv]
            for x, y in zip(wv, gv):
                if x is not None:
                    assert type(x) is type(y) and _ulps(x, y) <= 4, (n, x, y)
        else:
            assert [_canon(x) for x in gv] == [_canon(x) for x in wv], n


def test_to_integer_of_nan_or_inf_raises_as_the_oracle():
    """XLA casts NaN to 0 and saturates infinities; the port raises the
    local oracle's own error, and refuses a finite value beyond int64."""
    from tpu_cypher_torch.ir.functions import lookup

    for bad, err in ((math.nan, ValueError), (math.inf, OverflowError)):
        t = CudaTable({"f": PColumn("f64", torch.tensor([1.5, bad], dtype=torch.float64), None)}, 2)
        expr = PE.FunctionCall("tointeger", (_p(PE, "f"),))
        with pytest.raises(err):
            lookup("tointeger").fn(bad)
        with pytest.raises(err):
            CudaEvaluator(t, PHeader({_p(PE, "f"): "f"}), {}).eval(expr)
    t = CudaTable({"f": PColumn("f64", torch.tensor([1e300], dtype=torch.float64), None)}, 1)
    with pytest.raises(TpuUnsupportedExpr, match="beyond int64"):
        CudaEvaluator(t, PHeader({_p(PE, "f"): "f"}), {}).eval(expr)


def test_float_modulo_is_exact_where_the_quotient_overflows():
    """``1e308 % 1e-308``: the port gives IEEE fmod's exact remainder, as the
    local oracle's ``math.fmod`` does (the reference's XLA program gives
    NaN there)."""
    a, b = [1e308, -1e308, 7.5e17], [1e-308, 3e-300, 0.3]
    t = CudaTable({"f": PColumn("f64", torch.tensor(a, dtype=torch.float64), None),
                   "g": PColumn("f64", torch.tensor(b, dtype=torch.float64), None)}, 3)
    header = PHeader({_p(PE, "f"): "f", _p(PE, "g"): "g"})
    got = CudaEvaluator(t, header, {}).eval(PE.Modulo(_p(PE, "f"), _p(PE, "g")))
    assert [_canon(v) for v in got.to_values()] == [
        _canon(math.fmod(x, y)) for x, y in zip(a, b)]


def test_rand_draws_per_row_in_unit_interval():
    n = 5000
    t = CudaTable({"x": PColumn("i64", torch.zeros(n, dtype=torch.int64), None)}, n)
    col = CudaEvaluator(t, PHeader({}), {}).eval(PE.FunctionCall("rand", ()))
    assert col.kind == "f64" and col.valid is None and col.data.shape == (n,)
    assert bool(((col.data >= 0) & (col.data < 1)).all())
    assert len(torch.unique(col.data)) > n - 5
    again = CudaEvaluator(t, PHeader({}), {}).eval(PE.FunctionCall("rand", ()))
    assert not torch.equal(col.data, again.data)
    assert PDEV.generator(torch.device("cpu")) is PDEV.generator(torch.device("cpu"))


def _lst(E, *keys):
    return E.ListLit(tuple(_p(E, k) for k in keys))


def _x(E):
    return E.Var("x")


# name -> a function of (expr module, types module) making a list, map or
# element expression; the first six were refusals naming item 6.3
LIST_EXPRS = {
    "labels": lambda E, T: E.FunctionCall("labels", (_v(E, T, "a"),)),
    "case_of_element": lambda E, T: E.CaseExpr(None, (_p(E, "b"),), (_v(E, T, "a"),), None),
    "coalesce_of_element": lambda E, T: E.FunctionCall(
        "coalesce", (_v(E, T, "a"), _v(E, T, "c"))),
    "split": lambda E, T: E.FunctionCall("split", (_p(E, "s"), E.Lit(" "))),
    "range_constant": lambda E, T: E.FunctionCall("range", (E.Lit(1), E.Lit(3))),
    "concatenation": lambda E, T: E.Add(_p(E, "s"), E.Lit("!")),
    "concat_columns": lambda E, T: E.Add(_p(E, "s"), _p(E, "t")),
    "concat_int": lambda E, T: E.Add(_p(E, "t"), _p(E, "i")),
    "concat_float": lambda E, T: E.Add(_p(E, "f"), _p(E, "s")),
    "concat_mixed": lambda E, T: E.Add(_p(E, "m"), _p(E, "t")),
    "concat_bool": lambda E, T: E.Add(_p(E, "s"), _p(E, "b")),
    "list_ints": lambda E, T: _lst(E, "i", "j", "k"),
    "list_numbers": lambda E, T: _lst(E, "j", "f", "m"),
    "list_strings": lambda E, T: E.ListLit((_p(E, "s"), _p(E, "t"), E.Lit("x"))),
    "list_elements": lambda E, T: E.ListLit((_v(E, T, "a"), _v(E, T, "c"))),
    "list_relationship": lambda E, T: E.ListLit((_v(E, T, "r"),)),
    "index": lambda E, T: E.Index(_lst(E, "i", "j", "k"), _p(E, "j")),
    "index_negative": lambda E, T: E.Index(_lst(E, "s", "t"), E.Lit(-1)),
    "slice": lambda E, T: E.ListSlice(_lst(E, "i", "j", "k"), E.Lit(1), None),
    "slice_columns": lambda E, T: E.ListSlice(_lst(E, "j", "k", "g"), _p(E, "j"),
                                              E.Lit(-1)),
    "size": lambda E, T: E.FunctionCall("size", (_lst(E, "i", "j"),)),
    "head": lambda E, T: E.FunctionCall("head", (_lst(E, "s", "t"),)),
    "last": lambda E, T: E.FunctionCall("last", (_lst(E, "j", "f"),)),
    "tail": lambda E, T: E.FunctionCall("tail", (_lst(E, "t", "s"),)),
    "reverse": lambda E, T: E.FunctionCall("reverse", (_lst(E, "i", "j", "k"),)),
    "in_list": lambda E, T: E.In(_p(E, "j"), _lst(E, "i", "k")),
    "in_list_null": lambda E, T: E.In(_p(E, "j"), E.ListLit((_p(E, "i"), E.Lit(None)))),
    "in_list_strings": lambda E, T: E.In(_p(E, "s"), _lst(E, "t")),
    "in_split": lambda E, T: E.In(E.Lit("b"), E.FunctionCall("split", (_p(E, "s"), E.Lit(" ")))),
    "comprehension": lambda E, T: E.ListComprehension(
        _x(E), _lst(E, "j", "k"), E.GreaterThan(_x(E), E.Lit(0)),
        E.Multiply(_x(E), E.Lit(2))),
    "comprehension_outer": lambda E, T: E.ListComprehension(
        _x(E), E.FunctionCall("range", (E.Lit(0), _p(E, "j"))), None,
        E.Add(_x(E), _p(E, "k"))),
    "any": lambda E, T: E.Quantified("any", _x(E), _lst(E, "i", "j"),
                                     E.GreaterThan(_x(E), E.Lit(0))),
    "all": lambda E, T: E.Quantified("all", _x(E), _lst(E, "j", "k"),
                                     E.GreaterThan(_x(E), E.Lit(-2))),
    "none": lambda E, T: E.Quantified("none", _x(E), _lst(E, "j", "i"),
                                      E.Equals(_x(E), E.Lit(0))),
    "single": lambda E, T: E.Quantified("single", _x(E), _lst(E, "j", "k", "i"),
                                        E.LessThan(_x(E), E.Lit(1))),
    "range_columns": lambda E, T: E.FunctionCall("range", (_p(E, "j"), E.Lit(3))),
    "range_step": lambda E, T: E.FunctionCall("range", (E.Lit(3), _p(E, "j"), E.Lit(-2))),
    "map": lambda E, T: E.MapLit(("a", "b"), (_p(E, "i"), _p(E, "s"))),
    "map_index": lambda E, T: E.Index(E.MapLit(("a",), (_p(E, "t"),)), E.Lit("a")),
    "map_keys": lambda E, T: E.FunctionCall("keys", (E.MapLit(("z", "a"), (_p(E, "i"), E.Lit(1))),)),
    "add_lists": lambda E, T: E.Add(_lst(E, "i"), _lst(E, "j", "k")),
    "add_value": lambda E, T: E.Add(_lst(E, "j"), _p(E, "k")),
    "value_add": lambda E, T: E.Add(_p(E, "k"), _lst(E, "j")),
}


def _deep(v):
    """``_canon`` through lists and maps."""
    if isinstance(v, (list, tuple)):
        return ("list", tuple(_deep(x) for x in v))
    if isinstance(v, dict):
        return (type(v).__name__, tuple((k, _deep(x)) for k, x in v.items()))
    return _canon(v)


@pytest.mark.parametrize("name", sorted(LIST_EXPRS))
def test_list_expression_matches_reference(name):
    """The port's device columns against the reference's host island, at
    64 rows, one and none; every value in order."""
    build = LIST_EXPRS[name]
    arrays = _arrays()
    for n in (64, 1, 0):
        want = TpuEvaluator(_ref_table(arrays, n), _header(RHeader, RE), {}).eval(build(RE, RT))
        got = CudaEvaluator(_port_table(arrays, n), _header(PHeader, PE), {}).eval(build(PE, PT))
        assert got.kind != "obj", name
        wv, gv = want.to_values()[:n], got.to_values()[:n]
        assert [_deep(x) for x in gv] == [_deep(x) for x in wv], n


def test_comprehension_keeps_int64_exact():
    """Inside a comprehension the port computes integers as its device path
    does everywhere (and as the reference's device path does outside
    lists, ``mod_int`` above): ``INT64_MAX % 7`` is exactly 0. The
    reference answers a comprehension on its host island, whose
    ``int(math.fmod(...))`` rounds through a float and gives 1."""
    t = CudaTable({"i": PColumn("i64", torch.tensor([I64_MAX], dtype=torch.int64), None)}, 1)
    expr = PE.ListComprehension(PE.Var("x"), PE.ListLit((_p(PE, "i"),)), None,
                                PE.Modulo(PE.Var("x"), PE.Lit(7)))
    got = CudaEvaluator(t, PHeader({_p(PE, "i"): "i"}), {}).eval(expr).to_values()
    assert got == [[0]] and I64_MAX % 7 == 0


# name -> (a function of (expr module, types module) making the expression,
#          a part of the error message, or None where the port answers)
REFUSALS = {
    # what item 6.3 left to item 6.4 (the rest of the list surface) and the
    # expression compiler declined: each answers as the reference does now
    "element_value": (lambda E, T: E.FunctionCall("nodes", (_v(E, T, "a"),)), None),
    "case_of_element": (lambda E, T: E.CaseExpr(
        None, (_p(E, "b"),), (_v(E, T, "a"),), E.ListLit((E.Lit(1),))), None),
    "coalesce_of_element": (lambda E, T: E.FunctionCall(
        "coalesce", (_v(E, T, "a"), _v(E, T, "r"))), None),
    "list_result": (lambda E, T: E.ListLit(
        (E.FunctionCall("split", (_p(E, "s"), E.Lit(" "))),)), None),
    "list_constant": (lambda E, T: E.ListLit((E.Lit(1), E.ListLit((E.Lit(2),)))), None),
    "random_uuid": (lambda E, T: E.FunctionCall("randomuuid", ()), "randomUUID"),
    "two_live_arguments": (lambda E, T: E.FunctionCall(
        "left", (_p(E, "s"), _p(E, "j"))), None),
    "pattern_not_constant": (lambda E, T: E.StartsWith(_p(E, "s"), _p(E, "t")), None),
    "case_kinds": (lambda E, T: E.CaseExpr(
        None, (_p(E, "b"),), (_p(E, "s"),), _p(E, "k")), None),
    "coalesce_kinds": (lambda E, T: E.FunctionCall(
        "coalesce", (_p(E, "b"), _p(E, "f"))), None),
    "concatenation": (lambda E, T: E.Add(E.ListLit((_p(E, "s"),)), E.ListLit((_p(E, "j"),))),
                      None),
    "reduce": (lambda E, T: E.Reduce(E.Var("acc"), E.Lit(0), E.Var("x"),
                                     E.ListLit((_p(E, "j"),)), E.Var("x")), None),
    "list_equality": (lambda E, T: E.Equals(E.ListLit((_p(E, "j"),)),
                                            E.ListLit((_p(E, "k"),))), None),
    "map_projection_all": (lambda E, T: E.MapProjection(_v(E, T, "a"), (), True), None),
    "inexact_promotion": (lambda E, T: E.FunctionCall(
        "coalesce", (_p(E, "i"), _p(E, "f"))), "beyond 2\\*\\*53"),
}


def _dated(table, header, Col, E, n=64):
    """``table`` and ``header`` with a date column ``d`` (nulls included)."""
    import datetime

    dates = Col.from_values([datetime.date(2020, 1, d % 28 + 1) if d % 5 else None
                             for d in range(n)])
    return type(table)({**table._cols, "d": dates}, n), header.with_expr(_p(E, "d"), "d")


def _values_or_error(build):
    try:
        return [_deep(v) for v in build().to_values()]
    except Exception as exc:  # the error class is the answer
        return type(exc).__name__


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusal_names_its_item(name):
    """What the port still refuses names its ROADMAP.md item (or says why);
    what it once refused and now answers (every item 6.4 case) answers as
    the reference's ``TpuEvaluator`` does, its host island included, at
    64 rows, one and none, or raises the reference's error."""
    build, msg = REFUSALS[name]
    if msg is not None:
        table, header = _dated(_port_table(_arrays(), 64), _header(PHeader, PE), PColumn, PE)
        with pytest.raises(TpuUnsupportedExpr, match=msg):
            CudaEvaluator(table, header, {}).eval(build(PE, PT))
        return
    from tpu_cypher_torch.backend.local.eval import Evaluator
    from tpu_cypher_torch.backend.local.table import LocalTable

    for n in (64, 1, 0):
        pt, ph = _dated(_port_table(_arrays(), n), _header(PHeader, PE), PColumn, PE, n)
        rt, rh = _dated(_ref_table(_arrays(), n), _header(RHeader, RE), RColumn, RE, n)
        got = _values_or_error(lambda: CudaEvaluator(pt, ph, {}).eval(build(PE, PT)))
        local = LocalTable({c: col.to_values() for c, col in pt._cols.items()}, n)
        oracle = _values_or_error(lambda: PColumn.from_values(
            Evaluator(local, ph, {}).evaluate(build(PE, PT))))
        assert got == oracle, (name, n)
        want = _values_or_error(lambda: TpuEvaluator(rt, rh, {}).eval(build(RE, RT)))
        if not isinstance(want, str) or name != "case_of_element":
            # the reference's island fails on a list default beside a node
            # (jnp.where over host objects); its oracle answers
            assert got == want, (name, n)


# the temporal shapes the port refused until it held temporal columns:
# each answers as the reference's TpuEvaluator does, or raises its error
TEMPORAL_CASES = {
    "temporal_arithmetic": lambda E: E.Add(_p(E, "d"), _p(E, "d")),
    "temporal_function": lambda E: E.FunctionCall(
        "date.truncate", (E.Lit("month"), _p(E, "d"))),
    "temporal_constant": lambda E: E.FunctionCall("date", (E.Lit("2020-01-02"),)),
    "temporal_accessor": lambda E: E.Property(_p(E, "d"), "year"),
}


@pytest.mark.parametrize("name", sorted(TEMPORAL_CASES))
def test_temporal_former_refusal(name):
    build = TEMPORAL_CASES[name]
    arrays = _arrays()
    rt, rh = _dated(_ref_table(arrays, 64), _header(RHeader, RE), RColumn, RE)
    pt, ph = _dated(_port_table(arrays, 64), _header(PHeader, PE), PColumn, PE)
    try:
        want = TpuEvaluator(rt, rh, {}).eval(build(RE))
    except Exception as exc:  # the reference raises: the port raises the same
        with pytest.raises(Exception) as got:
            CudaEvaluator(pt, ph, {}).eval(build(PE))
        assert (type(got.value).__name__, str(got.value)) == (type(exc).__name__, str(exc))
        return
    got = CudaEvaluator(pt, ph, {}).eval(build(PE))
    assert got.kind == want.kind
    assert got.to_values()[:64] == want.to_values()[:64]


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

# the queries of tests/test_tpu_backend.py without list values that no
# other port test runs, then more of this slice's expressions
QUERIES = [
    "MATCH (n) RETURN count(*) AS n",
    "MATCH (a:Person) RETURN a.name, a.age",
    "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) RETURN a.name",
    "MATCH (a:Person) WHERE a.age > 26 AND a.score IS NOT NULL RETURN a.name",
    "MATCH (a:Person) RETURN a.age + 1 AS inc, a.age * 2 AS dbl, a.age % 10 AS m",
    "MATCH (a:Person) WHERE (a)-[:READS]->() RETURN a.name",
    "MATCH (a:Person) RETURN count(*) AS n, sum(a.age) AS s, avg(a.age) AS m",
    "MATCH (p:Person) RETURN CASE WHEN p.age < 30 THEN 'young' ELSE 'old' END AS bucket",
    "MATCH (p:Person) RETURN coalesce(p.score, 0.0) AS s",
    "MATCH (p:Person) WHERE p.age IN [23, 55] RETURN p.name",
    "MATCH (p:Person) WHERE p.name STARTS WITH 'A' RETURN p",
    "MATCH (a:Person) RETURN min(a.name) AS first, max(a.name) AS last",
    "MATCH (a:Person) RETURN min(a.score) AS lo, max(a.score) AS hi, sum(a.score) AS s, "
    "avg(a.score) AS m",
    "MATCH (b:Book) WHERE b.title = 'nope' RETURN count(*) AS c, sum(1) AS s, min(1) AS lo",
    "MATCH (a:Person) RETURN count(a.score) AS with_score, count(*) AS all_rows",
    "MATCH (p:Person) RETURN min(p.age > 30) AS b",
    "MATCH (a:Person)-[r:KNOWS]->(b:Person {name:'Carol'}) RETURN a.name, r.since",
    "MATCH (a)-[r]-(b) RETURN count(*) AS c",
    "MATCH (a)-[x]->(b)-[y]->(c) WHERE a.name = 'Alice' RETURN b.name, c.name",
    "MATCH (a:Person)-[k1:KNOWS]-(b)-[k2:KNOWS]-(c) RETURN count(*) AS z",
    "MATCH (b:Book) OPTIONAL MATCH (p:Person {name:'Nobody'}) RETURN b.title, p.name",
    "MATCH (a:Person) RETURN stDev(a.age) AS sd, stDevP(a.age) AS sdp",
    # this slice
    "MATCH (a:Person) RETURN -a.age AS n, a.age / 7 AS d, a.age ^ 2 AS p, "
    "abs(a.age - 40) AS ab, sqrt(a.age) AS s",
    "MATCH (p:Person) RETURN coalesce(p.nick, p.name) AS s, toUpper(p.name) AS u, "
    "size(p.name) AS z, toString(p.age) AS t",
    "MATCH (p:Person) WHERE p.name =~ 'B.*' RETURN p.name AS n",
    "MATCH (a)-[r]->(b) RETURN type(r) AS t, count(*) AS c",
    "MATCH (a:Person) OPTIONAL MATCH (a)-[r:READS]->(y) RETURN a.name, type(r) AS t",
    "MATCH (a:Person), (b:Person) WHERE a <> b RETURN count(*) AS c",
    "MATCH (a:Person), (b:Person) WHERE a = b AND a.age > 30 RETURN a.name, b.name",
    "MATCH (a:Person)-[r]->(b), (c)-[s]->(d) WHERE r = s RETURN count(*) AS c",
    "MATCH (a:Person) OPTIONAL MATCH (a)-[:READS]->(x) RETURN a.name, x IS NULL AS n",
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN count(DISTINCT a) AS n, count(DISTINCT b) AS m",
    "MATCH (a)-[r]->(b) RETURN startNode(r) = endNode(r) AS loop, count(startNode(r)) AS c",
    "MATCH (a:Person) RETURN CASE a.age WHEN 23 THEN 1 WHEN 42 THEN 2.5 END AS c, "
    "a.name ENDS WITH 'e' AS e, exists(a.score) AS x",
    "MATCH (x:Nope) RETURN x.v",
]


def _records(result):
    return Counter(tuple((c, _canon(v)) for c, v in sorted(dict(r).items()))
                   for r in result.records.collect())


def _check_three(port, ref, local, query, params=None):
    got = _records(port.cypher(query, params))
    assert got == _records(ref.cypher(query, params)), query
    assert got == _records(local.cypher(query, params)), query
    return got


@pytest.fixture(scope="module")
def create_engines():
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(CREATE),
        R.CypherSession.tpu().create_graph_from_create_query(CREATE),
        R.CypherSession.local().create_graph_from_create_query(CREATE),
    )


@pytest.mark.parametrize("query", QUERIES)
def test_backend_queries_across_engines(create_engines, query):
    _check_three(*create_engines, query)


@pytest.mark.parametrize("query,what", [
    ("MATCH (a:Person) RETURN collect(a) AS c", None),
    ("MATCH (a:Person) RETURN CASE WHEN a.age > 30 THEN a END AS x", None),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN coalesce(a, b) AS x", None),
    ("MATCH p = (a:Person)-[:KNOWS]->(b) RETURN count(p) AS c", "path variable p"),
])
def test_element_as_value_raises(create_engines, query, what):
    """An element as a value (it raised, naming item 6.3, before the port's
    STRUCT columns) answers as the reference and the oracle do; so does a
    path (``what``; it raised, naming item 6.4, before the port's path
    STRUCT)."""
    assert sum(_check_three(*create_engines, query).values()) > 0


def test_rand_query_in_unit_interval(create_engines):
    rows = create_engines[0].cypher("MATCH (a:Person) RETURN rand() AS r").records.collect()
    assert len(rows) == 3 and all(0 <= r["r"] < 1 for r in rows)


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


@pytest.mark.parametrize("qname", ["Q27", "Q28", "Q29", "Q30"])
def test_chip_smoke_expression_queries(snb_engines, qname):
    """chip_smoke.py's Q27-Q30 across the engines, with the kernels each
    runs (CPU tier: ``plain``)."""
    PD.reset()
    got = _check_three(*snb_engines, getattr(CS, qname))
    assert sum(got.values()) > 0
    for name in CS.EXPR_KERNELS[qname]:
        assert PD.use_counts()[name]["plain"] > 0, (qname, name)


# ---------------------------------------------------------------------------
# null and wrong-kind operands, and the oracle's errors (ROADMAP.md §3)
# ---------------------------------------------------------------------------

# the queries of the twenty TCK scenarios the port refused (TernaryLogic*,
# NullAcceptance, NullSemantics, MapAndProperties, CaseAndStrings,
# StartsWithAcceptance, OptionalMatchTck), and a label absent from the graph
NULL_OPERANDS = [
    ("", "WITH null AS s RETURN s STARTS WITH 'a' AS sw, 'abc' CONTAINS s AS c"),
    ("", "WITH null AS m RETURN m.anything AS v"),
    ("", "RETURN (null AND false) AS af, (null AND true) AS at, (null OR true) AS ot, "
         "(null OR false) AS of"),
    ("", "RETURN NOT null AS x"),
    ("", "RETURN (true AND null) AS a, (false AND null) AS b, (null AND null) AS c, "
         "(true AND true) AS d, (true AND false) AS e"),
    ("", "RETURN (true OR null) AS a, (false OR null) AS b, (null OR null) AS c, "
         "(false OR false) AS d"),
    ("", "RETURN (NOT null) AS a, (true XOR null) AS b, (true XOR true) AS c, "
         "(true XOR false) AS d"),
    ("", "RETURN (null XOR true) AS a, (null XOR false) AS b, (null XOR null) AS c"),
    ("", "RETURN NOT null AS a, NOT true AS b, NOT false AS c"),
    ("", "RETURN CASE WHEN null THEN 'yes' ELSE 'no' END AS x"),
    ("CREATE (s:Single), (a:A {num: 42}), (s)-[:REL]->(a)",
     "MATCH (n:Single) OPTIONAL MATCH (n)-[r]-(m) WHERE m:NonExistent RETURN r"),
    ("CREATE (:T {v: 1})",
     "MATCH (t:T) RETURN t.v STARTS WITH 'a' AS a, 1 CONTAINS 'a' AS b, "
     "true ENDS WITH 'a' AS c"),
    ("CREATE (:T {v: 1}), (:U)", "MATCH (n) WHERE n:Nope RETURN n"),
    ("CREATE (:T {v: 1}), (:U)", "MATCH (n) RETURN n:Nope AS x, n.v AS v"),
]

# the TCK's error scenarios the port refused before it raised the oracle's
# class (SemanticErrors, SyntaxErrors)
SEMANTIC_ERRORS = [
    ("", "RETURN true + 1 AS x", "CypherTypeError"),
    ("CREATE (:E {s: 'abc'})", "MATCH (e:E) RETURN -e.s AS x", "CypherTypeError"),
    ("CREATE (:E {v: 5})", "MATCH (e:E) RETURN e.v.year AS x", "CypherTypeError"),
    ("CREATE (:E {v: 1}), (:E {v: 2})",
     "MATCH (e:E) RETURN percentileCont(e.v, 1.5) AS p", "CypherTypeError"),
    ("CREATE (:E {v: 42})", "MATCH (e:E) RETURN e.v[0] AS x", "CypherTypeError"),
    ("CREATE (:E {v: 42})", "MATCH (n) WHERE count(n) > 0 RETURN n", "EvalError"),
    ("CREATE (:E {v: 42})", "MATCH (n) WHERE count(n) > 1 RETURN n", "EvalError"),
]


def _engines_for(create, cache={}):
    """The port, ``tpu()`` and ``local()`` over one CREATE graph (the
    empty graph for ``""``), built once per text."""
    from tpu_cypher.relational.graphs import EmptyGraph as RefEmptyGraph
    from tpu_cypher_torch.relational.graphs import EmptyGraph

    if create not in cache:
        sessions = (CypherSession.cuda(device="cpu"), R.CypherSession.tpu(),
                    R.CypherSession.local())
        if create:
            cache[create] = tuple(s.create_graph_from_create_query(create) for s in sessions)
        else:
            cache[create] = (PropertyGraph(sessions[0], EmptyGraph()),
                             RefPropertyGraph(sessions[1], RefEmptyGraph()),
                             RefPropertyGraph(sessions[2], RefEmptyGraph()))
    return cache[create]


@pytest.mark.parametrize("create,query", NULL_OPERANDS)
def test_null_and_wrong_kind_operands(create, query):
    """A null operand answers as a null of the kind its operator needs, a
    string predicate over a non-string is null, an absent label is false:
    bag-identical to ``tpu()`` and ``local()``, all on the device."""
    _check_three(*_engines_for(create), query)


@pytest.mark.parametrize("create,query,error", SEMANTIC_ERRORS)
def test_semantic_errors_raise_the_oracles_class(create, query, error):
    """Where the oracle raises on the operands' kinds (or, for a
    percentile's fraction, on its value), the port raises the oracle's
    class, never a refusal."""
    port, _, local = _engines_for(create)
    with pytest.raises(Exception) as want:
        local.cypher(query).records.collect()
    with pytest.raises(Exception) as got:
        port.cypher(query).records.collect()
    assert want.type.__name__ == got.type.__name__ == error
    assert not isinstance(got.value, TpuUnsupportedExpr)
