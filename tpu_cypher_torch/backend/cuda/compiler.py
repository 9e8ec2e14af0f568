"""Expr -> torch evaluator over device columns.

The port of ``tpu_cypher/backend/tpu/compiler.py``. Every expression
becomes eager torch ops over ``Column``s on the column's device, with
(data, valid) null masks and three-valued logic on booleans:

* header-resident columns (properties, ids, label and type flags the scans
  materialized), literals, parameters and graph-tag prefixes;
* the predicates: ``NOT``/``AND``/``OR``/``XOR``, ``=``/``<>``, the four
  ordered comparisons, ``IN`` over a literal list, null tests and the
  string predicates (``STARTS WITH``, ``ENDS WITH``, ``CONTAINS``, ``=~``
  with a constant pattern);
* numeric arithmetic, ``CASE`` (simple and searched) and ``coalesce``;
* functions: constant calls fold once through ``ir/functions.py``; the
  numeric functions run as torch ops; any other registry function whose
  one non-constant argument is a column runs its scalar ``fn`` once per
  vocab entry (a STR column) or once per distinct value (I64, F64, BOOL,
  found by ``torch.unique`` on the device), and one gather maps the rows;
  ``rand()`` draws per row from the device's generator and ``type(r)``
  comes from the header's type flags;
* elements where only their identity decides the result (``identity``):
  ``count(a)``, ``count(DISTINCT a)``, ``=``/``<>`` and ``IS [NOT] NULL``
  read the element's id column. A property key the header holds no column
  for is null.

No row is ever evaluated in Python. What the port cannot compile raises
``TpuUnsupportedExpr``: where the reference evaluates it as a host island
on its local oracle, the port keeps no island (ROADMAP.md §3). Element,
path, list and map values and string concatenation come with ROADMAP.md
queue 1, item 6.3, and temporal operands with item 7. The reference's jit
cache of whole expressions has no counterpart: eager PyTorch compiles
nothing to cache.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...api.values import Duration
from ...ir import expr as E
from . import device as _device
from .column import (
    BOOL,
    F64,
    I64,
    OBJ,
    STR,
    Column,
    TpuBackendError,
    _NULL_CODE,
    _remap,
    _unify_vocab,
    constant_column,
    to_host,
)

_LISTS_ITEM = "ROADMAP.md queue 1, item 6.3"
_TEMPORAL_ITEM = "ROADMAP.md queue 1, item 7"
_NUMERIC_FUNCTIONS = frozenset({
    "abs", "sign", "tofloat", "tointeger", "ceil", "floor", "round", "sqrt",
    "exp", "log", "log10", "sin", "cos", "tan",
})
_NOT_CONST = object()


class TpuUnsupportedExpr(TpuBackendError):
    pass


def _obj_item(*cols: Column) -> str:
    """The ROADMAP item that brings these object columns' values to the
    device: temporal values item 7, lists, maps and elements item 6.3."""
    for c in cols:
        if c.kind != OBJ:
            continue
        for v in c.data:
            if isinstance(v, (_dt.date, _dt.time, Duration)):
                return _TEMPORAL_ITEM
    return _LISTS_ITEM


class CudaEvaluator:
    def __init__(self, table, header, parameters: Dict[str, Any]):
        self.table = table
        self.header = header
        self.params = parameters or {}
        self.n = table.size

    def eval(self, expr: E.Expr) -> Column:
        col = self.header.get(expr) if self.header is not None else None
        if col is not None and col in self.table._cols:
            return self.table._cols[col]
        if isinstance(expr, E.Lit):
            return constant_column(expr.value, self.n)
        if isinstance(expr, E.Param):
            return constant_column(self.params.get(expr.name), self.n)
        if isinstance(expr, E.Var):
            what = "path" if self._is_path(expr) else "element"
            raise TpuUnsupportedExpr(
                f"{what} variable {expr.name} as a value: {_LISTS_ITEM}"
            )
        if isinstance(expr, E.PrefixId):
            inner = self.eval(expr.expr)
            if inner.kind != I64:
                raise TpuUnsupportedExpr("prefix on non-id column")
            return Column(I64, inner.data | (int(expr.tag) << 54), inner.valid)
        if isinstance(expr, E.IsNull):
            return Column(BOOL, ~self.identity(expr.expr).valid_mask(), None)
        if isinstance(expr, E.IsNotNull):
            return Column(BOOL, self.identity(expr.expr).valid_mask(), None)
        if isinstance(expr, E.Not):
            inner = self._as_bool(self.eval(expr.expr))
            return Column(BOOL, ~inner.data, inner.valid)
        if isinstance(expr, E.Ands):
            return self._connective(expr.exprs, is_and=True)
        if isinstance(expr, E.Ors):
            return self._connective(expr.exprs, is_and=False)
        if isinstance(expr, E.Xor):
            l = self._as_bool(self.eval(expr.lhs))
            r = self._as_bool(self.eval(expr.rhs))
            return Column(BOOL, l.data ^ r.data, _and_valid(l, r))
        if isinstance(expr, (E.Equals, E.Neq)):
            return self._equality(expr)
        if isinstance(
            expr, (E.LessThan, E.LessThanOrEqual, E.GreaterThan, E.GreaterThanOrEqual)
        ):
            return self._comparison(expr)
        if isinstance(expr, E.In):
            return self._in(expr)
        if isinstance(expr, E.Neg):
            inner = self.eval(expr.expr)
            if inner.kind == OBJ:
                raise TpuUnsupportedExpr(f"negate object values: {_obj_item(inner)}")
            if inner.kind not in (I64, F64):
                raise TpuUnsupportedExpr("negate non-numeric")
            return Column(inner.kind, -inner.data, inner.valid)
        if isinstance(expr, E.ArithmeticExpr):
            return self._arith(expr)
        if isinstance(expr, E.CaseExpr):
            return self._case(expr)
        if isinstance(expr, E.FunctionCall):
            return self._function(expr)
        if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains, E.RegexMatch)):
            return self._string_predicate(expr)
        if isinstance(expr, E.Property):
            return self._property(expr)
        raise TpuUnsupportedExpr(type(expr).__name__)

    # -- elements -------------------------------------------------------------

    def _is_path(self, v: E.Var) -> bool:
        return self.header is not None and self.header.has_path(v.name)

    def _element(self, expr: E.Expr) -> Optional[Tuple[str, Column]]:
        """("node" or "relationship", id column) when ``expr`` is an element
        variable whose id column the table holds; else None."""
        if not isinstance(expr, E.Var) or self.header is None or self._is_path(expr):
            return None
        owned = self.header.expressions_for(expr)
        ids = [self.header.get(e) for e in owned if isinstance(e, E.Id)]
        if not ids or ids[0] not in self.table._cols:
            return None
        rel = any(isinstance(e, E.StartNode) for e in owned)
        return ("relationship" if rel else "node"), self.table._cols[ids[0]]

    def identity(self, expr: E.Expr) -> Column:
        """``expr`` where only its identity decides the result (``count``,
        ``count(DISTINCT ...)``, ``=``/``<>``, ``IS [NOT] NULL``): an
        element variable is its id column with its validity; every other
        expression evaluates as a value."""
        got = self._element(expr)
        return got[1] if got is not None else self.eval(expr)

    def _property(self, expr: E.Property) -> Column:
        """A property the header maps is read before this is reached. Of an
        element whose header holds no column for the key (a label or type
        the schema lacks) it is null; any other property access raises."""
        owner = expr.expr
        if self._element(owner) is not None:
            if not any(
                isinstance(e, E.Property) and e.key == expr.key
                for e in self.header.expressions_for(owner)
            ):
                return constant_column(None, self.n)
            raise TpuUnsupportedExpr(f"property {expr.key} of {owner.name} unmapped")
        inner = self.eval(owner)
        if inner.kind == OBJ:
            raise TpuUnsupportedExpr(f"property access on object values: {_obj_item(inner)}")
        raise TpuUnsupportedExpr(f"property access on {inner.kind}")

    def _rel_type(self, arg: E.Expr) -> Optional[Column]:
        """``type(r)`` from the header's ``HasType`` flags: one STR column
        whose vocab is the type names, sorted, its codes chosen on the
        device. None when ``arg`` is not a relationship variable."""
        got = self._element(arg)
        if got is None or got[0] != "relationship":
            return None
        flags = self.header.types_for(arg)
        dev = got[1].data.device
        codes = torch.full((self.n,), int(_NULL_CODE), dtype=torch.int32, device=dev)
        for code, flag in enumerate(flags):
            c = self.table._cols.get(self.header.get(flag))
            if c is None:
                raise TpuUnsupportedExpr(f"type({arg.name}): flag {flag.rel_type} unmapped")
            codes = torch.where(c.data & c.valid_mask(), code, codes)
        valid = got[1].valid
        return Column(STR, codes, valid, [f.rel_type for f in flags])

    # -- predicates ---------------------------------------------------------

    def _falses(self) -> torch.Tensor:
        return torch.zeros(self.n, dtype=torch.bool, device=_device.get())

    def _as_bool(self, c: Column) -> Column:
        if c.kind != BOOL:
            raise TpuUnsupportedExpr(f"expected boolean, got {c.kind}")
        return c

    def _connective(self, exprs, is_and: bool) -> Column:
        """Three-valued AND/OR: a null operand leaves the result null
        unless another operand decides it (false for AND, true for OR)."""
        cols = [self._as_bool(self.eval(e)) for e in exprs]
        vals = [c.data for c in cols]
        valids = [c.valid_mask() for c in cols]
        if is_and:
            # false if any (valid & ~val); true if all (valid & val)
            any_false = self._falses()
            all_true = ~any_false
            for v, m in zip(vals, valids):
                any_false = any_false | (m & ~v)
                all_true = all_true & (m & v)
            return Column(BOOL, all_true, any_false | all_true)
        any_true = self._falses()
        all_false = ~any_true
        for v, m in zip(vals, valids):
            any_true = any_true | (m & v)
            all_false = all_false & (m & ~v)
        return Column(BOOL, any_true, any_true | all_false)

    def _coerce_pair(self, l: Column, r: Column):
        if l.kind == r.kind:
            if l.kind == STR:
                return _unify_vocab(l, r)
            return l, r
        if {l.kind, r.kind} == {I64, F64}:
            return l.cast_f64(), r.cast_f64()
        raise TpuUnsupportedExpr(f"compare {l.kind} vs {r.kind}")

    def _equality(self, expr) -> Column:
        le, re_ = self._element(expr.lhs), self._element(expr.rhs)
        if le is not None or re_ is not None:
            # elements are equal by id; an element equals no value of any
            # other kind (as in the local oracle's ``cypher_equals``)
            l = le[1] if le is not None else self.eval(expr.lhs)
            r = re_[1] if re_ is not None else self.eval(expr.rhs)
            same = le is not None and re_ is not None and le[0] == re_[0]
            eq = l.data == r.data if same else self._falses()
        else:
            l, r = self.eval(expr.lhs), self.eval(expr.rhs)
            if OBJ in (l.kind, r.kind):
                raise TpuUnsupportedExpr(f"equality on object values: {_obj_item(l, r)}")
            try:
                l, r = self._coerce_pair(l, r)
                eq = l.data == r.data
            except TpuUnsupportedExpr:
                # cross-kind equality (e.g. string vs int) is false, not error
                eq = self._falses()
        if isinstance(expr, E.Neq):
            eq = ~eq
        return Column(BOOL, eq, _and_valid(l, r))

    def _comparison(self, expr) -> Column:
        l, r = self.eval(expr.lhs), self.eval(expr.rhs)
        if OBJ in (l.kind, r.kind):
            raise TpuUnsupportedExpr(f"comparison on object values: {_obj_item(l, r)}")
        if l.kind == BOOL and r.kind == BOOL:
            # false < true
            l = Column(I64, l.data.to(torch.int64), l.valid)
            r = Column(I64, r.data.to(torch.int64), r.valid)
        try:
            l, r = self._coerce_pair(l, r)
        except TpuUnsupportedExpr:
            # cross-kind ordering (1 < 'a') is null in openCypher
            return Column(BOOL, self._falses(), self._falses())
        if isinstance(expr, E.LessThan):
            v = l.data < r.data
        elif isinstance(expr, E.LessThanOrEqual):
            v = l.data <= r.data
        elif isinstance(expr, E.GreaterThan):
            v = l.data > r.data
        else:
            v = l.data >= r.data
        if l.kind == F64:
            # a comparison with NaN is false
            v = v & ~(torch.isnan(l.data) | torch.isnan(r.data))
        return Column(BOOL, v, _and_valid(l, r))

    def _in(self, expr) -> Column:
        if not isinstance(expr.rhs, E.ListLit) or not all(
            isinstance(i, E.Lit) for i in expr.rhs.items
        ):
            raise TpuUnsupportedExpr(f"IN on non-literal list: {_LISTS_ITEM}")
        values = [i.value for i in expr.rhs.items]
        if not values:
            # x IN [] is the empty disjunction: false for EVERY x, null
            # included (the null propagation below must not see this case)
            return Column(BOOL, self._falses(), None)
        l = self.eval(expr.lhs)
        if l.kind == I64 and any(isinstance(v, float) for v in values):
            # cross-type numeric equality: 23 IN [23.0] is true
            l = l.cast_f64()
        if l.kind == I64:
            cand = [v for v in values if isinstance(v, int) and not isinstance(v, bool)]
            dtype = np.int64
        elif l.kind == F64:
            cand = [
                float(v)
                for v in values
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            ]
            dtype = np.float64
        elif l.kind == STR:
            idx = {s: i for i, s in enumerate(l.vocab or [])}
            cand = [idx[v] for v in values if isinstance(v, str) and v in idx]
            dtype = np.int32
        else:
            raise TpuUnsupportedExpr(f"IN over {l.kind}")
        if cand:
            items = torch.from_numpy(np.array(cand, dtype=dtype)).to(l.data.device)
            hit = torch.isin(l.data, items)
        else:
            hit = self._falses()
        valid = l.valid_mask()
        if any(v is None for v in values):
            # null list element: non-hits become unknown
            valid = valid & hit
        return Column(BOOL, hit & valid, valid)

    def _string_predicate(self, expr) -> Column:
        """A constant pattern over a STR column: the predicate runs once per
        vocab entry. A null pattern is null everywhere."""
        pat = self._const_value(expr.rhs)
        l = self.eval(expr.lhs)
        if pat is None:
            return Column(BOOL, self._falses(), self._falses())
        if pat is _NOT_CONST or not isinstance(pat, str):
            raise TpuUnsupportedExpr("non-constant string pattern")
        if l.kind != STR:
            if l.is_all_null():
                return Column(BOOL, self._falses(), self._falses())
            raise TpuUnsupportedExpr(f"string predicate over {l.kind}")
        if isinstance(expr, E.StartsWith):
            fn = lambda s: s.startswith(pat)
        elif isinstance(expr, E.EndsWith):
            fn = lambda s: s.endswith(pat)
        elif isinstance(expr, E.Contains):
            fn = lambda s: pat in s
        else:
            rx = re.compile(pat)
            fn = lambda s: rx.fullmatch(s) is not None
        return self._vocab_apply(l, fn)

    # -- arithmetic, CASE -----------------------------------------------------

    def _arith(self, expr) -> Column:
        """Numeric arithmetic as the reference's device path: I64 op I64
        stays I64 (overflow wraps; ``/`` truncates toward zero; ``/`` and
        ``%`` by 0 are null), anything with an F64 side is F64 (intness
        dropped), and ``^`` is always F64."""
        l, r = self.eval(expr.lhs), self.eval(expr.rhs)
        if OBJ in (l.kind, r.kind):
            raise TpuUnsupportedExpr(f"arithmetic on object values: {_obj_item(l, r)}")
        if isinstance(expr, E.Add) and STR in (l.kind, r.kind):
            raise TpuUnsupportedExpr(f"string concatenation: {_LISTS_ITEM}")
        if l.kind not in (I64, F64) or r.kind not in (I64, F64):
            raise TpuUnsupportedExpr(f"arithmetic on {l.kind}/{r.kind}")
        valid = _and_valid(l, r)
        if l.kind == I64 and r.kind == I64:
            a, b = l.data, r.data
            if isinstance(expr, E.Add):
                return Column(I64, a + b, valid)
            if isinstance(expr, E.Subtract):
                return Column(I64, a - b, valid)
            if isinstance(expr, E.Multiply):
                return Column(I64, a * b, valid)
            if isinstance(expr, (E.Divide, E.Modulo)):
                nz = b != 0
                bb = torch.where(nz, b, torch.ones_like(b))
                if isinstance(expr, E.Divide):
                    out = torch.sign(a) * torch.sign(b) * (torch.abs(a) // torch.abs(bb))
                else:
                    out = torch.sign(a) * (torch.abs(a) % torch.abs(bb))
                return Column(I64, out, nz if valid is None else valid & nz)
        a, b = l.cast_f64().data, r.cast_f64().data
        if isinstance(expr, E.Add):
            out = a + b
        elif isinstance(expr, E.Subtract):
            out = a - b
        elif isinstance(expr, E.Multiply):
            out = a * b
        elif isinstance(expr, E.Divide):
            out = a / b
        elif isinstance(expr, E.Modulo):
            # the sign of the dividend; -0.0 keeps its sign as jnp.sign does
            out = torch.where(a == 0, a, torch.sign(a)) * _fmod(torch.abs(a), torch.abs(b))
        elif isinstance(expr, E.Pow):
            out = torch.pow(a, b)
        else:
            raise TpuUnsupportedExpr(type(expr).__name__)
        return Column(F64, out, valid)

    def _same_kind(self, cols: List[Column], what: str) -> List[Column]:
        """Branches of one CASE or coalesce on one kind: I64 with F64 as
        F64 keeping intness; an all-null branch adopts the others' kind;
        STR branches re-coded onto one merged vocab. Object values and any
        other mix raise."""
        kinds = {c.kind for c in cols}
        if OBJ in kinds:
            raise TpuUnsupportedExpr(f"{what} over object values: {_obj_item(*cols)}")
        if len(kinds) > 1 and not kinds <= {I64, F64}:
            # one device read per branch, only for a mix of kinds
            dead = [c.is_all_null() for c in cols]
            live = [c for c, d in zip(cols, dead) if not d]
            if not live:
                return [constant_column(None, self.n) for _ in cols]
            if len({c.kind for c in live}) == 1:
                cols = [live[0].null_like(self.n) if d else c for c, d in zip(cols, dead)]
                kinds = {live[0].kind}
        if kinds <= {I64, F64} and len(kinds) > 1:
            if any(c.ints_beyond_f64() for c in cols):
                raise TpuUnsupportedExpr(f"{what}: integers beyond 2**53 with floats")
            cols = [c.as_f64_keeping_intness() for c in cols]
        elif len(kinds) > 1:
            raise TpuUnsupportedExpr(f"heterogeneous {what}")
        elif kinds == {STR}:
            merged = sorted({s for c in cols for s in (c.vocab or [])})
            cols = [_remap(c, merged) for c in cols]
        return cols

    def _case(self, expr: E.CaseExpr) -> Column:
        if expr.operand is not None:
            conds = [self._equality(E.Equals(expr.operand, w)) for w in expr.whens]
        else:
            conds = [self._as_bool(self.eval(w)) for w in expr.whens]
        default = (
            self.eval(expr.default)
            if expr.default is not None
            else constant_column(None, self.n)
        )
        *thens, out = self._same_kind(
            [self.eval(t) for t in expr.thens] + [default], "CASE"
        )
        # from the last WHEN to the first, so earlier WHENs win
        for cond, then in zip(reversed(conds), reversed(thens)):
            take = cond.data & cond.valid_mask()
            out = Column(
                then.kind,
                torch.where(take, then.data, out.data),
                torch.where(take, then.valid_mask(), out.valid_mask()),
                then.vocab,
                int_flag=_merge_int_flag(take, then, out),
            )
        return out

    def _coalesce(self, args: List[Column]) -> Column:
        *firsts, out = self._same_kind(args, "coalesce")
        for a in reversed(firsts):
            take = a.valid_mask()
            out = Column(
                a.kind,
                torch.where(take, a.data, out.data),
                take | out.valid_mask(),
                a.vocab,
                int_flag=_merge_int_flag(take, a, out),
            )
        return out

    # -- functions ------------------------------------------------------------

    def _const_value(self, e: E.Expr):
        if isinstance(e, E.Lit):
            return e.value
        if isinstance(e, E.Param):
            return self.params.get(e.name)
        return _NOT_CONST

    def _function(self, expr: E.FunctionCall) -> Column:
        from ...ir.functions import lookup

        name = expr.name
        if name == "rand" and not expr.args:
            # one draw per row, never folded to one sample
            dev = _device.get()
            return Column(F64, torch.rand(
                self.n, generator=_device.generator(dev), dtype=torch.float64, device=dev,
            ), None)
        if name == "randomuuid":
            raise TpuUnsupportedExpr("randomUUID() has no device column kind")
        if name == "type" and len(expr.args) == 1:
            got = self._rel_type(expr.args[0])
            if got is not None:
                return got
        try:
            f = lookup(name)
        except Exception:
            raise TpuUnsupportedExpr(f"unknown function {name}")
        consts = [self._const_value(a) for a in expr.args]
        if all(c is not _NOT_CONST for c in consts):
            # fold a constant call (pi(), e() included) once
            if f.null_prop and any(c is None for c in consts):
                return constant_column(None, self.n)
            return _scalar_constant(f.fn(*consts), self.n)
        args = [self.eval(a) for a in expr.args]
        x = args[0]
        if x.kind in (I64, F64) and name in _NUMERIC_FUNCTIONS:
            return self._numeric_function(name, x)
        if name == "coalesce":
            return self._coalesce(args)
        return self._per_value_function(expr, args, f, consts)

    def _numeric_function(self, name: str, x: Column) -> Column:
        from .jit_ops import _sqrt_rn

        if name == "abs":
            return Column(x.kind, torch.abs(x.data), x.valid)
        if name == "sign":
            d = x.data
            return Column(I64, (d > 0).to(torch.int64) - (d < 0).to(torch.int64), x.valid)
        if name == "tofloat":
            return x.cast_f64()
        if name == "tointeger":
            return self._to_integer(x)
        fn = {
            "ceil": torch.ceil,
            "floor": torch.floor,
            # half away from zero (torch.round rounds half to even)
            "round": lambda v: torch.where(
                v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5)
            ),
            "sqrt": _sqrt_rn,
            "exp": torch.exp,
            "log": torch.log,
            "log10": torch.log10,
            "sin": torch.sin,
            "cos": torch.cos,
            "tan": torch.tan,
        }[name]
        return Column(F64, fn(x.cast_f64().data), x.valid)

    def _to_integer(self, x: Column) -> Column:
        """Truncation toward zero. A NaN or infinite value raises the local
        oracle's own error; a finite value outside int64 raises
        ``TpuUnsupportedExpr`` (XLA's casts saturate both): one device read
        for the check."""
        from ...ir.functions import lookup

        if x.kind == I64:
            return x
        d = x.data
        bad = x.valid_mask() & ~((d >= -(2.0**63)) & (d < 2.0**63))
        if bool(torch.any(bad)):
            lookup("tointeger").fn(float(d[bad][0]))
            raise TpuUnsupportedExpr("toInteger() beyond int64")
        return Column(I64, d.to(torch.int64), x.valid)

    def _per_value_function(self, expr, args: List[Column], f, consts) -> Column:
        """A registry function over one non-constant column (the others
        constant): its scalar ``fn`` runs once per vocab entry of a STR
        column, or once per distinct value of an I64, F64 or BOOL column,
        on the host; one device gather maps the rows. O(|vocab|) or
        O(distinct) host work, O(n) device work."""
        name = expr.name
        live = [i for i, c in enumerate(consts) if c is _NOT_CONST]
        if len(live) != 1:
            raise TpuUnsupportedExpr(f"{name}() over {len(live)} non-constant arguments")
        pos = live[0]
        col = args[pos]
        if col.kind == OBJ:
            raise TpuUnsupportedExpr(f"{name}() over object values: {_obj_item(col)}")
        if f.null_prop and any(c is None for i, c in enumerate(consts) if i != pos):
            return constant_column(None, self.n)

        def per_value(v, _c=consts, _p=pos, _f=f.fn):
            a = list(_c)
            a[_p] = v
            return _f(*a)

        if name == "tostring" and col.kind == BOOL:
            # two-entry vocab; 'false' < 'true', so the code is the value
            res = Column(STR, col.data.to(torch.int32), col.valid, ["false", "true"])
        elif col.kind == STR:
            res = self._vocab_apply(col, per_value)
        else:
            res = self._distinct_apply(col, per_value)
        if not f.null_prop and res.kind in (I64, F64, BOOL):
            # e.g. exists(): fn(null) is a value, not null
            try:
                nv = per_value(None)
            except Exception:  # fault-ok: a host probe of fn(null), no device work
                nv = None
            if nv is not None:
                const = constant_column(nv, self.n)
                if const.kind == res.kind:
                    base = col.valid_mask()
                    res = Column(
                        res.kind,
                        torch.where(base, res.data, const.data),
                        torch.where(base, res.valid_mask(), True),
                    )
        return res

    def _vocab_apply(self, col: Column, fn) -> Column:
        """``fn`` once per vocab entry of a STR column."""
        return _lut_apply(col.data, col.valid, [fn(s) for s in (col.vocab or [])])

    def _distinct_apply(self, col: Column, fn) -> Column:
        """``fn`` once per distinct valid value of an I64, F64 or BOOL
        column. F64 values are told apart by their bits (so -0.0 and 0.0
        differ) and by their intness; ``torch.unique`` finds them on the
        device, and one copy brings the distinct values to the host."""
        valid = col.valid
        if col.kind == F64:
            key = col.data.view(torch.int64)
            if col.int_flag is not None:
                key = torch.stack([key, col.int_flag.to(torch.int64)], dim=1)
        else:
            key = col.data.to(torch.int64)
        rows = None if valid is None else torch.nonzero(valid).squeeze(1)
        sel = key if rows is None else key[rows]
        if key.dim() == 1:
            uniq, inv = torch.unique(sel, return_inverse=True)
        else:
            uniq, inv = torch.unique(sel, dim=0, return_inverse=True)
        host = to_host(uniq)
        if col.kind == F64:
            bits = host if host.ndim == 1 else host[:, 0]
            floats = bits.view(np.float64)
            ints = host[:, 1] if host.ndim == 2 else np.zeros(len(host), bool)
            values = [int(v) if i else float(v) for v, i in zip(floats, ints)]
        elif col.kind == BOOL:
            values = [bool(v) for v in host]
        else:
            values = [int(v) for v in host]
        if rows is None:
            codes = inv
        else:
            codes = torch.full((self.n,), -1, dtype=inv.dtype, device=inv.device)
            codes[rows] = inv
        return _lut_apply(codes, valid, [fn(v) for v in values])


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The remainder of non-negative float64 tensors (``torch.remainder``'s
    and ``fmod``'s, which agree there), exact as IEEE's fmod is: the
    card's ``torch.fmod`` is; a CPU tensor takes numpy's, since torch's CPU
    kernel returns NaN where the quotient overflows in some versions."""
    if a.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.fmod(a.numpy(), b.numpy()))
    return torch.fmod(a, b)


def _scalar_constant(value, n: int) -> Column:
    """A folded constant as a device column; a list, map or temporal value
    has no device column kind yet."""
    if value is None or isinstance(value, (bool, int, float, str)):
        col = constant_column(value, n)
        if col.kind != OBJ:
            return col
    item = _TEMPORAL_ITEM if isinstance(value, (_dt.date, _dt.time, Duration)) else _LISTS_ITEM
    raise TpuUnsupportedExpr(f"constant {type(value).__name__} value: {item}")


def _lut_apply(codes, valid, outs: List[Any]) -> Column:
    """One output per code (None: null) as a device column, gathered by the
    codes (-1: a null row). STR outputs get a sorted vocab; numeric ones
    with both ints and floats become F64. Any other output raises."""
    non_null = [o for o in outs if o is not None]
    dev = codes.device
    safe = torch.where(codes >= 0, codes.to(torch.int64), len(outs))
    if all(isinstance(o, str) for o in non_null):
        vocab = sorted(set(non_null))
        index = {s: i for i, s in enumerate(vocab)}
        lut = np.array(
            [index[o] if o is not None else _NULL_CODE for o in outs] + [_NULL_CODE],
            dtype=np.int32,
        )
        out = torch.from_numpy(lut).to(dev)[safe]
        has_null = valid is not None or bool((lut[:-1] == _NULL_CODE).any())
        vmask = out != _NULL_CODE
        if valid is not None:
            vmask = vmask & valid
        return Column(STR, out, vmask if has_null else None, vocab)
    if all(isinstance(o, bool) for o in non_null):
        kind, dtype = BOOL, np.bool_
    elif all(isinstance(o, int) and not isinstance(o, bool) for o in non_null):
        kind, dtype = I64, np.int64
    elif all(isinstance(o, (int, float)) and not isinstance(o, bool) for o in non_null):
        kind, dtype = F64, np.float64
        outs = [float(o) if o is not None else None for o in outs]
    else:
        raise TpuUnsupportedExpr(f"non-scalar function result: {_LISTS_ITEM}")
    ok = np.array([o is not None for o in outs] + [False], dtype=bool)
    vals = np.array([o if o is not None else 0 for o in outs] + [0], dtype=dtype)
    vmask = torch.from_numpy(ok).to(dev)[safe]
    if valid is not None:
        vmask = vmask & valid
    return Column(kind, torch.from_numpy(vals).to(dev)[safe], vmask)


def _merge_int_flag(take, a: Column, b: Column):
    """int_flag of where(take, a, b); None when neither side tracks it."""
    if a.int_flag is None and b.int_flag is None:
        return None
    zeros = torch.zeros(len(a), dtype=torch.bool, device=take.device)
    ai = a.int_flag if a.int_flag is not None else zeros
    bi = b.int_flag if b.int_flag is not None else zeros
    return torch.where(take, ai, bi)


def _and_valid(l: Column, r: Column):
    if l.valid is None and r.valid is None:
        return None
    return l.valid_mask() & r.valid_mask()
