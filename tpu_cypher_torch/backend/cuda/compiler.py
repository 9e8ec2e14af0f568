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
  for is null;
* lists, maps and elements as values (``LST`` and ``STRUCT`` columns,
  ``column.py``; the segment work in ``lists.py``): an element variable is
  a ``STRUCT`` of its header columns; list literals (constant, or the item
  columns interleaved), map literals and projections, ``[i]`` on a list,
  map or element, list slices, ``IN`` over a list column, ``+`` on lists,
  ``size``/``head``/``last``/``tail``/``reverse``/``range``/``labels``/
  ``keys``/``properties``, list comprehensions and ``any``/``all``/
  ``none``/``single`` (the inner expression over the child rows, the outer
  columns gathered by each element's row, then one reduction per list);
  a registry function that returns lists (``split``) takes the vocab or
  distinct-value route; string ``+`` runs once per distinct pair of
  operand values;
* the rest of the list surface: lists of lists and lists whose elements
  mix kinds (the ``MIX`` column), a ``CASE`` or ``coalesce`` whose
  branches differ in kind, ``=``/``<>`` and ``IN`` on lists and maps and
  ``<`` on lists (``values.py``: the oracle's three-valued equality, and
  an exact rank in Cypher order), ``reduce`` (an integer ``acc + g(x)`` as
  one segment sum, any other fold step by step over element positions),
  ``v{.*}``, ``properties()`` of a map, and a named path as a value: a
  ``path`` STRUCT of its node and relationship lists, with ``length``,
  ``nodes`` and ``relationships``;
* a registry function of several non-constant arguments, and a string
  predicate whose pattern is a column, run once per distinct tuple of
  operand values;
* temporal values (the ``DATE``, ``LDT``, ``ZDT``, ``ZT``, ``LT`` and
  ``DUR`` columns; ``temporal.py`` holds the calendar math): constants and
  constructors fold once; the calendar and duration accessors,
  ``date``/``localdatetime``/``datetime.truncate`` by a constant unit,
  ``=``/``<>`` and the ordered comparisons (each kind on its own payload,
  across kinds as the local oracle rules), a temporal plus or minus a
  duration, durations added, subtracted and negated, and
  ``duration.between``/``inMonths``/``inDays``/``inSeconds`` over dates
  and localdatetimes run as torch ops; any other registry function or
  accessor of a temporal value, and a duration scaled by a number, run
  once per distinct tuple of operand values on the host, as the string
  functions do. A result outside years 1 to 9999, and an operator or
  function the oracle refuses, raise the local oracle's own error after
  one device read.

No row is ever evaluated in Python. What the port cannot compile raises
``TpuUnsupportedExpr``: where the reference evaluates it as a host island
on its local oracle, the port keeps no island (ROADMAP.md §3). Pattern
comprehensions name ROADMAP.md queue 1, item 6.5; the temporal shapes
the port declines (dates mixed with datetimes in one result, zoned values
whose offsets differ) name ROADMAP.md §3. Where the oracle raises on a
kind (``true + 1``, ``-'a'``, a property of an integer, an aggregate in a
``WHERE``), the port raises the oracle's own error, read off the first
row that has the operands (one device read). The reference's jit cache
of whole expressions has no counterpart: eager PyTorch compiles nothing
to cache.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...api.values import Duration, to_cypher_string
from ...ir import expr as E
from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from . import device as _device
from . import lists as LS
from . import temporal as TP
from . import values as V
from .column import (
    BOOL,
    DATE,
    DUR,
    F64,
    I64,
    LDT,
    LST,
    LT,
    MAP,
    MIX,
    NESTED_KINDS,
    NODE,
    OBJ,
    PATH,
    PROPS,
    REL,
    SCALAR_KINDS,
    STR,
    STRUCT,
    TEMPORAL_KINDS,
    ZDT,
    ZT,
    Column,
    TpuBackendError,
    _NULL_CODE,
    _remap,
    _unify_vocab,
    constant_column,
    sparse_names,
    struct_column,
    to_host,
)

_LISTS_ITEM = LS.NESTED_ITEM
_MIXED_TEMPORAL = "temporal values of mixed kinds, offsets or named zones (ROADMAP.md §3)"
_TIME_KINDS = TEMPORAL_KINDS + (DUR,)
_TRUNCATE = frozenset({"date.truncate", "localdatetime.truncate", "datetime.truncate"})
_BETWEEN = frozenset({
    "duration.between", "duration.inmonths", "duration.indays", "duration.inseconds",
})
_NUMERIC_FUNCTIONS = frozenset({
    "abs", "sign", "tofloat", "tointeger", "ceil", "floor", "round", "sqrt",
    "exp", "log", "log10", "sin", "cos", "tan",
})
_NOT_CONST = object()
_LIST_FUNCTIONS = frozenset({
    "size", "length", "head", "last", "tail", "reverse", "range", "labels",
    "keys", "properties", "nodes", "relationships",
})


class TpuUnsupportedExpr(TpuBackendError):
    pass


def _obj_item(*cols: Column) -> str:
    """What these object columns hold: temporal values of mixed kinds or
    offsets (ROADMAP.md §3), or values of no device column kind."""
    for c in cols:
        if c.kind != OBJ:
            continue
        for v in c.data:
            if isinstance(v, (_dt.date, _dt.time, Duration)):
                return _MIXED_TEMPORAL
    return "values with no device column kind"


def _oracle(build):
    """The local oracle's scalar semantics of the expression ``build``
    makes from literals: a function of the operand values."""
    from ..local.eval import Evaluator

    ev = Evaluator(None, None, {})
    return lambda *vals: ev.row_fn(build(*(E.Lit(v) for v in vals)))({})


class CudaEvaluator:
    def __init__(self, table, header, parameters: Dict[str, Any], rows=None):
        self.table = table
        self.header = header
        self.params = parameters or {}
        # a list comprehension or quantifier evaluates over element rows:
        # ``rows`` is each element's row of ``table``
        self.rows = rows
        self.n = table.size if rows is None else int(rows.shape[0])
        self._gathered: Dict[str, Column] = {}
        # list comprehension and quantifier variables bound to child rows
        self.locals: Dict[str, Column] = {}

    def _col(self, name) -> Optional[Column]:
        """The table's column ``name``, gathered by ``rows`` on first use;
        None when the table lacks it."""
        col = self.table._cols.get(name)
        if col is None or self.rows is None:
            return col
        if name not in self._gathered:
            self._gathered[name] = col.take(self.rows)
        return self._gathered[name]

    def eval(self, expr: E.Expr) -> Column:
        if isinstance(expr, E.Var) and expr.name in self.locals:
            return self.locals[expr.name]
        got = self._col(self.header.get(expr)) if self.header is not None else None
        if got is not None:
            return got
        if isinstance(expr, E.Lit):
            return constant_column(expr.value, self.n)
        if isinstance(expr, E.Param):
            return constant_column(self.params.get(expr.name), self.n)
        if isinstance(expr, E.Var):
            if self._is_path(expr):
                return self._path(expr)
            got = self._element_struct(expr)
            if got is None:
                raise TpuUnsupportedExpr(f"variable {expr.name} unmapped")
            return got
        if isinstance(expr, (E.Id, E.StartNode, E.EndNode)):
            return self._struct_field(expr)
        if isinstance(expr, E.ListLit):
            return self._list_literal(expr)
        if isinstance(expr, E.MapLit):
            return struct_column(
                {k: self.eval(v) for k, v in zip(expr.keys, expr.values)}, self.n,
                device=_device.get(),
            )
        if isinstance(expr, E.MapProjection):
            return self._map_projection(expr)
        if isinstance(expr, E.Index):
            return self._index(expr)
        if isinstance(expr, E.ListSlice):
            return self._slice(expr)
        if isinstance(expr, E.ListComprehension):
            return self._comprehension(expr)
        if isinstance(expr, E.Quantified):
            return self._quantified(expr)
        if isinstance(expr, E.Reduce):
            return self._reduce(expr)
        if isinstance(expr, E.PatternComprehension):
            raise TpuUnsupportedExpr(f"a pattern comprehension: {_LISTS_ITEM}")
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
            if inner.kind == DUR:
                return Column(DUR, -inner.data, inner.valid)
            if inner.kind not in (I64, F64):
                # the oracle's error at the first non-null row, or null
                return self._oracle_raise(E.Neg, [inner])
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
        if isinstance(expr, (E.HasLabel, E.HasType)):
            return self._absent_flag(expr)
        if isinstance(expr, (E.Agg, E.CountStar)):
            # an aggregate outside an aggregation (``WHERE count(n) > 0``):
            # the local oracle's own error
            from ..local.eval import EvalError

            raise EvalError(f"Cannot evaluate {type(expr).__name__}: {expr.pretty_expr()}")
        raise TpuUnsupportedExpr(type(expr).__name__)

    # -- elements -------------------------------------------------------------

    def _is_path(self, v: E.Var) -> bool:
        return self.header is not None and self.header.has_path(v.name)

    def _element(self, expr: E.Expr) -> Optional[Tuple[str, Column]]:
        """("node" or "relationship", id column) when ``expr`` is an element
        variable whose id column the table holds; else None."""
        if (not isinstance(expr, E.Var) or self.header is None or expr.name in self.locals
                or self._is_path(expr)):
            return None
        owned = self.header.expressions_for(expr)
        ids = [self._col(self.header.get(e)) for e in owned if isinstance(e, E.Id)]
        if not ids or ids[0] is None:
            return None
        rel = any(isinstance(e, E.StartNode) for e in owned)
        return ("relationship" if rel else "node"), ids[0]

    def identity(self, expr: E.Expr) -> Column:
        """``expr`` where only its identity decides the result (``count``,
        ``count(DISTINCT ...)``, ``=``/``<>``, ``IS [NOT] NULL``): an
        element variable is its id column with its validity; every other
        expression evaluates as a value."""
        return self._typed_identity(expr)[1]

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
        if inner.kind == STRUCT:
            return self._struct_get(inner, expr.key)
        if inner.kind in _TIME_KINDS:
            return self._temporal_accessor(inner, expr.key)
        if inner.kind == OBJ:
            raise TpuUnsupportedExpr(f"property access on object values: {_obj_item(inner)}")
        # a value with no properties: the oracle's error at its first
        # non-null row, or null where there is none
        return self._oracle_raise(lambda v: E.Property(v, expr.key), [inner])

    def _absent_flag(self, expr) -> Column:
        """``n:L`` or ``r:T`` where the header holds no flag column: a label
        or type absent from the graph, so false wherever the element is not
        null. Of an element value the struct's flag field decides."""
        got = self._element(expr.expr)
        if got is not None:
            return Column(BOOL, self._falses(), got[1].valid)
        inner = self.eval(expr.expr)
        if inner.kind == STRUCT and inner.tag in (NODE, REL):
            f = inner.field("label:" + expr.label if isinstance(expr, E.HasLabel)
                            else "type:" + expr.rel_type)
            if f is None:
                return Column(BOOL, self._falses(), inner.valid)
            return Column(BOOL, f.data & f.valid_mask(), inner.valid)
        if inner.is_all_null():
            return Column(BOOL, self._falses(), self._falses())
        raise TpuUnsupportedExpr(f"{type(expr).__name__} of {inner.kind}")

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
            c = self._col(self.header.get(flag))
            if c is None:
                raise TpuUnsupportedExpr(f"type({arg.name}): flag {flag.rel_type} unmapped")
            codes = torch.where(c.data & c.valid_mask(), code, codes)
        valid = got[1].valid
        return Column(STR, codes, valid, [f.rel_type for f in flags])

    def _path(self, var: E.Var, parts=("nodes", "relationships")) -> Column:
        """A named path as a value: a ``path`` STRUCT of its node list and
        relationship list, built from the header's member columns as
        ``relational/materialize.py``'s ``path_materializer`` builds the
        path: a relationship member adds itself, a var-length member its
        relationship list and the list of its intermediate nodes (the
        companion column the planner or ``CsrVarExpandOp`` emits), a node
        member itself, but not after a var-length member of length 0
        (there it is the node before). Null where any member is. Only the
        lists named in ``parts`` are built (``length(p)`` reads the
        relationships alone)."""
        from ...api import types as T
        from ...relational.header import path_nodes_companion

        h = self.header
        dev = _device.get()
        ones = torch.ones(self.n, dtype=torch.int64, device=dev)
        valid = torch.ones(self.n, dtype=torch.bool, device=dev)
        nodes = rels = None
        after_var = None  # the lengths of the var-length member just added

        def cat(a, b, part):
            if part not in parts:
                return a
            return b if a is None else LS.concat_rows(a, b, None)

        for f in h.path_entities(var.name):
            v = h.var(f)
            m = (v.cypher_type or T.CTAny.nullable).material
            if isinstance(m, (T.CTNodeType, T.CTRelationshipType)):
                el = self._element_struct(v)
                if el is None:
                    raise TpuUnsupportedExpr(f"path member {f} unmapped")
                valid = valid & el.valid_mask()
                one = LS.list_column(ones, el)
                if isinstance(m, T.CTRelationshipType):
                    rels = cat(rels, one, "relationships")
                else:
                    if after_var is not None:
                        one = LS.list_column((after_var > 0).to(torch.int64), el,
                                             starts=torch.cumsum(ones, 0) - 1)
                    nodes = cat(nodes, one, "nodes")
                after_var = None
                continue
            lst = self.eval(v)
            comp = h.get(E.Var(path_nodes_companion(f)))
            if lst.kind != LST or comp is None:
                raise TpuUnsupportedExpr(f"path member {f} without its nodes")
            valid = valid & lst.valid_mask()
            rels = cat(rels, lst, "relationships")
            nodes = cat(nodes, self._as_list(self._col(comp)), "nodes")
            after_var = lst.lengths()
        if rels is None:  # a path of one node
            rels = LS.list_column(torch.zeros(self.n, dtype=torch.int64, device=dev),
                                  constant_column(None, 0))
        fields = {"nodes": nodes, "relationships": rels}
        return struct_column({k: fields[k] for k in parts}, self.n, valid, PATH, device=dev)

    def _element_struct(self, var: E.Var) -> Optional[Column]:
        """An element variable as a value: a ``STRUCT`` of the header
        columns ``relational/materialize.py`` reads for it (id, endpoints,
        label or type flags, properties), with the id column's validity.
        None when the table holds no id column for ``var``."""
        got = self._element(var)
        if got is None:
            return None
        kind, ids = got
        h = self.header
        fields: Dict[str, Column] = {"id": ids}
        if kind == "relationship":
            owned = h.expressions_for(var)
            for name, cls in (("start", E.StartNode), ("end", E.EndNode)):
                fields[name] = self._col(h.column(next(e for e in owned if isinstance(e, cls))))
            flags = [("type:" + f.rel_type, f) for f in h.types_for(var)]
        else:
            flags = [("label:" + f.label, f) for f in h.labels_for(var)]
        props = [("prop:" + p.key, p) for p in h.properties_for(var)]
        for name, e in flags + props:
            c = self._col(h.column(e))
            if c is not None:
                fields[name] = c
        return struct_column(fields, self.n, ids.valid, REL if kind == "relationship" else NODE)

    def _struct_field(self, expr) -> Column:
        """``id``, ``startNode`` or ``endNode`` of an element value the
        header does not map (a comprehension variable, a list element)."""
        inner = self.eval(expr.expr)
        name = {E.Id: "id", E.StartNode: "start", E.EndNode: "end"}[type(expr)]
        f = inner.field(name) if inner.kind == STRUCT else None
        if f is None:
            raise TpuUnsupportedExpr(f"{type(expr).__name__} of {inner.kind}")
        return Column(f.kind, f.data, inner.valid_mask() & f.valid_mask())

    def _struct_get(self, s: Column, key: str) -> Column:
        """A map's value or an element's property by key (null when absent),
        null where the struct is."""
        name = key if s.tag in (MAP, PROPS) else "prop:" + key
        f = s.field(name)
        if f is None:
            return constant_column(None, len(s))
        if s.valid is None:
            return f
        if f.kind in NESTED_KINDS:
            return f.take_or_null(torch.arange(len(s), device=s.valid.device), s.valid)
        return Column(f.kind, f.data, s.valid & f.valid_mask(), f.vocab, int_flag=f.int_flag)

    # -- predicates ---------------------------------------------------------

    def _falses(self) -> torch.Tensor:
        return torch.zeros(self.n, dtype=torch.bool, device=_device.get())

    def _as_bool(self, c: Column) -> Column:
        """A boolean operand; a column that is null everywhere (a null
        literal compiles as an I64 null) is a boolean null."""
        if c.kind != BOOL:
            if c.is_all_null():
                return Column(BOOL, self._falses(), self._falses())
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

    def _typed_identity(self, expr: E.Expr) -> Tuple[Optional[str], Column]:
        """("node" or "relationship", id column) for an element, from the
        header or from an element value; (None, the value) otherwise."""
        got = self._element(expr)
        return got if got is not None else _identity_of(self.eval(expr))

    def _equality(self, expr) -> Column:
        out = self._equal_identities(self._typed_identity(expr.lhs),
                                     self._typed_identity(expr.rhs))
        if isinstance(expr, E.Neq):
            out = Column(BOOL, ~out.data, out.valid)
        return out

    def _equal_identities(self, left, right) -> Column:
        """Three-valued ``=`` of two (element tag or None, column) pairs:
        elements are equal by id, and an element equals no value of any
        other kind (as in the local oracle's ``cypher_equals``)."""
        (lk, l), (rk, r) = left, right
        if lk is None and rk is None:
            return self._equal_values(l, r)
        eq = l.data == r.data if lk == rk else torch.zeros(
            len(l), dtype=torch.bool, device=l.data.device)
        return Column(BOOL, eq, _and_valid(l, r))

    def _equal_values(self, l: Column, r: Column) -> Column:
        """Three-valued ``=`` of two value columns of one length; lists,
        maps, paths and mixed values as the oracle's ``cypher_equals``
        (``values.equal``)."""
        if OBJ in (l.kind, r.kind):
            raise TpuUnsupportedExpr(f"equality on object values: {_obj_item(l, r)}")
        if l.kind in NESTED_KINDS or r.kind in NESTED_KINDS:
            return V.equal(l, r)
        if DUR in (l.kind, r.kind):
            # equal components; a duration equals no value of another kind
            eq = (torch.all(l.data == r.data, dim=1) if l.kind == r.kind
                  else torch.zeros(len(l), dtype=torch.bool, device=l.data.device))
            return Column(BOOL, eq, _and_valid(l, r))
        try:
            l, r = self._coerce_pair(l, r)
            eq = l.data == r.data
        except TpuUnsupportedExpr:
            # cross-kind equality (e.g. string vs int) is false, not error
            eq = torch.zeros(len(l), dtype=torch.bool, device=l.data.device)
        return Column(BOOL, eq, _and_valid(l, r))

    def _comparison(self, expr) -> Column:
        l, r = self.eval(expr.lhs), self.eval(expr.rhs)
        if OBJ in (l.kind, r.kind):
            raise TpuUnsupportedExpr(f"comparison on object values: {_obj_item(l, r)}")
        if l.kind in NESTED_KINDS or r.kind in NESTED_KINDS:
            return self._compare_nested(expr, l, r)
        if DUR in (l.kind, r.kind):
            # durations do not compare in the oracle (null), as values of
            # two kinds do not
            return Column(BOOL, self._falses(), self._falses())
        if l.kind == BOOL and r.kind == BOOL:
            # false < true
            l = Column(I64, l.data.to(torch.int64), l.valid)
            r = Column(I64, r.data.to(torch.int64), r.valid)
        try:
            l, r = self._coerce_pair(l, r)
        except TpuUnsupportedExpr:
            # cross-kind ordering (1 < 'a') is null in openCypher
            return Column(BOOL, self._falses(), self._falses())
        out = self._comparison_values(expr, l, r)
        if l.kind == F64:
            # a comparison with NaN is false
            out.data = out.data & ~(torch.isnan(l.data) | torch.isnan(r.data))
        return out

    def _compare_nested(self, expr, l: Column, r: Column) -> Column:
        """An ordered comparison where a side is a list, map, element or
        mixed value: two lists compare by their rank in Cypher order, as
        the oracle compares them element by element; any other pair is
        null, as in the oracle."""
        if l.kind == r.kind == LST:
            lr, rr = V.joint_rank([l, r])
            return self._comparison_values(expr, lr, rr)
        if MIX in (l.kind, r.kind):
            raise TpuUnsupportedExpr("an ordered comparison of mixed values")
        return Column(BOOL, self._falses(), self._falses())

    @staticmethod
    def _comparison_values(expr, l: Column, r: Column) -> Column:
        if isinstance(expr, E.LessThan):
            v = l.data < r.data
        elif isinstance(expr, E.LessThanOrEqual):
            v = l.data <= r.data
        elif isinstance(expr, E.GreaterThan):
            v = l.data > r.data
        else:
            v = l.data >= r.data
        return Column(BOOL, v, _and_valid(l, r))

    def _in(self, expr) -> Column:
        if not isinstance(expr.rhs, E.ListLit) or not all(
            isinstance(i, E.Lit) for i in expr.rhs.items
        ):
            return self._in_list(self.eval(expr.lhs), self.eval(expr.rhs))
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
        elif l.kind in _TIME_KINDS:
            # the items of the column's own kind, as payloads
            cand = [c.data[0] for c in (Column.from_values([v]) for v in values if v is not None)
                    if c.kind == l.kind]
            dtype = None
        else:
            raise TpuUnsupportedExpr(f"IN over {l.kind}")
        if not cand:
            hit = self._falses()
        elif l.kind == DUR:
            hit = torch.any(torch.all(l.data[:, None, :] == torch.stack(cand)[None], dim=2), dim=1)
        elif dtype is None:
            hit = torch.isin(l.data.to(torch.int64), torch.stack(cand).to(torch.int64))
        else:
            items = torch.from_numpy(np.array(cand, dtype=dtype)).to(l.data.device)
            hit = torch.isin(l.data, items)
        valid = l.valid_mask()
        if any(v is None for v in values):
            # null list element: non-hits become unknown
            valid = valid & hit
        return Column(BOOL, hit & valid, valid)

    def _in_list(self, x: Column, lst: Column) -> Column:
        """``x IN list`` over a list column: each element compared with its
        row's ``x``, then a segment ``any`` per list. True on a hit; else
        null when the list is null, or when it is not empty and ``x`` or an
        element is null; else false."""
        if lst.kind != LST:
            if lst.is_all_null():
                return Column(BOOL, self._falses(), self._falses())
            raise TpuUnsupportedExpr(f"IN over {lst.kind}")
        parent, pos = LS.elements(lst)
        eq = self._equal_values(x.take(parent), lst.child.take(pos))
        known = eq.valid_mask()
        hit = LS.segment_sum(eq.data & known, parent, self.n) > 0
        unknown = LS.segment_sum(~known, parent, self.n) > 0
        return Column(BOOL, hit, lst.valid_mask() & (hit | ~unknown))

    def _string_predicate(self, expr) -> Column:
        """A constant pattern over a STR column: the predicate runs once per
        vocab entry. A null pattern or subject is null everywhere, and so is
        ``STARTS WITH``, ``ENDS WITH`` or ``CONTAINS`` over a value that is
        not a string, as in the local oracle. A pattern that is a column
        runs the oracle's predicate once per distinct (subject, pattern)
        pair of values."""
        pat = self._const_value(expr.rhs)
        l = self.eval(expr.lhs)
        null = Column(BOOL, self._falses(), self._falses())
        if pat is None or l.is_all_null():
            return null
        regex = isinstance(expr, E.RegexMatch)
        if pat is _NOT_CONST or not isinstance(pat, str):
            r = self.eval(expr.rhs)
            if r.is_all_null() or not (regex or l.kind == r.kind == STR):
                return null
            got = self._per_tuple([l, r], _oracle(type(expr)))
            return got if got.kind == BOOL else null  # no row holds both
        if l.kind != STR:
            if not regex and l.kind in SCALAR_KINDS + NESTED_KINDS:
                return null
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
        timed = l.kind in _TIME_KINDS or r.kind in _TIME_KINDS
        if isinstance(expr, E.Add) and STR in (l.kind, r.kind) and not timed:
            if not (self._concatenable(l) and self._concatenable(r)):
                # a string and a list or map: the oracle's error, or null
                return self._oracle_raise(E.Add, [l, r])
            return self._add_strings(l, r)
        if isinstance(expr, E.Add) and LST in (l.kind, r.kind):
            return self._add_lists(l, r)
        if timed:
            return self._temporal_arith(expr, l, r)
        if l.kind not in (I64, F64) or r.kind not in (I64, F64):
            # the oracle's error at the first row with both operands, or null
            return self._oracle_raise(type(expr), [l, r])
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

    def _same_kind(self, cols: List[Column], what: str) -> Optional[List[Column]]:
        """Branches of one CASE or coalesce on one kind: I64 with F64 as
        F64 keeping intness; an all-null branch adopts the others' kind;
        STR branches re-coded onto one merged vocab. None where the kinds
        still differ (the result is a MIX column). Object values and zoned
        branches whose offsets differ (the result holds one offset)
        raise."""
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
            return None
        elif kinds == {STR}:
            merged = sorted({s for c in cols for s in (c.vocab or [])})
            cols = [_remap(c, merged) for c in cols]
        elif kinds <= {ZDT, ZT} and len({tuple(c.vocab or ()) for c in cols}) > 1:
            raise TpuUnsupportedExpr(f"{what} over zoned values whose offsets differ: "
                                     f"{_MIXED_TEMPORAL}")
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
        branches = [self.eval(t) for t in expr.thens] + [default]
        same = None if any(c.kind in NESTED_KINDS for c in branches) else (
            self._same_kind(branches, "CASE"))
        if same is None:
            *thens, out = branches
            for cond, then in zip(reversed(conds), reversed(thens)):
                out = self._where_nested(cond.data & cond.valid_mask(), then, out)
            return out
        *thens, out = same
        # from the last WHEN to the first, so earlier WHENs win
        for cond, then in zip(reversed(conds), reversed(thens)):
            take = cond.data & cond.valid_mask()
            out = Column(
                then.kind,
                _where(take, then.data, out.data),
                torch.where(take, then.valid_mask(), out.valid_mask()),
                then.vocab,
                int_flag=_merge_int_flag(take, then, out),
            )
        return out

    def _coalesce(self, args: List[Column]) -> Column:
        same = None if any(c.kind in NESTED_KINDS for c in args) else (
            self._same_kind(args, "coalesce"))
        if same is None:
            *firsts, out = args
            for a in reversed(firsts):
                out = self._where_nested(a.valid_mask(), a, out)
            return out
        *firsts, out = same
        for a in reversed(firsts):
            take = a.valid_mask()
            out = Column(
                a.kind,
                _where(take, a.data, out.data),
                take | out.valid_mask(),
                a.vocab,
                int_flag=_merge_int_flag(take, a, out),
            )
        return out

    # -- lists and maps -------------------------------------------------------

    def _list_literal(self, expr: E.ListLit) -> Column:
        """A constant list folds to one list per row; otherwise the item
        columns interleave (row i's items at i*k .. i*k + k - 1), through
        one concatenation that unifies their kinds and one gather."""
        consts = [self._const_value(i) for i in expr.items]
        if all(c is not _NOT_CONST for c in consts):
            return _scalar_constant(consts, self.n)
        items = [self.eval(i) for i in expr.items]
        child = items[0]
        for c in items[1:]:
            child = child.concat(c)
        if child.kind == OBJ:
            raise TpuUnsupportedExpr(f"a list of {_obj_item(child)}")
        k, dev = len(items), child.data.device
        rows = torch.arange(self.n, dtype=torch.int64, device=dev)
        perm = (rows[:, None] + self.n * torch.arange(k, device=dev)[None, :]).reshape(-1)
        return LS.list_column(torch.full((self.n,), k, dtype=torch.int64, device=dev),
                              child.take(perm))

    def _map_projection(self, expr: E.MapProjection) -> Column:
        """``v{.key, key: expr, .*}``: a map per row, null where ``v`` is.
        ``.*`` takes an element's non-null properties, or every entry of a
        map; a named item after it replaces its key."""
        base = self.eval(expr.var)
        if base.kind != STRUCT or base.tag == PATH:
            raise TpuUnsupportedExpr(f"map projection of {base.kind}")
        fields: Dict[str, Column] = {}
        sparse = set()
        if expr.all_props:
            if base.tag in (MAP, PROPS):
                fields = {k: self._struct_get(base, k) for k in base.fields}
                sparse = set(sparse_names(base))
            else:
                fields = {k[5:]: self._struct_get(base, k[5:]) for k in base.fields
                          if k.startswith("prop:")}
                sparse = set(fields)
        for k, v in expr.items:
            fields[k] = self._struct_get(base, k) if v is None else self.eval(v)
            sparse.discard(k)
        return struct_column(fields, self.n, base.valid, device=base.data.device,
                             sparse=frozenset(sparse) if sparse else None)

    def _as_list(self, col: Column) -> Column:
        """``col`` as a list column: a column of nulls is null lists."""
        if col.kind == LST:
            return col
        if col.is_all_null():
            return LS.list_column(torch.zeros(self.n, dtype=torch.int64, device=col.data.device),
                                  constant_column(None, 0), self._falses())
        if col.kind == OBJ:
            raise TpuUnsupportedExpr(f"list operation on object values: {_obj_item(col)}")
        raise TpuUnsupportedExpr(f"list operation on {col.kind}")

    def _int_arg(self, expr: E.Expr) -> Column:
        col = self.eval(expr)
        if col.kind != I64 and not col.is_all_null():
            raise TpuUnsupportedExpr(f"list index of kind {col.kind}")
        return col

    def _element_at(self, lst: Column, i: Column) -> Column:
        """``lst[i]``: negative indices count from the end; out of range,
        a null list or a null index give null."""
        lens, starts = lst.lengths(), lst.starts()
        j = torch.where(i.data < 0, lens + i.data, i.data)
        ok = (j >= 0) & (j < lens) & lst.valid_mask() & i.valid_mask()
        return lst.child.take_or_null(torch.where(ok, starts + j, torch.zeros_like(j)), ok)

    def _index(self, expr: E.Index) -> Column:
        base = self.eval(expr.expr)
        if base.kind == STRUCT:
            key = self._const_value(expr.index)
            if key is None:
                return constant_column(None, self.n)
            if not isinstance(key, str):
                raise TpuUnsupportedExpr("map index that is not a constant string")
            return self._struct_get(base, key)
        if base.kind != LST and not base.is_all_null():
            # ``1[0]``: the oracle's error at the first row with both, or null
            return self._oracle_raise(E.Index, [base, self.eval(expr.index)])
        return self._element_at(self._as_list(base), self._int_arg(expr.index))

    def _sub_list(self, lst: Column, lo: Optional[Column], hi: Optional[Column]) -> Column:
        """Python slice semantics per row: negative bounds count from the
        end, both are clamped to the list; a null bound gives null. A view:
        new (start, length) pairs over the same child."""
        lens = lst.lengths()
        valid = lst.valid_mask()

        def bound(c: Optional[Column], default):
            nonlocal valid
            if c is None:
                return default
            valid = valid & c.valid_mask()
            v = torch.where(c.data < 0, lens + c.data, c.data)
            return torch.minimum(torch.clamp(v, min=0), lens)

        a = bound(lo, torch.zeros_like(lens))
        b = bound(hi, lens)
        n_out = torch.where(valid, torch.clamp(b - a, min=0), torch.zeros_like(lens))
        return LS.list_column(n_out, lst.child,
                              None if lst.valid is None and lo is None and hi is None else valid,
                              starts=lst.starts() + a)

    def _slice(self, expr: E.ListSlice) -> Column:
        lst = self._as_list(self.eval(expr.expr))
        lo = self._int_arg(expr.from_) if expr.from_ is not None else None
        hi = self._int_arg(expr.to) if expr.to is not None else None
        return self._sub_list(lst, lo, hi)

    def _bind(self, parent, var: E.Var, value: Column, **more: Column) -> "CudaEvaluator":
        """An evaluator over element rows: ``var`` bound to ``value`` (and
        each name of ``more`` to its column), every outer column and local
        gathered by the element's row ``parent``."""
        rows = parent if self.rows is None else self.rows[parent]
        sub = CudaEvaluator(self.table, self.header, self.params, rows)
        sub.locals = {k: v.take(parent) for k, v in self.locals.items()}
        sub.locals[var.name] = value
        sub.locals.update(more)
        return sub

    def _reduce(self, expr: E.Reduce) -> Column:
        """``reduce(acc = init, x IN list | f)``, folded in element order as
        the oracle folds it; null for a null list, ``init`` for an empty
        one. An integer fold ``acc + g(x)`` (``g`` free of ``acc``) is the
        per-list sum of ``g`` over every element at once: integer addition
        is associative (and wraps as the device's does). Any other fold
        steps over element positions: step ``j`` evaluates ``f`` over the
        lists longer than ``j``, so its cost grows with the longest list.
        The elements are read once, on the ``expand_rows`` gate."""
        lst = self._as_list(self.eval(expr.list_expr))
        init = self.eval(expr.init)
        valid = lst.valid_mask()
        parent, pos = LS.elements(lst)
        got = self._additive_fold(expr, lst, init, parent, pos)
        if got is not None:
            return got
        # the lanes by their position in their list, each step a slice in
        # row order
        j = pos - lst.starts()[parent]
        order = torch.sort(j, stable=True).indices
        counts = []
        if len(j):
            with host_sync("expr"):
                hist = torch.bincount(j, minlength=1)
            counts = to_host(hist, "expr").tolist()
        acc, lo = init, 0
        for cnt in counts:
            lanes = order[lo:lo + cnt]
            lo += cnt
            rows = parent[lanes]
            sub = self._bind(rows, expr.var, lst.child.take(pos[lanes]),
                             **{expr.acc.name: acc.take(rows)})
            acc = _put_rows(acc, rows, sub.eval(expr.expr), self.n)
        if lst.valid is None:
            return acc
        rows = torch.arange(self.n, dtype=torch.int64, device=valid.device)
        return acc.take_or_null(rows, valid)

    def _additive_fold(self, expr: E.Reduce, lst: Column, init: Column, parent, pos):
        """``reduce(acc = i, x IN l | acc + g(x))`` over integers as
        ``i + sum(g(x))`` per list, null where ``i``, the list or any
        ``g(x)`` is; None where the fold is not of that form."""
        body, acc = expr.expr, expr.acc.name
        if not isinstance(body, E.Add) or init.kind != I64:
            return None
        uses_acc = lambda e: e.exists(lambda n: isinstance(n, E.Var) and n.name == acc)
        if body.lhs == E.Var(acc) and not uses_acc(body.rhs):
            g = body.rhs
        elif body.rhs == E.Var(acc) and not uses_acc(body.lhs):
            g = body.lhs
        else:
            return None
        vals = self._bind(parent, expr.var, lst.child.take(pos)).eval(g)
        if vals.kind != I64:
            return None
        vm = vals.valid_mask()
        total = LS.segment_sum(torch.where(vm, vals.data, 0), parent, self.n)
        nulls = LS.segment_sum(~vm, parent, self.n)
        valid = init.valid_mask() & lst.valid_mask() & (nulls == 0)
        return Column(I64, init.data + total, valid)

    def _predicate_on(self, sub: "CudaEvaluator", pred: E.Expr) -> Column:
        got = sub.eval(pred)
        if got.kind != BOOL:
            if got.is_all_null():
                return Column(BOOL, sub._falses(), sub._falses())
            raise TpuUnsupportedExpr(f"predicate of kind {got.kind}")
        return got

    def _comprehension(self, expr: E.ListComprehension) -> Column:
        """``[x IN list WHERE p | f]``: ``p`` and ``f`` over the element
        rows, the kept elements' count per list as the new lengths."""
        lst = self._as_list(self.eval(expr.list_expr))
        parent, pos = LS.elements(lst)
        vals = lst.child.take(pos)
        lens = lst.lengths()
        if expr.where is not None:
            p = self._predicate_on(self._bind(parent, expr.var, vals), expr.where)
            kept = p.data & p.valid_mask()
            lens = LS.segment_sum(kept, parent, self.n)
            with host_sync("expr"):
                # tpulint: allow[pad-invariant] reason=exact compaction of the list elements a comprehension's WHERE keeps: the kept elements are the answer's values
                keep = torch.nonzero(kept).squeeze(1)
            parent, vals = parent[keep], vals.take(keep)
        if expr.projection is not None:  # over the kept elements only
            vals = self._bind(parent, expr.var, vals).eval(expr.projection)
        if vals.kind == OBJ:
            raise TpuUnsupportedExpr(f"a list of {_obj_item(vals)}")
        return LS.list_column(lens, vals, lst.valid)

    def _quantified(self, expr: E.Quantified) -> Column:
        """``any``/``all``/``none``/``single``: the predicate over the child
        rows, then per list the counts of true and null results, under the
        local oracle's three-valued rules; a null list gives null."""
        lst = self._as_list(self.eval(expr.list_expr))
        parent, pos = LS.elements(lst)
        p = self._predicate_on(self._bind(parent, expr.var, lst.child.take(pos)),
                               expr.predicate)
        known = p.valid_mask()
        trues = LS.segment_sum(p.data & known, parent, self.n)
        nulls = LS.segment_sum(~known, parent, self.n)
        none_null = nulls == 0
        if expr.kind == "any":
            data, valid = trues > 0, (trues > 0) | none_null
        elif expr.kind == "none":
            data, valid = trues == 0, (trues > 0) | none_null
        elif expr.kind == "all":
            falses = lst.lengths() - trues - nulls
            data, valid = (falses == 0) & none_null, (falses > 0) | none_null
        else:  # single
            data, valid = trues == 1, (trues > 1) | none_null
        return Column(BOOL, data, valid & lst.valid_mask())

    def _list_function(self, name: str, args: List[E.Expr]) -> Optional[Column]:
        """The list functions over list, map or element columns; None where
        the registry routes answer (a string's ``size``, ``reverse`` ...)."""
        if name == "range":
            return self._range(args)
        part = "nodes" if name == "nodes" else "relationships"
        if (name in ("nodes", "relationships", "length") and isinstance(args[0], E.Var)
                and args[0].name not in self.locals and self._is_path(args[0])):
            got = _path_list(self._path(args[0], (part,)), part)
            return Column(I64, got.lengths(), got.valid) if name == "length" else got
        col = self.eval(args[0])
        if col.kind == STRUCT and col.tag == PATH and name in ("nodes", "relationships",
                                                                 "length"):
            got = _path_list(col, part)
            return Column(I64, got.lengths(), got.valid) if name == "length" else got
        if name in ("labels", "keys", "properties"):
            if col.kind != STRUCT:
                return None
            return self._struct_function(name, col)
        if col.kind != LST:
            return None
        if name in ("size", "length"):
            return Column(I64, col.lengths(), col.valid)
        if name in ("head", "last"):
            at = constant_column(0 if name == "head" else -1, self.n)
            return self._element_at(col, at)
        if name == "tail":
            return self._sub_list(col, constant_column(1, self.n), None)
        if name == "reverse":
            parent, pos = LS.elements(col)
            starts, lens = col.starts()[parent], col.lengths()[parent]
            rev = 2 * starts + lens - 1 - pos
            return LS.list_column(col.lengths(), col.child.take(rev), col.valid)
        return None

    def _struct_function(self, name: str, s: Column) -> Column:
        """``labels`` of a node, ``keys`` and ``properties`` of an element
        or map."""
        if name == "properties":
            if s.tag in (MAP, PROPS):  # the same entries, as a plain dict
                return struct_column(s.fields, self.n, s.valid, PROPS, device=s.data.device,
                                     sparse=sparse_names(s))
            if s.tag == PATH:
                raise TpuUnsupportedExpr("properties() of a path")
            props = {k[5:]: f for k, f in s.fields.items() if k.startswith("prop:")}
            return struct_column(props, self.n, s.valid, PROPS, device=s.data.device)
        if name == "labels":
            if s.tag != NODE:
                raise TpuUnsupportedExpr("labels() of a value that is not a node")
            names = {k[6:]: f for k, f in s.fields.items() if k.startswith("label:")}
            flags = [f.data & f.valid_mask() for f in names.values()]
        elif s.tag in (MAP, PROPS):  # every key, a sparse one where its value is not null
            names = dict(s.fields)
            sparse = sparse_names(s)
            ones = torch.ones(self.n, dtype=torch.bool, device=s.data.device)
            flags = [f.valid_mask() if k in sparse else ones for k, f in names.items()]
        else:  # the keys of the non-null values
            names = {k[5:]: f for k, f in s.fields.items() if k.startswith("prop:")}
            flags = [f.valid_mask() for f in names.values()]
        return _flag_lists(dict(zip(names, flags)), s.valid, self.n, s.data.device)

    def _range(self, args: List[E.Expr]) -> Column:
        """``range(a, b[, step])`` per row, a constant non-zero step."""
        step = self._const_value(args[2]) if len(args) > 2 else 1
        if step is _NOT_CONST or not isinstance(step, int) or isinstance(step, bool):
            raise TpuUnsupportedExpr("range() with a step that is not a constant integer")
        if step == 0:
            from ...ir.functions import lookup

            lookup("range").fn(0, 0, 0)
        a, b = self._int_arg(args[0]), self._int_arg(args[1])
        valid = a.valid_mask() & b.valid_mask()
        span = (b.data - a.data) if step > 0 else (a.data - b.data)
        lens = torch.where(valid & (span >= 0), span // abs(step) + 1, torch.zeros_like(span))
        fault_point("expr")  # the element total read below
        with host_sync("expr"):
            total = int(lens.sum())
        dev = lens.device
        # tpulint: allow[pad-invariant] reason=range() elements are the answer's list values: the child is sized by their exact total
        parent = torch.repeat_interleave(
            torch.arange(self.n, dtype=torch.int64, device=dev), lens, output_size=total
        )
        k = torch.arange(total, dtype=torch.int64, device=dev) - (torch.cumsum(lens, 0) - lens)[parent]
        child = Column(I64, a.data[parent] + step * k, None)
        return LS.list_column(lens, child,
                              None if a.valid is None and b.valid is None else valid)

    def _add_lists(self, l: Column, r: Column) -> Column:
        """``list + list`` per row, and ``list + value`` / ``value + list``
        with the value as a one-element list; null if either side is."""
        valid = _and_valid(l, r)
        l = l if l.kind == LST else LS.singleton_lists(l)
        r = r if r.kind == LST else LS.singleton_lists(r)
        return LS.concat_rows(l, r, valid)

    def _add_strings(self, l: Column, r: Column) -> Column:
        """String ``+``: a non-string side becomes strings first (once per
        distinct value, the local oracle's rendering), then the host joins
        each distinct pair of codes once (``torch.unique`` over the pairs),
        and one gather maps the rows onto a new sorted vocab."""
        l, r = self._as_str(l), self._as_str(r)
        valid = l.valid_mask() & r.valid_mask()
        with host_sync("expr"):
            # tpulint: allow[pad-invariant] reason=exact compaction of the valid string pairs to concatenate over the vocab: value columns carry no pad lanes
            rows = torch.nonzero(valid).squeeze(1)
        pairs = torch.stack([l.data[rows].to(torch.int64), r.data[rows].to(torch.int64)], 1)
        with host_sync("expr"):
            uniq, inv = torch.unique(pairs, dim=0, return_inverse=True)
        lv, rv = l.vocab or [], r.vocab or []
        outs = [lv[a] + rv[b] for a, b in to_host(uniq, "expr").tolist()]
        codes = torch.full((self.n,), -1, dtype=torch.int64, device=l.data.device)
        codes[rows] = inv
        return _lut_apply(codes, None if l.valid is None and r.valid is None else valid, outs)

    def _as_str(self, c: Column) -> Column:
        if c.kind == STR:
            return c
        if c.kind in (I64, F64, BOOL):
            return self._distinct_apply(c, _concat_string)
        if c.is_all_null():
            return Column(STR, torch.full((self.n,), -1, dtype=torch.int32, device=c.data.device),
                          self._falses(), [])
        raise TpuUnsupportedExpr(f"string concatenation with {c.kind}")

    def _concatenable(self, c: Column) -> bool:
        """Whether string ``+`` takes ``c``: a string, a number, a boolean
        or a column of nulls."""
        return c.kind in (STR, I64, F64, BOOL) or c.is_all_null()

    def _where_nested(self, take, a: Column, b: Column) -> Column:
        """``where(take, a, b)`` row by row for list, map, element or mixed
        columns, or columns of two kinds: one concatenation (which unifies
        the kinds, or mixes them) and one gather."""
        both = b.concat(a)
        if both.kind == OBJ:
            raise TpuUnsupportedExpr(f"branches over {_obj_item(both)}")
        rows = torch.arange(self.n, dtype=torch.int64, device=take.device)
        return both.take(torch.where(take, rows + self.n, rows))

    # -- temporal values ------------------------------------------------------

    def _oracle_raise(self, build, cols: List[Column], mask=None) -> Column:
        """Raise the local oracle's own error for the expression ``build``
        makes, at the first row of ``mask`` (default: the first row where
        no operand is null): one device read. Where no row qualifies the
        oracle raises nothing and the result is null; where the oracle
        answers after all, the port lacks the case and raises."""
        if mask is None:
            mask = torch.ones(self.n, dtype=torch.bool, device=_device.get())
            for c in cols:
                mask = mask & c.valid_mask()
        with host_sync("expr"):
            # tpulint: allow[pad-invariant] reason=the first row to raise the oracle's error from: a one-row read, not a lane extent
            first = torch.nonzero(mask)[:1].squeeze(1)
        if int(first.shape[0]) == 0:
            return constant_column(None, self.n)
        _oracle(build)(*(c.take(first).to_values()[0] for c in cols))
        raise TpuUnsupportedExpr(f"{build.__name__} over {[c.kind for c in cols]}")

    def _temporal_accessor(self, inner: Column, key: str) -> Column:
        """A calendar field, a zone field or a duration component as torch
        ops over the payload; any other key runs the oracle's accessor once
        per distinct value (which raises the oracle's own error for a key
        the kind lacks)."""
        k = key.lower()
        us = TP.US_PER_SECOND
        out = None
        off = TP.column_offset(inner.vocab) if inner.kind in (ZDT, ZT) else 0
        if inner.kind in (ZDT, ZT) and k in ("timezone", "offset"):
            return Column(STR, torch.zeros(self.n, dtype=torch.int32, device=inner.data.device),
                          inner.valid, [TP.offset_str(off)])
        if inner.kind in (ZDT, ZT) and k in ("offsetminutes", "offsetseconds"):
            v = off // 60 if k == "offsetminutes" else off
            return Column(I64, torch.full((self.n,), v, dtype=torch.int64,
                                          device=inner.data.device), inner.valid)
        if inner.kind == DATE:
            out = TP.date_accessor(k, inner.data)
        elif inner.kind == ZDT and k in ("epochseconds", "epochmillis"):
            out = TP.fdiv(inner.data, us if k == "epochseconds" else 1000)
        elif inner.kind in (LDT, ZDT):
            # the civil fields read the local clock
            days, tod = TP.split_ldt(inner.data + off * us)
            out = TP.date_accessor(k, days)
            if out is None:
                out = TP.time_accessor(k, tod)
        elif inner.kind in (ZT, LT):
            out = TP.time_accessor(k, torch.remainder(inner.data + off * us, TP.US_PER_DAY))
        elif inner.kind == DUR:
            m, d, u = inner.data.unbind(1)
            acc = {
                "years": lambda: TP.fdiv(m, 12),
                "months": lambda: m,
                "monthsofyear": lambda: torch.remainder(m, 12),
                "weeks": lambda: TP.fdiv(d, 7),
                "days": lambda: d,
                "hours": lambda: TP.fdiv(u, 3600 * us),
                "minutes": lambda: TP.fdiv(u, 60 * us),
                "seconds": lambda: TP.fdiv(u, us),
                "milliseconds": lambda: TP.fdiv(u, 1000),
                "microseconds": lambda: u,
            }.get(k)
            out = acc() if acc is not None else None
        if out is None:
            return self._per_tuple([inner], _oracle(lambda v: E.Property(v, key)))
        return Column(I64, out, inner.valid)

    def _temporal_arith(self, expr, l: Column, r: Column) -> Column:
        """``+``/``-`` of durations and a temporal plus or minus a duration
        as torch ops; a duration times or over a number once per distinct
        pair; any other operand mix raises the oracle's error (``date +
        date``: "Cannot add ...")."""
        add, sub = isinstance(expr, E.Add), isinstance(expr, E.Subtract)
        valid = _and_valid(l, r)
        if (add or sub) and l.kind == r.kind == DUR:
            return Column(DUR, l.data + r.data if add else l.data - r.data, valid)
        if (add or sub) and l.kind in TEMPORAL_KINDS and r.kind == DUR:
            return self._shift(expr, [l, r], l, r.data if add else -r.data, valid)
        if add and l.kind == DUR and r.kind in TEMPORAL_KINDS:
            return self._shift(expr, [l, r], r, l.data, valid)
        if (isinstance(expr, E.Multiply) and {l.kind, r.kind} in ({DUR, I64}, {DUR, F64})) or (
                isinstance(expr, E.Divide) and l.kind == DUR and r.kind in (I64, F64)):
            return self._per_tuple([l, r], _oracle(type(expr)))
        return self._oracle_raise(type(expr), [l, r])

    def _shift(self, expr, operands, t: Column, dur, valid) -> Column:
        """The temporal column ``t`` (one of ``expr``'s ``operands``) plus
        the (months, days, microseconds) rows ``dur``, as the oracle adds
        them: a time keeps only the time part and wraps on its local
        clock; a date or datetime steps its months (the day clamped to the
        month's end), then its days and time. A result outside years 1 to
        9999 raises the oracle's error. A date plus a time part becomes a
        datetime, and a column where some rows would and some would not
        raises (ROADMAP.md §3)."""
        months, ddays, dmic = dur.unbind(1)
        off_us = TP.column_offset(t.vocab) * TP.US_PER_SECOND if t.kind in (ZDT, ZT) else 0
        if t.kind in (ZT, LT):
            out = torch.remainder(t.data + off_us + dmic, TP.US_PER_DAY) - off_us
            return Column(t.kind, out, valid, t.vocab)
        local = t.data.to(torch.int64) * TP.US_PER_DAY if t.kind == DATE else t.data + off_us
        out, mid = TP.add_duration_micros(local, months, ddays, dmic)
        vm = valid if valid is not None else torch.ones(self.n, dtype=torch.bool, device=out.device)
        lo, hi = TP.MIN_DAYS * TP.US_PER_DAY, (TP.MAX_DAYS + 1) * TP.US_PER_DAY
        bad = vm & ((mid < TP.MIN_DAYS) | (mid > TP.MAX_DAYS) | (out < lo) | (out >= hi))
        fault_point("expr")  # the range-check counts read below
        if t.kind == DATE:
            timed = vm & (torch.remainder(dmic, TP.US_PER_DAY) != 0)
            with host_sync("expr"):
                nbad, ntimed, nvalid = (int(x) for x in torch.stack(
                    [bad.sum(), timed.sum(), vm.sum()]).tolist())
        else:
            with host_sync("expr"):
                nbad = int(bad.sum())
        if nbad:
            self._oracle_raise(type(expr), operands, bad)
        if t.kind == DATE:
            if ntimed == 0:
                return Column(DATE, TP.fdiv(out, TP.US_PER_DAY).to(torch.int32), valid)
            if ntimed == nvalid:
                return Column(LDT, out, valid)
            raise TpuUnsupportedExpr(
                f"a date plus durations of which some have a time part: {_MIXED_TEMPORAL}")
        if t.kind == LDT:
            return Column(LDT, out, valid)
        return Column(ZDT, out - off_us, valid, t.vocab)

    def _truncate(self, name: str, unit: str, arg: E.Expr) -> Column:
        """``date``/``localdatetime``/``datetime.truncate`` by a constant
        unit over a DATE, LDT or ZDT column, on its local clock. Any other
        input, and a unit the function refuses, run the oracle's function
        once per distinct value (which raises its error); a decade,
        century or millennium that starts before year 1 raises it too."""
        from ...ir.functions import lookup

        fn = lookup(name).fn
        inner = self.eval(arg)
        u = unit.lower()
        sub_day = u in TP.SUB_DAY_UNITS
        ok = inner.kind in (DATE, LDT, ZDT) and not (
            (name == "datetime.truncate" and inner.kind != ZDT)
            or (sub_day and (name == "date.truncate" or inner.kind == DATE))
        )
        got = None
        if ok:
            off_us = TP.column_offset(inner.vocab) * TP.US_PER_SECOND if inner.kind == ZDT else 0
            local = (inner.data.to(torch.int64) * TP.US_PER_DAY if inner.kind == DATE
                     else inner.data + off_us)
            got = TP.truncate_ldt_micros(u, local)
        if got is None:
            return self._per_tuple([inner], lambda v: fn(unit, v))
        out, first = got
        if first is not None:
            bad = inner.valid_mask() & (first < 1)
            fault_point("expr")  # the range check read below
            bad_any = torch.any(bad)
            with host_sync("expr"):
                any_bad = bool(bad_any)
            if any_bad:
                self._oracle_raise(lambda v: E.FunctionCall(name, (E.Lit(unit), v)), [inner], bad)
        if name == "date.truncate":
            return Column(DATE, TP.fdiv(out, TP.US_PER_DAY).to(torch.int32), inner.valid)
        if name == "localdatetime.truncate":
            return Column(LDT, out, inner.valid)
        return Column(ZDT, out - off_us, inner.valid, inner.vocab)

    def _between(self, name: str, a: Column, b: Column) -> Column:
        """``duration.between``/``inMonths``/``inDays``/``inSeconds`` of two
        DATE or LDT columns (a date as its midnight), as the oracle
        decomposes them: whole months toward zero from ``a`` (the day
        clamped), then whole days, then the time left, each with the sign
        of what is left."""
        day = TP.US_PER_DAY
        au = a.data.to(torch.int64) * day if a.kind == DATE else a.data
        bu = b.data.to(torch.int64) * day if b.kind == DATE else b.data
        valid = _and_valid(a, b)
        zero = torch.zeros_like(au)

        def dur(m, d, u):
            return Column(DUR, torch.stack([m, d, u], 1), valid)

        def whole_days(x):
            sign = torch.where(x >= 0, 1, -1)
            return sign * TP.fdiv(torch.abs(x), day)

        if name in ("duration.indays", "duration.inseconds"):
            x = bu - au
            return dur(zero, whole_days(x), zero) if name == "duration.indays" else dur(zero, zero, x)
        ay, am, _ = TP.civil_from_days(TP.split_ldt(au)[0])
        by, bm, _ = TP.civil_from_days(TP.split_ldt(bu)[0])
        months = (by - ay) * 12 + (bm - am)
        anchor, _ = TP.add_duration_micros(au, months, zero, zero)
        months = (months - ((months > 0) & (anchor > bu)).to(torch.int64)
                  + ((months < 0) & (anchor < bu)).to(torch.int64))
        if name == "duration.inmonths":
            return dur(months, zero, zero)
        anchor, _ = TP.add_duration_micros(au, months, zero, zero)
        left = bu - anchor
        days = whole_days(left)
        return dur(months, days, left - days * day)

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
        if name in _LIST_FUNCTIONS and expr.args:
            got = self._list_function(name, list(expr.args))
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
        if name in _TRUNCATE and len(expr.args) == 2 and isinstance(consts[0], str):
            return self._truncate(name, consts[0], expr.args[1])
        args = [self.eval(a) for a in expr.args]
        if name in _BETWEEN and len(args) == 2 and {a.kind for a in args} <= {DATE, LDT}:
            return self._between(name, args[0], args[1])
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
        fault_point("expr")  # the range check read below
        bad_any = torch.any(bad)
        with host_sync("expr"):
            any_bad = bool(bad_any)
        if any_bad:
            with host_sync("expr_raise"):
                first_bad = float(d[bad][0])
            lookup("tointeger").fn(first_bad)
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
        if len(live) > 1:
            # once per distinct tuple of the live arguments
            if f.null_prop and any(c is None for c in consts):
                return constant_column(None, self.n)

            def per_tuple(*vals, _c=consts, _l=live, _f=f.fn):
                a = list(_c)
                for i, v in zip(_l, vals):
                    a[i] = v
                return _f(*a)

            return self._per_tuple([args[i] for i in live], per_tuple)
        pos = live[0]
        col = args[pos]
        if col.kind == OBJ:
            raise TpuUnsupportedExpr(f"{name}() over object values: {_obj_item(col)}")
        if f.null_prop and any(c is None for i, c in enumerate(consts) if i != pos):
            return constant_column(None, self.n)
        if col.kind == STRUCT and col.tag == MAP:
            # a map argument (``date({year: ...})``): once per distinct
            # tuple of its values
            keys = list(col.fields)

            def per_map(*vals, _c=consts, _p=pos, _f=f.fn):
                a = list(_c)
                a[_p] = dict(zip(keys, vals))
                return _f(*a)

            return self._per_tuple([col.fields[k] for k in keys], per_map)

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
        """``fn`` once per distinct valid value of a scalar column."""
        return self._per_tuple([col], fn)

    def _per_tuple(self, cols: List[Column], fn) -> Column:
        """``fn`` once per distinct tuple of the columns' values over the
        rows where none is null (null elsewhere). The tuples are told apart
        on the device by ``torch.unique`` over their int64 payloads (an F64
        by its bits, so -0.0 and 0.0 differ, and by its intness; a duration
        by its three components; a list, map or mixed value by its rank);
        one gather brings a row of each to the host, where it decodes as
        the values it holds."""
        keys, valid = [], None
        for c in cols:
            if c.kind == OBJ:
                raise TpuUnsupportedExpr(f"a function of {_obj_item(c)}")
            if c.kind in NESTED_KINDS:  # equal values share their rank
                keys.append(V.rank(c).data)
            elif c.kind == F64:
                keys.append(c.data.view(torch.int64))
                if c.int_flag is not None:
                    keys.append(c.int_flag.to(torch.int64))
            elif c.kind == DUR:
                keys.extend(c.data.unbind(1))
            else:
                keys.append(c.data.to(torch.int64))
            if c.valid is not None:
                valid = c.valid if valid is None else valid & c.valid
        key = keys[0] if len(keys) == 1 else torch.stack(keys, 1)
        with host_sync("expr"):
            # tpulint: allow[pad-invariant] reason=exact compaction of the valid rows a per-tuple host function maps: value columns carry no pad lanes
            rows = None if valid is None else torch.nonzero(valid).squeeze(1)
        sel = key if rows is None else key[rows]
        if sel.dim() == 1:
            with host_sync("expr"):
                uniq, inv = torch.unique(sel, return_inverse=True)
        else:
            with host_sync("expr"):
                uniq, inv = torch.unique(sel, dim=0, return_inverse=True)
        src = torch.arange(int(sel.shape[0]), dtype=torch.int64, device=sel.device)
        if rows is not None:
            src = rows
        rep = torch.zeros(int(uniq.shape[0]), dtype=torch.int64, device=sel.device).scatter_reduce(
            0, inv, src, "amin", include_self=False)
        values = list(zip(*(c.take(rep).to_values() for c in cols))) if len(rep) else []
        if rows is None:
            codes = inv
        else:
            codes = torch.full((self.n,), -1, dtype=inv.dtype, device=inv.device)
            codes[rows] = inv
        return _lut_apply(codes, valid, [fn(*v) for v in values])


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The remainder of non-negative float64 tensors (``torch.remainder``'s
    and ``fmod``'s, which agree there), exact as IEEE's fmod is: the
    card's ``torch.fmod`` is; a CPU tensor takes numpy's, since torch's CPU
    kernel returns NaN where the quotient overflows in some versions."""
    if a.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            # tpulint: allow[host-sync, sync-span] reason=the CPU branch: a and b live in host memory, no device read
            return torch.from_numpy(np.fmod(a.numpy(), b.numpy()))
    return torch.fmod(a, b)


def _scalar_constant(value, n: int) -> Column:
    """A folded constant as a device column; a nested or mixed list and a
    zoned value named by its region have no device column kind."""
    col = constant_column(value, n)
    if col.kind != OBJ:
        return col
    raise TpuUnsupportedExpr(f"constant {type(value).__name__} value: "
                             f"{_obj_item(col)}")


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
        # list, map or temporal results: one value per code, gathered by
        # the codes
        table = Column.from_values(outs)
        if table.kind == OBJ:
            raise TpuUnsupportedExpr(
                f"a function result of mixed or nested values: {_obj_item(table)}")
        ok = (codes >= 0) if valid is None else (codes >= 0) & valid
        return table.take_or_null(torch.where(ok, codes.to(torch.int64), 0), ok)
    ok = np.array([o is not None for o in outs] + [False], dtype=bool)
    vals = np.array([o if o is not None else 0 for o in outs] + [0], dtype=dtype)
    vmask = torch.from_numpy(ok).to(dev)[safe]
    if valid is not None:
        vmask = vmask & valid
    return Column(kind, torch.from_numpy(vals).to(dev)[safe], vmask)


def _concat_string(v) -> str:
    """A non-string operand of string ``+`` as the local oracle renders it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    return to_cypher_string(v)


def _flag_lists(flags: Dict[str, torch.Tensor], valid, n: int, dev) -> Column:
    """Per row, the sorted names whose flag is set (``labels``, ``keys``):
    an LST of STR over the sorted names as its vocab."""
    names = sorted(flags)
    if not names:
        return LS.list_column(torch.zeros(n, dtype=torch.int64, device=dev),
                              Column(STR, torch.zeros(0, dtype=torch.int32, device=dev), None, []),
                              valid)
    mat = torch.stack([flags[k] for k in names], 1)
    if valid is not None:
        mat = mat & valid[:, None]
    with host_sync("expr"):
        # tpulint: allow[pad-invariant] reason=the (row, flag) pairs are the list values themselves: an exact compaction
        rows_cols = torch.nonzero(mat)
    child = Column(STR, rows_cols[:, 1].to(torch.int32), None, names)
    return LS.list_column(mat.sum(1), child, valid)


def _path_list(path: Column, name: str) -> Column:
    """A path's node or relationship list, null where the path is."""
    f = path.field(name)
    if path.valid is None:
        return f
    return f.take_or_null(torch.arange(len(path), device=path.valid.device), path.valid)


def _put_rows(acc: Column, rows, vals: Column, n: int) -> Column:
    """``acc`` with its rows ``rows`` replaced by ``vals``: one
    concatenation (which unifies or mixes the kinds) and one gather."""
    both = acc.concat(vals)
    if both.kind == OBJ:
        raise TpuUnsupportedExpr(f"a fold over {_obj_item(both)}")
    idx = torch.arange(n, dtype=torch.int64, device=rows.device)
    idx[rows] = n + torch.arange(int(rows.shape[0]), dtype=torch.int64, device=rows.device)
    return both.take(idx)


def _identity_of(col: Column) -> Tuple[Optional[str], Column]:
    """(tag, id column) of an element value; (None, ``col``) otherwise."""
    if col.kind == STRUCT and col.tag in (NODE, REL):
        return col.tag, Column(I64, col.field("id").data, col.valid)
    return None, col


def _where(take, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` by row, for one value per row or a duration's three."""
    return torch.where(take[:, None] if a.dim() == 2 else take, a, b)


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
