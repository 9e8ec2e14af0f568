"""Expr -> torch evaluator over device columns.

The port of the slice's part of ``tpu_cypher/backend/tpu/compiler.py``.
On device it evaluates header-resident columns (properties, ids, label
flags already materialized by the scans), literals, parameters,
graph-tag prefixes, null tests and the predicates ``filter`` needs:
``NOT``/``AND``/``OR``/``XOR`` in three-valued logic, ``=``/``<>``, the
four ordered comparisons and ``IN`` over a literal list. Every other kind
raises ``TpuUnsupportedExpr``, as the reference does for what it cannot
compile. The reference then evaluates the expression as a host island on
its local oracle; the port does not, so the error reaches the caller.
Arithmetic, CASE, functions and string predicates come with ROADMAP.md
queue 1, item 6, and temporal kinds with item 7.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
    _unify_vocab,
    constant_column,
)


class TpuUnsupportedExpr(TpuBackendError):
    pass


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
        if isinstance(expr, E.PrefixId):
            inner = self.eval(expr.expr)
            if inner.kind != I64:
                raise TpuUnsupportedExpr("prefix on non-id column")
            return Column(I64, inner.data | (int(expr.tag) << 54), inner.valid)
        if isinstance(expr, E.IsNull):
            inner = self.eval(expr.expr)
            return Column(BOOL, ~inner.valid_mask(), None)
        if isinstance(expr, E.IsNotNull):
            inner = self.eval(expr.expr)
            return Column(BOOL, inner.valid_mask(), None)
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
        raise TpuUnsupportedExpr(type(expr).__name__)

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
        l, r = self.eval(expr.lhs), self.eval(expr.rhs)
        if OBJ in (l.kind, r.kind):
            raise TpuUnsupportedExpr("equality on object columns")
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
            raise TpuUnsupportedExpr("comparison on object columns")
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
            raise TpuUnsupportedExpr("IN on non-literal list")
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


def _and_valid(l: Column, r: Column):
    if l.valid is None and r.valid is None:
        return None
    return l.valid_mask() & r.valid_mask()
