"""Expr -> torch evaluator over device columns.

The port of the slice's part of ``tpu_cypher/backend/tpu/compiler.py``.
On device it evaluates only the expression kinds the CSR expand slice's
projections and aggregates need: header-resident columns (properties,
ids, label flags already materialized by the scans), literals, parameters,
graph-tag prefixes and null tests. Every other kind raises
``TpuUnsupportedExpr``, as the reference does for what it cannot compile.
The reference then evaluates the expression as a host island on its local
oracle; the port does not, so the error reaches the caller. The rest of
the reference's device compiler comes with the classic Table SPI slice
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict

from ...ir import expr as E
from .column import BOOL, I64, Column, TpuBackendError, constant_column


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
        raise TpuUnsupportedExpr(type(expr).__name__)
