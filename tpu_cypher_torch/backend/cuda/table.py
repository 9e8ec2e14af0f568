"""CudaTable: the torch/CUDA columnar Table implementation.

The port of the slice's part of ``tpu_cypher/backend/tpu/table.py``
(``TpuTable``): columns are tensors on the backend's device
(``column.Column``) with validity masks. The port carries the Table SPI
methods that the CSR expand and WCOJ triangle plans call — construction
(``from_arrays``, ``from_numpy``, ``from_columns``), ``select``/
``rename``/``drop``/``project``, ``with_columns``, ``group`` (global
aggregates on device through the ``segment_agg`` kernel),
``rows``/``column_values`` and ``cache`` — plus the planner's fused-expand
and multiway-intersect hooks. Every other SPI method raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.

The reference answers an expression or aggregate it cannot compile with a
host island on its local oracle. The port keeps no host island: such a
call raises ``TpuUnsupportedExpr``, so device work never moves to the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ...api import types as T
from ...api.table import Table
from ...api.types import CypherType
from ...runtime.faults import fault_point
from . import device as _device
from .column import F64, I64, OBJ, Column
from .compiler import CudaEvaluator, TpuUnsupportedExpr

# ROADMAP.md queue 1 items that port the SPI methods this slice leaves out
_NEXT_SLICE = "queue 1, item 1 (classic Table SPI with the join_probe kernel)"


def _not_ported(method: str, item: str = _NEXT_SLICE):
    def fn(self, *args, **kwargs):
        raise NotImplementedError(
            f"CudaTable.{method} is not ported yet: ROADMAP.md {item}"
        )

    fn.__name__ = method
    return fn


class CudaTable(Table):
    def __init__(self, cols: Dict[str, Column], nrows: Optional[int] = None):
        self._cols = dict(cols)
        if nrows is None:
            nrows = next(iter(cols.values())).logical_len if cols else 0
        self._nrows = nrows
        self._depadded: Optional["CudaTable"] = None

    def _depad(self) -> "CudaTable":
        """Slice off bucket-pad rows (a bucketed expand's tail lanes)
        before an op that works on the logical rows."""
        if all(c.pad == 0 for c in self._cols.values()):
            return self
        if self._depadded is None:
            self._depadded = CudaTable(
                {c: col.depad() for c, col in self._cols.items()}, self._nrows
            )
        return self._depadded

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_columns(cols: Dict[str, List[Any]]) -> "CudaTable":
        return CudaTable({c: Column.from_values(v) for c, v in cols.items()})

    @staticmethod
    def from_numpy(cols: Dict[str, Any]) -> "CudaTable":
        """Bulk construction from numpy arrays (one copy per column)."""
        return CudaTable({c: Column.from_numpy(v) for c, v in cols.items()})

    @classmethod
    def from_arrays(cls, cols: Dict[str, Any]) -> "CudaTable":
        """Numeric/bool numpy arrays take the bulk path; anything else
        (value lists, string/object arrays) decodes per value."""
        out: Dict[str, Column] = {}
        for c, v in cols.items():
            if isinstance(v, np.ndarray) and (
                np.issubdtype(v.dtype, np.number) or v.dtype == np.bool_
            ):
                out[c] = Column.from_numpy(v)
            else:
                out[c] = Column.from_values(list(v))
        return CudaTable(out)

    @staticmethod
    def empty(columns: Sequence[str] = ()) -> "CudaTable":
        dev = _device.get()
        return CudaTable(
            {
                c: Column(I64, torch.zeros(0, dtype=torch.int64, device=dev), None)
                for c in columns
            },
            0,
        )

    @staticmethod
    def unit() -> "CudaTable":
        return CudaTable({}, 1)

    # -- metadata ---------------------------------------------------------

    @property
    def physical_columns(self) -> List[str]:
        return list(self._cols.keys())

    def column_type(self, col: str) -> CypherType:
        if self._nrows == 0:
            return T.CTVoid
        c = self._cols[col]
        if c.kind == OBJ:
            if c._obj_type is None:
                c._obj_type = T.join_types(T.type_of_value(v) for v in c.to_values())
            return c._obj_type
        return c.cypher_type()

    @property
    def size(self) -> int:
        return self._nrows

    def column_values(self, col: str) -> List[Any]:
        return self._cols[col].to_values()[: self._nrows]

    def rows(self) -> Iterator[Dict[str, Any]]:
        decoded = {
            c: col.to_values()[: self._nrows] for c, col in self._cols.items()
        }
        for i in range(self._nrows):
            yield {c: v[i] for c, v in decoded.items()}

    # -- simple ops --------------------------------------------------------

    def select(self, cols: Sequence[str]) -> "CudaTable":
        return CudaTable({c: self._cols[c] for c in cols}, self._nrows)

    def rename(self, mapping: Dict[str, str]) -> "CudaTable":
        return CudaTable(
            {mapping.get(c, c): v for c, v in self._cols.items()}, self._nrows
        )

    def drop(self, cols: Sequence[str]) -> "CudaTable":
        d = set(cols)
        return CudaTable(
            {c: v for c, v in self._cols.items() if c not in d}, self._nrows
        )

    def project(self, pairs) -> "CudaTable":
        return CudaTable({new: self._cols[old] for old, new in pairs}, self._nrows)

    def cache(self) -> "CudaTable":
        """Wait for every device column of this table to be computed."""
        for col in self._cols.values():
            if col.kind != OBJ and col.data.is_cuda:
                torch.cuda.synchronize(col.data.device)
                break
        return self

    # -- expressions --------------------------------------------------------

    def with_columns(self, items, header, parameters) -> "CudaTable":
        t = self._depad()
        out = dict(t._cols)
        ev = CudaEvaluator(t, header, parameters)
        for expr, col in items:
            out[col] = ev.eval(expr)
        return CudaTable(out, t._nrows)

    # -- grouped aggregation ------------------------------------------------

    _DEVICE_AGGS = frozenset({"count", "sum", "avg", "stdev", "stdevp", "min", "max"})

    def group(self, by, aggregations, header, parameters) -> "CudaTable":
        return self._depad()._group_device(by, aggregations, header, parameters)

    def _group_device(self, by, aggregations, header, parameters) -> "CudaTable":
        """Global aggregation (no grouping keys) on the device: one group,
        every aggregate a segment reduce through the ``segment_agg`` gate.
        Grouping keys, DISTINCT aggregates and the other aggregate names
        raise ``TpuUnsupportedExpr`` until the classic Table SPI slice
        ports the device group factorization."""
        from ...ir import expr as E

        if by:
            raise TpuUnsupportedExpr("grouping keys: ROADMAP.md " + _NEXT_SLICE)
        for _, agg in aggregations:
            if not isinstance(agg, E.Agg) or agg.name.lower() not in self._DEVICE_AGGS:
                raise TpuUnsupportedExpr(f"device agg {getattr(agg, 'name', agg)}")
            if agg.distinct:
                raise TpuUnsupportedExpr(f"device agg DISTINCT {agg.name}")
        n = self._nrows
        if all(agg.name.lower() == "count" and agg.expr is None for _, agg in aggregations):
            # global count(*): the row count is already host-known (the
            # fused count-only expand path ends here)
            return CudaTable(
                {
                    out_col: Column.from_numpy(np.array([n], np.int64))
                    for out_col, _ in aggregations
                },
                1,
            )
        dev = _device.get()
        seg_j = torch.zeros(n, dtype=torch.int64, device=dev)
        ev = CudaEvaluator(self, header, parameters)
        out_cols: Dict[str, Column] = {}
        for out_col, agg in aggregations:
            name = agg.name.lower()
            if agg.expr is None:  # count(*): every row counts
                out_cols[out_col] = Column(
                    I64, torch.tensor([n], dtype=torch.int64, device=dev), None
                )
                continue
            col = ev.eval(agg.expr)
            if col.kind == OBJ:
                raise TpuUnsupportedExpr("object-valued aggregation input")
            out_cols[out_col] = self._segment_agg(name, seg_j, col, 1)
        return CudaTable(out_cols, 1)

    def _segment_agg(self, name: str, seg_j, col: Column, k: int) -> Column:
        """One aggregator over (value column, group index) through the
        ``segment_agg`` kernel gate."""
        from .hopper import segment_aggregate

        fault_point("agg")
        kind = col.kind
        if name in ("sum", "avg", "stdev", "stdevp") and kind not in (I64, F64):
            raise TpuUnsupportedExpr(f"{name} over {kind}")
        out_data, out_valid, out_iflag, iflag_any = segment_aggregate(
            col.data, col.valid, col.int_flag, seg_j, name=name, kind=kind, k=k
        )
        if name == "count":
            return Column(I64, out_data, None)
        if out_iflag is not None and not bool(iflag_any):
            out_iflag = None  # canonical metadata: no integer rows at all
        out_kind = F64 if name in ("avg", "stdev", "stdevp") else kind
        return Column(out_kind, out_data, out_valid, col.vocab, int_flag=out_iflag)

    # -- not ported yet ----------------------------------------------------

    filter = _not_ported("filter")
    join = _not_ported("join")
    union_all = _not_ported("union_all")
    order_by = _not_ported("order_by")
    skip = _not_ported("skip")
    limit = _not_ported("limit")
    distinct = _not_ported("distinct")
    explode = _not_ported("explode")
    with_row_index = _not_ported("with_row_index")

    def __repr__(self) -> str:
        return f"CudaTable({self._nrows} rows, cols={self.physical_columns})"

    # -- planner capability hooks (fused CSR expand and WCOJ paths) ---------

    @staticmethod
    def plan_expand_fastpath(planner, op, lhs, rhs, classic):
        from .expand_op import plan_expand_fastpath

        return plan_expand_fastpath(planner, op, lhs, rhs, classic)

    @staticmethod
    def plan_multiway_intersect_fastpath(planner, op, in_plan, classic):
        from .wcoj import plan_multiway_intersect_fastpath

        return plan_multiway_intersect_fastpath(planner, op, in_plan, classic)

    @staticmethod
    def plan_filter_fastpath(planner, op, child):
        from .expand_op import plan_filter_fastpath

        return plan_filter_fastpath(planner, op, child)
