"""LocalTable: pure-Python columnar Table implementation.

The analog of the reference's backend tables (``FlinkTable.scala:49-201`` /
``SparkTable.scala:55-516``) but engine-free: columns are Python lists, and
expression evaluation uses the reference semantics in ``eval.py``. This
backend is the correctness oracle (acceptance + TCK suites run on it) that
the TPU backend is validated against — mirroring how the reference validates
backends against shared acceptance suites."""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ...api import types as T
from ...api.table import Table
from ...api.types import CypherType
from ...api.values import _equiv_key, order_key
from ...ir import expr as E
from .eval import Evaluator, aggregate_values


class LocalTable(Table):
    def __init__(self, cols: Dict[str, List[Any]], nrows: Optional[int] = None):
        self._cols: Dict[str, List[Any]] = dict(cols)
        if nrows is None:
            nrows = len(next(iter(cols.values()))) if cols else 0
        self._nrows = nrows
        for c, v in self._cols.items():
            if len(v) != nrows:
                raise ValueError(f"Column {c} length {len(v)} != {nrows}")

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_columns(cols: Dict[str, List[Any]]) -> "LocalTable":
        return LocalTable(cols)

    @staticmethod
    def from_rows(columns: Sequence[str], rows: Sequence[Sequence[Any]]) -> "LocalTable":
        cols = {c: [] for c in columns}
        for r in rows:
            for c, v in zip(columns, r):
                cols[c].append(v)
        return LocalTable(cols, len(rows))

    @staticmethod
    def empty(columns: Sequence[str] = ()) -> "LocalTable":
        return LocalTable({c: [] for c in columns}, 0)

    @staticmethod
    def unit() -> "LocalTable":
        """One row, no columns (the Start table)."""
        return LocalTable({}, 1)

    # -- metadata ---------------------------------------------------------

    @property
    def physical_columns(self) -> List[str]:
        return list(self._cols.keys())

    def column_type(self, col: str) -> CypherType:
        return T.join_types(
            T.type_of_value(v) for v in self._cols[col]
        ) if self._nrows else T.CTVoid

    @property
    def size(self) -> int:
        return self._nrows

    def rows(self) -> Iterator[Dict[str, Any]]:
        cols = self._cols
        for i in range(self._nrows):
            yield {c: v[i] for c, v in cols.items()}

    def column_values(self, col: str) -> List[Any]:
        return list(self._cols[col])

    def row_dicts(self) -> List[Dict[str, Any]]:
        # cached: tables are immutable and the evaluator asks once per expr
        cache = getattr(self, "_row_cache", None)
        if cache is None:
            cache = list(self.rows())
            self._row_cache = cache
        return cache

    # -- algebra ----------------------------------------------------------

    def select(self, cols: Sequence[str]) -> "LocalTable":
        return LocalTable({c: self._cols[c] for c in cols}, self._nrows)

    def rename(self, mapping: Dict[str, str]) -> "LocalTable":
        return LocalTable(
            {mapping.get(c, c): v for c, v in self._cols.items()}, self._nrows
        )

    def drop(self, cols: Sequence[str]) -> "LocalTable":
        dropset = set(cols)
        return LocalTable(
            {c: v for c, v in self._cols.items() if c not in dropset}, self._nrows
        )

    def filter(self, expr, header, parameters) -> "LocalTable":
        mask = Evaluator(self, header, parameters).evaluate(expr)
        keep = [i for i, v in enumerate(mask) if v is True]
        return self._take(keep)

    def _take(self, idx: List[int]) -> "LocalTable":
        return LocalTable(
            {c: [v[i] for i in idx] for c, v in self._cols.items()}, len(idx)
        )

    def join(self, other: "LocalTable", kind, join_cols) -> "LocalTable":
        if kind == "cross":
            return self._cross(other)
        lcols = [l for l, _ in join_cols]
        rcols = [r for _, r in join_cols]
        # hash join on equivalence keys; null join keys never match, and
        # neither do NaN keys: joins are planner rewrites of `=` predicates
        # (replaceCartesianWithValueJoin), and Cypher `NaN = NaN` is false —
        # matching them here would make the optimized plan differ from the
        # unoptimized Filter(Equals) it replaces
        def _no_match(key) -> bool:
            return any(
                k is None or (isinstance(k, float) and k != k) for k in key
            )

        build: Dict[Tuple, List[int]] = {}
        for j in range(other._nrows):
            key = tuple(other._cols[c][j] for c in rcols)
            if _no_match(key):
                key = None
            else:
                key = tuple(_equiv_key(k) for k in key)
                build.setdefault(key, []).append(j)
        left_idx: List[int] = []
        right_idx: List[Optional[int]] = []
        matched_right: set = set()
        for i in range(self._nrows):
            key = tuple(self._cols[c][i] for c in lcols)
            if _no_match(key):
                matches = []
            else:
                matches = build.get(tuple(_equiv_key(k) for k in key), [])
            if matches:
                for j in matches:
                    left_idx.append(i)
                    right_idx.append(j)
                    matched_right.add(j)
            elif kind in ("left_outer", "full_outer"):
                left_idx.append(i)
                right_idx.append(None)
        if kind in ("right_outer", "full_outer"):
            for j in range(other._nrows):
                if j not in matched_right:
                    left_idx.append(None)  # type: ignore[arg-type]
                    right_idx.append(j)
        out: Dict[str, List[Any]] = {}
        for c, v in self._cols.items():
            out[c] = [v[i] if i is not None else None for i in left_idx]
        for c, v in other._cols.items():
            if c in out:
                raise ValueError(f"Join column collision: {c}")
            out[c] = [v[j] if j is not None else None for j in right_idx]
        return LocalTable(out, len(left_idx))

    def _cross(self, other: "LocalTable") -> "LocalTable":
        out: Dict[str, List[Any]] = {}
        n, m = self._nrows, other._nrows
        for c, v in self._cols.items():
            out[c] = [v[i] for i in range(n) for _ in range(m)]
        for c, v in other._cols.items():
            if c in out:
                raise ValueError(f"Join column collision: {c}")
            out[c] = [v[j] for _ in range(n) for j in range(m)]
        return LocalTable(out, n * m)

    def union_all(self, other: "LocalTable") -> "LocalTable":
        if set(self._cols) != set(other._cols):
            raise ValueError(
                f"unionAll column mismatch: {sorted(self._cols)} vs {sorted(other._cols)}"
            )
        return LocalTable(
            {c: self._cols[c] + other._cols[c] for c in self._cols},
            self._nrows + other._nrows,
        )

    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "LocalTable":
        idx = list(range(self._nrows))

        def key(i):
            ks = []
            for col, asc in items:
                k = order_key(self._cols[col][i])
                ks.append(k if asc else _Reversed(k))
            return tuple(ks)

        idx.sort(key=key)
        return self._take(idx)

    def skip(self, n: int) -> "LocalTable":
        return self._take(list(range(min(n, self._nrows), self._nrows)))

    def limit(self, n: int) -> "LocalTable":
        return self._take(list(range(min(n, self._nrows))))

    def distinct(self, cols: Optional[Sequence[str]] = None) -> "LocalTable":
        on = list(cols) if cols is not None else self.physical_columns
        seen = set()
        keep = []
        for i in range(self._nrows):
            k = tuple(_equiv_key(self._cols[c][i]) for c in on)
            if k not in seen:
                seen.add(k)
                keep.append(i)
        return self._take(keep)

    def group(self, by, aggregations, header, parameters) -> "LocalTable":
        ev = Evaluator(self, header, parameters)
        agg_inputs = []
        for out_col, agg in aggregations:
            assert isinstance(agg, E.Agg)
            if agg.expr is None:
                values = [1] * self._nrows  # count(*) counts rows
            else:
                values = ev.evaluate(agg.expr)
            extra = [x.value if isinstance(x, E.Lit) else None for x in agg.extra]
            agg_inputs.append((out_col, agg, values, extra))
        groups: Dict[Tuple, List[int]] = {}
        order: List[Tuple] = []
        for i in range(self._nrows):
            k = tuple(_equiv_key(self._cols[c][i]) for c in by)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(i)
        if not by and not order:
            order.append(())
            groups[()] = []
        out: Dict[str, List[Any]] = {c: [] for c in by}
        for out_col, _, _, _ in agg_inputs:
            out[out_col] = []
        for k in order:
            idx = groups[k]
            if by:
                first = idx[0]
                for c in by:
                    out[c].append(self._cols[c][first])
            for out_col, agg, values, extra in agg_inputs:
                name = agg.name
                vals = [values[i] for i in idx]
                out[out_col].append(aggregate_values(name, vals, agg.distinct, extra))
        return LocalTable(out, len(order))

    def with_columns(self, items, header, parameters) -> "LocalTable":
        ev = Evaluator(self, header, parameters)
        out = dict(self._cols)
        for expr, col in items:
            out[col] = ev.evaluate(expr)
        return LocalTable(out, self._nrows)

    def project(self, pairs) -> "LocalTable":
        return LocalTable({new: self._cols[old] for old, new in pairs}, self._nrows)

    def with_row_index(self, col: str) -> "LocalTable":
        out = dict(self._cols)
        out[col] = list(range(self._nrows))
        return LocalTable(out, self._nrows)

    def explode(self, expr, col: str, header, parameters) -> "LocalTable":
        lists = Evaluator(self, header, parameters).evaluate(expr)
        idx: List[int] = []
        values: List[Any] = []
        for i, lst in enumerate(lists):
            if lst is None:
                continue  # UNWIND null produces no rows
            if not isinstance(lst, (list, tuple)):
                idx.append(i)
                values.append(lst)
                continue
            for v in lst:
                idx.append(i)
                values.append(v)
        out = {c: [v[i] for i in idx] for c, v in self._cols.items()}
        out[col] = values
        return LocalTable(out, len(idx))

    def __repr__(self) -> str:
        return f"LocalTable({self._nrows} rows, cols={self.physical_columns})"


class _Reversed:
    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        return other.k < self.k

    def __eq__(self, other):
        return self.k == other.k
