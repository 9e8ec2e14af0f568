"""Factorized (compressed) join intermediates: prefix x suffix runs.

The port of ``tpu_cypher/backend/tpu/factorized.py``. A ``FactorizedTable``
is a flat *prefix* table (one lane per path prefix, a ``CudaTable``) plus
one or more *run levels*, each a ``(lo, cnt)`` pair of per-lane ranges into
a sorted CSR domain: the adjacency slice ``ci[lo[i]:lo[i]+cnt[i]]`` is lane
``i``'s suffix run. The logical row set is the lazy cross product

    rows = sum_i  prod_j  cnt_j[i]

which never materializes unless an operator needs flat rows. Relational
ops run on the compressed form where multiplicity allows it:

* select/rename/drop/project — column bookkeeping only;
* filter / with_columns on prefix columns, at the lane domain;
* count/sum/avg — run-length weighted segment sums
  (``parallel.agg.weighted_segment_partials``, on the ``segment_agg``
  gate); min/max and DISTINCT aggregates are multiplicity-invariant and
  run on the nonempty prefix;
* DISTINCT / distinct_count on prefix columns (nonempty lanes);
* ORDER BY (/LIMIT) as a stable lane permutation: the flat enumeration
  order is (lane, suffix) and the sort is stable, so permuting lanes
  reproduces the flat order exactly, ties included;
* skip/limit/collect by lazy decompression, chunk by chunk, and
  ``rows_chunked`` for the serving cursor.

Everything else (joins, UNWIND, weight-sensitive aggregates) flattens
first through ``to_flat_table``, which is admission-guarded, so a flat
blowup surfaces as ``AdmissionRejected`` instead of an out-of-memory.

Differences by design from the reference: lanes and every decompression
chunk are sized exactly (no bucket lattice: eager PyTorch compiles no
program per shape), so there are no pad lanes to mask and no sentinel in
the weight cumsum. The decode's lane search, for each flat row its lane
and its remainder within the lane, is the function the ``expand_rows``
kernel computes (the lanes are the frontier rows, the weights their
degrees), so every chunk runs on that gate (``decode_lanes``); the
reference runs ``searchsorted`` over the cumsum.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...api import types as T
from ...api.table import Table
from ...api.types import CypherType
from ...ir import expr as E
from ...obs import trace as _obs_trace
from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from . import bucketing
from . import jit_ops as J
from . import lists as LS
from .column import F64, I64, OBJ, Column, TpuBackendError
from .compiler import CudaEvaluator, TpuUnsupportedExpr
from .table import CudaTable, ensure_flat

_INT32_MAX = 2**31 - 1


def decompress_chunk_rows() -> int:
    """Logical rows per decompression chunk (floor 1024)."""
    from ...utils.config import FACTORIZE_CHUNK_ROWS

    return max(int(FACTORIZE_CHUNK_ROWS.get()), 1024)


class RunLevel(NamedTuple):
    """One suffix level: per-lane runs over a sorted CSR domain.

    ``lo``/``cnt`` are int64 tensors, one entry per lane. ``cols`` maps an
    output column name to ``(source_column, maps)``: a run position ``p``
    decodes through the gather-map chain left to right, e.g. a
    relationship property is ``(rel_scan_col, (eo,))`` and an expand's
    far-node property ``(node_scan_col, (ci, row_map))``."""

    lo: Any
    cnt: Any
    cols: Dict[str, Tuple[Column, Tuple[Any, ...]]]


def decode_lanes(W, w, lo: int, hi: int):
    """Flat rows ``[lo, hi)`` -> (lane, remainder within the lane), on the
    ``expand_rows`` gate. The lanes of weight above 0 between the chunk's
    two end lanes are the frontier and their weights the degrees, the
    first cut to the rows it holds in the chunk and the last stopped at
    ``hi``; every lane starts at 0 over an identity column index, so a
    merged lane's "neighbour" is its remainder, and the first lane's rows
    add the chunk's offset into it. The index spans the chunk, whatever
    the lanes weigh. One device read finds the end lanes; the chunk's rows
    are stamped on the trace span."""
    from .hopper import expand_materialize_counted

    n = hi - lo
    dev = W.device
    fault_point("expand")  # the end-lane read below
    ends = torch.searchsorted(
        W, torch.tensor([lo, hi - 1], dtype=torch.int64, device=dev), right=True
    )
    with host_sync("expand"):
        i0, i1, s0, s1 = torch.cat([ends, W[ends] - w[ends]]).tolist()
    off = lo - s0
    # both end lanes weigh more than 0, so they are the first and the last
    with host_sync("expand"):
        # tpulint: allow[pad-invariant] reason=a decode chunk's lanes of weight above 0 are its frontier: chunks are sized exactly, no pad lanes (module docstring)
        lanes = torch.nonzero(w[i0:i1 + 1]).squeeze(1)
    deg = w[lanes + i0]
    deg[-1] = hi - s1
    deg[0] -= off
    nlanes = int(lanes.shape[0])
    itype = torch.int32 if n <= _INT32_MAX else torch.int64
    # tpulint: allow[pad-invariant] reason=the decode's chunk is sized exactly on the expand_rows gate (no pad lanes to mask, module docstring); decompress_chunk_rows bounds it
    row, inner, _, _ = expand_materialize_counted(
        torch.zeros(nlanes, dtype=itype, device=dev),
        torch.arange(n, dtype=itype, device=dev), None,
        torch.arange(nlanes, dtype=torch.int64, device=dev), deg, n,
        size=bucketing.exact_size(n), with_orig=False,
    )
    if off:
        inner = torch.where(row == 0, inner + off, inner)
    return lanes[row] + i0, inner


def _expr_cols(expr, header) -> set:
    """Every header column an expression may touch: the mapped column of
    each sub-expression, and all columns of any element variable it names
    (element comparisons resolve through id columns). Over-collection is
    safe: it only sends the op down the flat path."""
    cols = set()
    for sub in expr.iter_nodes():
        c = header.get(sub)
        if c is not None:
            cols.add(c)
        if isinstance(sub, E.Var):
            for e2 in header.expressions_for(sub):
                c2 = header.get(e2)
                if c2 is not None:
                    cols.add(c2)
    return cols


class FactorizedTable(Table):
    """A prefix ``CudaTable`` plus suffix run levels (module docstring).

    ``nrows`` (the flat row total) may be passed by producers that know it
    already; otherwise construction reads it from the device once."""

    def __init__(
        self,
        prefix: CudaTable,
        levels: Sequence[RunLevel],
        nrows: Optional[int] = None,
    ):
        self._prefix = prefix
        self._levels = tuple(levels)
        if not self._levels:
            raise TpuBackendError("factorized table needs at least one run level")
        nlanes = prefix.size
        for lv in self._levels:
            if int(lv.lo.shape[0]) != nlanes or int(lv.cnt.shape[0]) != nlanes:
                raise TpuBackendError("factorized level arrays disagree on lane count")
        for c in prefix._cols.values():
            if len(c) != nlanes:
                raise TpuBackendError("factorized prefix misaligned with run levels")
        self._nlanes = nlanes
        self._w, self._W, tot = J.runs_weights(
            tuple(lv.cnt for lv in self._levels), nlanes
        )
        if nrows is None:
            fault_point("expand")  # the flat-total read below
            with host_sync("expand"):
                self._nrows = int(tot)
        else:
            self._nrows = int(nrows)
        self._flat_cache: Optional[CudaTable] = None
        self._nonempty_cache = None

    # -- metadata ----------------------------------------------------------

    def _level_col_names(self) -> set:
        out = set()
        for lv in self._levels:
            out.update(lv.cols)
        return out

    @property
    def run_count(self) -> int:
        """Suffix runs per level (= lanes)."""
        return self._nlanes

    @property
    def physical_columns(self) -> List[str]:
        out = list(self._prefix.physical_columns)
        for lv in self._levels:
            out.extend(c for c in lv.cols if c not in out)
        return out

    def column_type(self, col: str) -> CypherType:
        if self._nrows == 0:
            return T.CTVoid
        if col in self._prefix._cols:
            return self._prefix.column_type(col)
        return self._source_column(col).cypher_type()

    @property
    def size(self) -> int:
        return self._nrows

    def __repr__(self) -> str:
        return (
            f"FactorizedTable({self._nrows} rows = {self._nlanes} lanes x "
            f"{len(self._levels)} levels, cols={self.physical_columns})"
        )

    # -- decompression -----------------------------------------------------

    def _source_column(self, col: str) -> Column:
        if col in self._prefix._cols:
            return self._prefix._cols[col]
        for lv in self._levels:
            if col in lv.cols:
                return lv.cols[col][0]
        raise KeyError(col)

    def _decode_chunk(self, lo: int, hi: int) -> CudaTable:
        """Flat rows ``[lo, hi)`` (non-empty) as a ``CudaTable``: the
        lanes and remainders from ``decode_lanes``, the run positions per
        level, then every column gathered — prefix columns at the lane,
        level columns through their gather-map chain."""
        i, inner = decode_lanes(self._W, self._w, lo, hi)
        pos = J.run_positions(
            i, inner, tuple(lv.lo for lv in self._levels),
            tuple(lv.cnt for lv in self._levels),
        )
        out: Dict[str, Column] = dict(self._prefix._take(i)._cols)
        for lv, p in zip(self._levels, pos):
            for c, (src, maps) in lv.cols.items():
                idx = p
                for m in maps:
                    idx = m[idx].to(torch.int64)
                out[c] = src.take(idx)
        return CudaTable(out, hi - lo)

    def _decompress_range(self, lo: int, hi: int) -> CudaTable:
        """One-shot flat materialization of rows ``[lo, hi)``, admission
        guarded, so an over-budget flatten raises the typed
        ``AdmissionRejected`` before anything is allocated."""
        lo = max(int(lo), 0)
        hi = min(int(hi), self._nrows)
        count = max(hi - lo, 0)
        bucketing.admit(count, 9 * max(len(self.physical_columns), 1), "factorized")
        if count == 0:
            return CudaTable(
                {c: _empty_like(self._source_column(c)) for c in self.physical_columns}, 0
            )
        return self._decode_chunk(lo, hi)

    def to_flat_table(self) -> CudaTable:
        """The whole flat table (memoized; admission guarded).
        ``ensure_flat`` duck-types on this method."""
        if self._flat_cache is None:
            self._flat_cache = self._decompress_range(0, self._nrows)
        return self._flat_cache

    def rows_chunked(self, chunk_rows: int) -> Iterator[List[Dict[str, Any]]]:
        """Bounded decompress-then-decode batches: the cursor's delivery
        path (``records.iter_chunks`` prefers it), so a result of any flat
        size streams at one chunk of device and host memory and is never
        flattened."""
        chunk_rows = max(int(chunk_rows), 1)
        for lo in range(0, self._nrows, chunk_rows):
            hi = min(lo + chunk_rows, self._nrows)
            yield list(self._decode_chunk(lo, hi).rows())

    def rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self.rows_chunked(decompress_chunk_rows()):
            yield from batch

    def column_values(self, col: str) -> List[Any]:
        out: List[Any] = []
        chunk = decompress_chunk_rows()
        for lo in range(0, self._nrows, chunk):
            hi = min(lo + chunk, self._nrows)
            out.extend(self._decode_chunk(lo, hi)._cols[col].to_values())
        return out

    # -- lane-domain helpers -----------------------------------------------

    def _take_lanes(self, idx) -> "FactorizedTable":
        """A lane subset (prefix rows and run bounds), in ``idx`` order."""
        levels = [
            RunLevel(lo2, cnt2, lv.cols)
            for lv, (lo2, cnt2) in zip(
                self._levels, (J.tree_take((lv.lo, lv.cnt), idx) for lv in self._levels)
            )
        ]
        return FactorizedTable(self._prefix._take(idx), levels)

    def _nonempty_exact(self):
        """(prefix rows whose lanes weigh more than 0, their weights, their
        count). Multiplicity-invariant ops (DISTINCT, min/max, group keys)
        see exactly the flat table's value set."""
        if self._nonempty_cache is None:
            idx, count = J.mask_to_idx(self._w > 0)
            self._nonempty_cache = (self._prefix._take(idx), self._w[idx], count)
        return self._nonempty_cache

    # -- column bookkeeping (no decompression) -----------------------------

    def _with(self, prefix: CudaTable, level_cols) -> "FactorizedTable":
        return FactorizedTable(
            prefix,
            [RunLevel(lv.lo, lv.cnt, cols) for lv, cols in zip(self._levels, level_cols)],
            nrows=self._nrows,
        )

    def select(self, cols: Sequence[str]) -> "FactorizedTable":
        lvl_names = self._level_col_names()
        missing = [c for c in cols if c not in self._prefix._cols and c not in lvl_names]
        if missing:
            raise KeyError(missing[0])
        return self._with(
            self._prefix.select([c for c in cols if c in self._prefix._cols]),
            [{c: lv.cols[c] for c in cols if c in lv.cols} for lv in self._levels],
        )

    def rename(self, mapping: Dict[str, str]) -> "FactorizedTable":
        return self._with(
            self._prefix.rename({k: v for k, v in mapping.items() if k in self._prefix._cols}),
            [{mapping.get(c, c): s for c, s in lv.cols.items()} for lv in self._levels],
        )

    def drop(self, cols: Sequence[str]) -> "FactorizedTable":
        d = set(cols)
        # a level whose columns all drop keeps its runs: the suffix
        # multiplicity still weighs every surviving row
        return self._with(
            self._prefix.drop([c for c in cols if c in self._prefix._cols]),
            [{c: s for c, s in lv.cols.items() if c not in d} for lv in self._levels],
        )

    def project(self, pairs) -> "FactorizedTable":
        return self._with(
            self._prefix.project([(o, n) for o, n in pairs if o in self._prefix._cols]),
            [{n: lv.cols[o] for o, n in pairs if o in lv.cols} for lv in self._levels],
        )

    def cache(self) -> "FactorizedTable":
        self._prefix.cache()
        if self._w.is_cuda:
            with host_sync("cache"):
                # tpulint: allow[host-sync] reason=the wait is what cache() promises its caller; it cannot be avoided
                torch.cuda.synchronize(self._w.device)
        return self

    # -- prefix-domain execution -------------------------------------------

    def _prefix_evaluable(self, exprs, header) -> bool:
        deps = set()
        for e in exprs:
            deps |= _expr_cols(e, header)
        return not (deps & self._level_col_names()) and deps <= set(self._prefix._cols)

    def filter(self, expr, header, parameters) -> Table:
        if not self._prefix_evaluable([expr], header):
            return self.to_flat_table().filter(expr, header, parameters)
        fault_point("filter")
        try:
            c = CudaEvaluator(self._prefix, header, parameters).eval(expr)
        except TpuUnsupportedExpr:
            return self.to_flat_table().filter(expr, header, parameters)
        if not c.flat:
            return self.to_flat_table().filter(expr, header, parameters)
        idx, _ = J.mask_to_idx(J.and_valid_mask(c.data, c.valid))
        return self._take_lanes(idx)

    def _alias_physical(self, src: str, dst: str) -> Optional["FactorizedTable"]:
        """Bind ``dst`` to the column ``src`` is (``dst`` replaced wherever
        it lives) without decompressing; None when ``src`` is absent."""
        pfx_cols = dict(self._prefix._cols)
        pfx_cols.pop(dst, None)
        levels = [dict(lv.cols) for lv in self._levels]
        for d in levels:
            d.pop(dst, None)
        if src in pfx_cols:
            pfx_cols[dst] = pfx_cols[src]
        else:
            for i, lv in enumerate(self._levels):
                if src in lv.cols:
                    levels[i][dst] = lv.cols[src]
                    break
            else:
                return None
        return self._with(CudaTable(pfx_cols, self._nlanes), levels)

    def with_columns(self, items, header, parameters) -> Table:
        # pure aliases of present columns stay compressed: a suffix-run
        # column projected into a RETURN name is the same runs under a
        # second name (the common RETURN <far>.prop AS x shape)
        out, residual = self, []
        for expr, name in items:
            src = header.column(expr) if expr in header else None
            if src == name and name in out.physical_columns:
                continue
            alias = out._alias_physical(src, name) if src is not None else None
            if alias is None:
                residual.append((expr, name))
            else:
                out = alias
        if not residual:
            return out
        if out is not self:
            return out.with_columns(residual, header, parameters)
        if not self._prefix_evaluable([e for e, _ in residual], header):
            return self.to_flat_table().with_columns(residual, header, parameters)
        new_pfx = self._prefix.with_columns(residual, header, parameters)
        return FactorizedTable(new_pfx, self._levels, nrows=self._nrows)

    def with_row_index(self, col: str) -> Table:
        return self.to_flat_table().with_row_index(col)

    def explode(self, expr, col: str, header, parameters) -> Table:
        return self.to_flat_table().explode(expr, col, header, parameters)

    def join(self, other, kind, join_cols) -> Table:
        return self.to_flat_table().join(ensure_flat(other), kind, join_cols)

    def union_all(self, other) -> Table:
        return self.to_flat_table().union_all(ensure_flat(other))

    # -- ordering ----------------------------------------------------------

    def _orderable_on_prefix(self, items) -> bool:
        return all(
            c in self._prefix._cols and self._prefix._cols[c].kind != OBJ for c, _ in items
        )

    def order_by(self, items: Sequence[Tuple[str, bool]]) -> Table:
        if not items:
            return self
        if not self._orderable_on_prefix(items):
            return self.to_flat_table().order_by(items)
        # the flat order is (lane, suffix) and the sort is stable, so
        # permuting lanes reproduces the flat sort, ties included
        keys = [self._prefix._key_col(c) for c, _ in items]
        idx = J.order_permutation(
            tuple(k.data for k in keys),
            tuple(k.valid for k in keys),
            tuple(k.kind for k in keys),
            tuple(bool(asc) for _, asc in items),
        )
        return self._take_lanes(idx)

    def order_by_limit(self, items: Sequence[Tuple[str, bool]], k: int) -> Optional[Table]:
        """ORDER BY + LIMIT without flattening: sort the lanes, then
        decompress only the first ``k`` flat rows. None (the caller sorts
        and limits) when a key is not a prefix column."""
        if not items or self._nrows == 0 or k == 0:
            return None
        if not self._orderable_on_prefix(items):
            return None
        return self.order_by(items).limit(min(k, self._nrows))

    def skip(self, n: int) -> Table:
        return self._decompress_range(min(n, self._nrows), self._nrows)

    def limit(self, n: int) -> Table:
        return self._decompress_range(0, min(n, self._nrows))

    # -- distinct / aggregation --------------------------------------------

    def distinct(self, cols: Optional[Sequence[str]] = None) -> Table:
        on = list(cols) if cols is not None else self.physical_columns
        if set(on) & self._level_col_names():
            return self.to_flat_table().distinct(cols)
        # only prefix columns: distinct rows are distinct prefix rows among
        # the lanes that carry at least one flat row
        pfx, _, _ = self._nonempty_exact()
        return pfx.distinct(cols)

    def distinct_count(self, cols: Sequence[str]) -> Optional[int]:
        if not cols or set(cols) & self._level_col_names():
            return None
        if not set(cols) <= set(self._prefix._cols):
            return None
        if self._nrows == 0:
            return 0
        pfx, _, _ = self._nonempty_exact()
        return pfx.distinct_count(cols)

    def group(self, by, aggregations, header, parameters) -> Table:
        try:
            got = self._group_factorized(by, aggregations, header, parameters)
        except (TpuUnsupportedExpr, TpuBackendError):
            got = None
        if got is not None:
            return got
        return self.to_flat_table().group(by, aggregations, header, parameters)

    def _group_factorized(self, by, aggregations, header, parameters):
        """Grouped aggregation on the compressed form, or None when an
        aggregate has no weighted form (collect, stDev, percentiles).

        A lane stands for ``w`` identical flat rows, so count/sum/avg are
        weighted segment sums, while min/max and DISTINCT aggregates are
        multiplicity-invariant and run on the nonempty prefix. The groups
        come from the nonempty lanes only: a lane of weight 0 gives no
        group, as in the flat table."""
        for _, agg in aggregations:
            if not isinstance(agg, E.Agg):
                return None
            name = agg.name.lower()
            if agg.distinct:
                if name not in ("count", "sum", "avg", "min", "max", "collect"):
                    return None
            elif name in ("sum", "avg", "min", "max"):
                if agg.expr is None:
                    return None
            elif name != "count":
                return None
        exprs = [agg.expr for _, agg in aggregations if agg.expr is not None]
        if not self._prefix_evaluable(exprs, header):
            return None
        if any(c not in self._prefix._cols or self._prefix._cols[c].kind == OBJ for c in by):
            return None
        fault_point("agg")
        if not by and all(
            agg.name.lower() == "count" and agg.expr is None for _, agg in aggregations
        ):
            # global count(*): the flat total is already known on the host
            return CudaTable(
                {
                    out_col: Column.from_numpy(np.array([self._nrows], np.int64))
                    for out_col, _ in aggregations
                },
                1,
            )
        from ...parallel.agg import weighted_segment_partials

        pfx, w, n = self._nonempty_exact()
        out_cols: Dict[str, Column] = {}
        if by and n > 0:
            order, flags, cnt = pfx._first_occurrence_index(by)
            k = int(cnt)
            seg_j, first_rows = J.group_index(order, flags, k=k)
            out_cols.update(pfx.select(by)._take(first_rows)._cols)
        elif by:  # no nonempty lane: the flat path's empty grouping
            return None
        else:  # global aggregation: one group, even over zero rows
            seg_j, k = None, 1
        ev = CudaEvaluator(pfx, header, parameters)
        for out_col, agg in aggregations:
            name = agg.name.lower()
            if agg.expr is None:  # count(*): every flat row counts
                _, wcnt = weighted_segment_partials(None, None, w, seg_j, k)
                out_cols[out_col] = Column(I64, wcnt, None)
                continue
            col = ev.identity(agg.expr) if name == "count" else ev.eval(agg.expr)
            if col.kind == OBJ:
                raise TpuUnsupportedExpr("object-valued aggregation input")
            if agg.distinct:
                seg_a = seg_j if seg_j is not None else torch.zeros(
                    n, dtype=torch.int64, device=w.device
                )
                if name == "count" and not col.flat:
                    col = LS.key_column(col)
                seg_a, col_a = pfx._dedup_seg_values(seg_a, col)
                if name == "collect":
                    fault_point("agg")
                    out_cols[out_col] = LS.collect(seg_a, col_a, k)
                else:
                    out_cols[out_col] = pfx._segment_agg(name, seg_a, col_a, k)
                continue
            if name in ("min", "max"):
                out_cols[out_col] = pfx._segment_agg(name, seg_j, col, k)
                continue
            if name == "count":
                _, wcnt = weighted_segment_partials(None, col.valid_mask(), w, seg_j, k)
                out_cols[out_col] = Column(I64, wcnt, None)
                continue
            # weighted sum/avg, value for value the flat segment semantics
            if col.kind not in (I64, F64) or col.int_flag is not None:
                raise TpuUnsupportedExpr(f"weighted {name} over {col.kind}")
            wsum, wcnt = weighted_segment_partials(col.data, col.valid, w, seg_j, k)
            if name == "avg":
                out_cols[out_col] = Column(
                    F64, wsum.to(torch.float64) / torch.clamp(wcnt, min=1), wcnt > 0
                )
            elif col.kind == F64:
                # Cypher sum over no values is the INTEGER 0
                empty = wcnt == 0
                any_empty = torch.any(empty)
                with host_sync("agg"):
                    iflag = empty if bool(any_empty) else None
                out_cols[out_col] = Column(
                    F64, torch.where(empty, torch.zeros_like(wsum), wsum), None, int_flag=iflag
                )
            else:
                out_cols[out_col] = Column(I64, wsum, None)
        return CudaTable(out_cols, k)


def _empty_like(src: Column) -> Column:
    if src.kind == OBJ:
        return Column.from_values([])
    if not src.flat:
        return src.take(torch.zeros(0, dtype=torch.int64, device=src.data.device))
    return Column(src.kind, src.data[:0], None, src.vocab)


def note_factorized(true_rows: int, padded_rows: int, run_count: int) -> None:
    """Stamp the factorized operator's span note: (flat rows, lane extent,
    run count); ``result.profile()`` reads it."""
    _obs_trace.note(
        "factorized",
        {
            "true_rows": int(true_rows),
            "padded_rows": int(padded_rows),
            "run_count": int(run_count),
        },
    )

