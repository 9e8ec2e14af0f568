"""CudaTable: the torch/CUDA columnar Table implementation.

The port of ``tpu_cypher/backend/tpu/table.py`` (``TpuTable``): columns are
tensors on the backend's device (``column.Column``) with validity masks.
The port carries the Table SPI — construction (``from_arrays``,
``from_numpy``, ``from_columns``), ``select``/``rename``/``drop``/
``project``, ``with_columns``, ``filter``, ``join`` (every kind; the probe
goes through the ``join_probe`` kernel), ``union_all`` (with kind
promotion), ``distinct``, ``order_by``, ``skip``, ``limit``,
``with_row_index``, ``group`` (grouped and global aggregates, count, sum,
min and max through the ``segment_agg`` kernel), ``rows``/
``column_values`` and ``cache``, ``explode`` (UNWIND, on the
``expand_rows`` gate) and ``from_rows`` — plus the ``order_by_limit`` and
``distinct_count`` hooks and the planner's fused-expand and
multiway-intersect hooks. List and element columns (``LST``, ``STRUCT``)
group, deduplicate and order through a scalar key column
(``lists.key_column``: an element's id, a list's dense rank), and
``collect`` builds its lists on the device.

The reference answers an expression or aggregate it cannot compile with a
host island on its local oracle. The port keeps no host island: such a
call raises ``TpuUnsupportedExpr``, so device work never moves to the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...api import types as T
from ...api.table import Table
from ...api.types import CypherType
from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from . import bucketing
from . import device as _device
from . import jit_ops as J
from . import lists as LS
from .column import (
    BOOL,
    DATE,
    DUR,
    F64,
    I64,
    INTEGRAL_KINDS,
    LST,
    MIX,
    NESTED_KINDS,
    OBJ,
    STR,
    TEMPORAL_KINDS,
    Column,
    TpuBackendError,
    _obj_array,
    _unify_vocab,
    to_host,
)
from .compiler import CudaEvaluator, TpuUnsupportedExpr, _obj_item


def ensure_flat(t):
    """A factorized table (``factorized.FactorizedTable``) in its flat
    ``CudaTable`` form; identity on anything already flat. Duck-typed on
    ``to_flat_table``, so this module never imports ``factorized`` (which
    imports this one). Every fused operator's input and the ``other`` side
    of a binary op pass through here; the flatten is admission-guarded, so
    an over-budget decompress raises ``AdmissionRejected``."""
    to_flat = getattr(t, "to_flat_table", None)
    return to_flat() if to_flat is not None else t


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
    def from_rows(columns: Sequence[str], rows: Sequence[Sequence[Any]]) -> "CudaTable":
        return CudaTable.from_columns(
            {c: [r[i] for r in rows] for i, c in enumerate(columns)}
        )

    @staticmethod
    def from_numpy(cols: Dict[str, Any]) -> "CudaTable":
        """Bulk construction from numpy arrays (one copy per column)."""
        return CudaTable({c: Column.from_numpy(v) for c, v in cols.items()})

    @classmethod
    def from_arrays(cls, cols: Dict[str, Any]) -> "CudaTable":
        """Numeric, bool and ``datetime64`` numpy arrays take the bulk path
        (``datetime64[D]`` a date, finer units a localdatetime); anything
        else (value lists, string/object arrays) decodes per value."""
        out: Dict[str, Column] = {}
        for c, v in cols.items():
            if isinstance(v, np.ndarray) and (
                np.issubdtype(v.dtype, np.number) or v.dtype == np.bool_
                or np.issubdtype(v.dtype, np.datetime64)
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

    def frame_columns(self) -> Dict[str, Any]:
        """Each column as a DataFrame column source (``Column.frame_values``):
        the filesystem source builds its part files from these, so a
        null-free number column reaches pandas as one array, not as a
        Python value per row."""
        t = self._depad()
        return {c: col.frame_values(t._nrows) for c, col in t._cols.items()}

    def rows_chunked(self, chunk_rows: int) -> Iterator[List[Dict[str, Any]]]:
        """Yield row dicts in batches of ``chunk_rows`` without decoding the
        whole result: per chunk each column decodes only its ``[lo, hi)``
        rows (``Column.to_values_range``). Cursor streaming
        (``records.iter_chunks``) runs on this, so its host memory stays
        one chunk however large the result."""
        chunk_rows = max(int(chunk_rows), 1)
        for lo in range(0, self._nrows, chunk_rows):
            hi = min(lo + chunk_rows, self._nrows)
            decoded = {
                c: col.to_values_range(lo, hi) for c, col in self._cols.items()
            }
            yield [
                {c: v[i] for c, v in decoded.items()} for i in range(hi - lo)
            ]

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

    def _take(self, idx) -> "CudaTable":
        """Gather every column by one index tensor."""
        n = int(idx.shape[0])
        dev = {
            c: (col.data, col.valid, col.int_flag)
            for c, col in self._cols.items()
            if col.flat
        }
        taken = J.cols_take(dev, idx) if dev else {}
        out: Dict[str, Column] = {}
        for c, col in self._cols.items():
            if not col.flat:
                out[c] = col.take(idx)
            else:
                d, v, i = taken[c]
                out[c] = Column(col.kind, d, v, col.vocab, int_flag=i)
        return CudaTable(out, n)

    def cache(self) -> "CudaTable":
        """Wait for every device column of this table to be computed."""
        for col in self._cols.values():
            if col.kind != OBJ and col.data.is_cuda:
                with host_sync("cache"):
                    # tpulint: allow[host-sync] reason=the wait is what cache() promises its caller; it cannot be avoided
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

    # -- filter ------------------------------------------------------------

    def filter(self, expr, header, parameters) -> "CudaTable":
        fault_point("filter")
        t = self._depad()
        c = CudaEvaluator(t, header, parameters).eval(expr)
        if not c.flat:
            raise TpuUnsupportedExpr(f"filter predicate of kind {c.kind}")
        idx, _ = J.mask_to_idx(J.and_valid_mask(c.data, c.valid), site="filter")
        return t._take(idx)

    # -- join --------------------------------------------------------------

    def join(self, other: "CudaTable", kind, join_cols) -> "CudaTable":
        other = ensure_flat(other)
        t, o = self._depad(), other._depad()
        if t is not self or o is not other:
            return t.join(o, kind, join_cols)
        if kind == "cross":
            n, m = self._nrows, other._nrows
            bucketing.admit(
                n * m, 9 * max(len(self._cols) + len(other._cols), 1), "join"
            )
            dev = _device.get()
            li = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(m)
            ri = torch.arange(m, dtype=torch.int64, device=dev).repeat(n)
            return self._combine(other, li, ri)
        if not join_cols:
            # keyless equi-join (uncorrelated OPTIONAL MATCH and friends):
            # every row matches every row; outer kinds pad when a side is empty
            if kind == "inner" or (self._nrows and other._nrows):
                return self.join(other, "cross", [])
            if kind == "left_outer":
                return self._join_empty_result(other, "left_outer")
            if kind == "right_outer" and other._nrows == 0:
                return self.join(other, "cross", [])
            return self._join_empty_result(other, "full_outer")
        if kind == "right_outer":
            # mirror of left_outer; the flipped _combine emits right-table
            # columns first, so restore canonical (left-first) column order
            flipped = [(r, l) for l, r in join_cols]
            res = other._join_keys_on_device(self, "left_outer", flipped)
            ordered = {c: res._cols[c] for c in (*self._cols, *other._cols)}
            return CudaTable(ordered, res._nrows)
        return self._join_keys_on_device(other, kind, join_cols)

    def _join_keys_on_device(self, other, kind, join_cols) -> "CudaTable":
        """A key pair where a side is a list, map, element or mixed value
        joins on their dense rank in Cypher order, taken over both sides
        together (``values.joint_rank``), as an int64 key pair on the
        ``join_probe`` gate: equal ranks are the oracle's equivalent keys.
        The reference answers such keys, and object-valued ones, on its
        host oracle; the port raises on object values."""
        from .values import joint_rank

        left, right = dict(self._cols), dict(other._cols)
        for l, r in join_cols:
            lc, rc = left[l], right[r]
            if OBJ in (lc.kind, rc.kind):
                raise TpuUnsupportedExpr(f"join on object keys: {_obj_item(lc, rc)}")
            if not (lc.flat and rc.flat):
                left[l], right[r] = joint_rank([lc, rc])
        return self._join_device(other, kind, join_cols, left, right)

    @staticmethod
    def _exact_key_pair(lc: Column, rc: Column):
        """One key pair on a common device encoding, or None when the kinds
        can never be equal: STR sides share one vocab; mixed I64/F64 joins
        as exact int64 (casting the int side to f64 would collapse ints
        above 2**53, where graph-tagged ids live). A temporal kind equals
        only its own kind (a date never equals a datetime): dates join as
        int64 days, zoned values on their UTC lanes whatever their
        offsets, durations on a dense rank of their components taken over
        both sides."""
        if lc.kind == STR or rc.kind == STR:
            if lc.kind != STR or rc.kind != STR:
                return None
            return _unify_vocab(lc, rc)
        if lc.kind in TEMPORAL_KINDS + (DUR,) or rc.kind in TEMPORAL_KINDS + (DUR,):
            if lc.kind != rc.kind:
                return None
            if lc.kind == DUR:
                with host_sync("join"):
                    _, rank = torch.unique(torch.cat([lc.data, rc.data]), dim=0, return_inverse=True)
                return (Column(I64, rank[:len(lc)], lc.valid),
                        Column(I64, rank[len(lc):], rc.valid))
            return (Column(I64, lc.data.to(torch.int64), lc.valid),
                    Column(I64, rc.data.to(torch.int64), rc.valid))
        if lc.kind != rc.kind:
            if {lc.kind, rc.kind} != {I64, F64}:
                return None
            if lc.kind == F64:
                return _float_as_exact_int(lc), rc
            return lc, _float_as_exact_int(rc)
        return lc, rc

    def _join_device(self, other, kind, join_cols, lkeys=None, rkeys=None) -> "CudaTable":
        """Device sort-probe equi-join: the build (right) side is sorted
        valid-first by key once, the probe side looks its keys up through
        the ``join_probe`` kernel gate, and the matches materialize as
        (left row, right row) pairs. Multi-key joins probe on the first key
        and post-filter the rest on device. ``lkeys``/``rkeys`` hold the
        key columns where they stand in for the tables' own."""
        from .hopper import join_probe

        fault_point("join")
        # the admission estimate per output row: the two int64 index lanes
        # plus 8 B data and 1 B mask per gathered column
        join_row_bytes = 16 + 9 * max(len(self._cols) + len(other._cols), 1)
        lkeys = self._cols if lkeys is None else lkeys
        rkeys = other._cols if rkeys is None else rkeys
        pair = self._exact_key_pair(lkeys[join_cols[0][0]], rkeys[join_cols[0][1]])
        if pair is None:  # cross-kind keys never match
            return self._join_empty_result(other, kind)
        lk, rk = pair
        # validity beyond the probe key's own: extra key columns must be
        # non-null to match
        l_extra = tuple(
            c.valid for c in (lkeys[l] for l, _ in join_cols[1:])
            if c.valid is not None
        )
        r_extra = tuple(
            c.valid for c in (rkeys[r] for _, r in join_cols[1:])
            if c.valid is not None
        )
        lvalids = l_extra + ((lk.valid,) if lk.valid is not None else ())
        rvalids = r_extra + ((rk.valid,) if rk.valid is not None else ())
        is_f64, is_bool = lk.kind == F64, lk.kind == BOOL
        rd_s, r_order, nvalid_dev = J.join_build(
            rk.data, rvalids, is_f64=is_f64, is_bool=is_bool
        )
        with host_sync("join_build"):
            nvalid = int(nvalid_dev)
        r_idx_valid, lo, counts, total_dev = join_probe(
            rd_s, r_order, lk.data, lvalids, nvalid,
            is_f64=is_f64, is_bool=is_bool,
        )
        with host_sync("join"):
            total = int(total_dev)
        bucketing.admit(total, join_row_bytes, "join")
        left_rows, right_rows = J.join_materialize(r_idx_valid, lo, counts, total)
        if len(join_cols) > 1 and total:
            left_rows, right_rows = self._extra_keys_filter(
                lkeys, rkeys, join_cols[1:], left_rows, right_rows
            )
        nmatched = int(left_rows.shape[0])
        left_matched = right_matched = None
        matched_right = right_rows
        if kind in ("left_outer", "full_outer"):
            miss_idx, nmiss = J.mask_to_idx(
                J.unmatched_mask(left_rows, self._nrows), site="join_outer"
            )
            left_rows, right_rows, right_matched = J.outer_pad_left(
                left_rows, right_rows, miss_idx, nmiss=nmiss, nmatched=nmatched
            )
        if kind == "full_outer":
            rmiss_idx, rnmiss = J.mask_to_idx(
                J.unmatched_mask(matched_right, other._nrows), site="join_outer"
            )
            left_rows, right_rows, left_matched, right_matched = J.outer_pad_right(
                left_rows, right_rows, right_matched, rmiss_idx,
                nmiss=rnmiss, ncur=int(left_rows.shape[0]),
            )
        return self._combine(other, left_rows, right_rows, right_matched, left_matched)

    def _extra_keys_filter(self, lkeys, rkeys, extra_cols, left_rows, right_rows):
        """Keep the match pairs whose every extra key pair is equal."""
        l_datas, l_valids, r_datas, r_valids, kinds = [], [], [], [], []
        for lcn, rcn in extra_cols:
            pair = self._exact_key_pair(lkeys[lcn], rkeys[rcn])
            if pair is None:  # a cross-kind key pair never matches
                empty = left_rows[:0]
                return empty, empty
            lc, rc = pair
            l_datas.append(lc.data)
            l_valids.append(lc.valid)
            r_datas.append(rc.data)
            r_valids.append(rc.valid)
            kinds.append(lc.kind)
        keep = J.extra_keys_keep(
            l_datas, l_valids, r_datas, r_valids, left_rows, right_rows, kinds
        )
        idx, _ = J.mask_to_idx(keep, site="join_keys")
        return J.tree_take((left_rows, right_rows), idx)

    def _join_empty_result(self, other: "CudaTable", kind) -> "CudaTable":
        """Key kinds can never be equal: inner = empty, outer = all-null."""
        dev = _device.get()

        def ar(n):
            return torch.arange(n, dtype=torch.int64, device=dev)

        def zeros(n, dtype=torch.int64):
            return torch.zeros(n, dtype=dtype, device=dev)

        def ones(n):
            return torch.ones(n, dtype=torch.bool, device=dev)

        if kind == "inner":
            return self._combine(other, zeros(0), zeros(0))
        nl, nr = self._nrows, other._nrows
        if kind == "left_outer":
            return self._combine(other, ar(nl), zeros(nl), zeros(nl, torch.bool), None)
        # full_outer: left rows with null right, then right rows with null left
        li = torch.cat([ar(nl), zeros(nr)])
        ri = torch.cat([zeros(nl), ar(nr)])
        rm = torch.cat([zeros(nl, torch.bool), ones(nr)])
        lm = torch.cat([ones(nl), zeros(nr, torch.bool)])
        return self._combine(other, li, ri, rm, lm)

    def _combine(
        self, other: "CudaTable", li, ri, right_in_bounds=None, left_in_bounds=None
    ) -> "CudaTable":
        """The joined table: left columns gathered by ``li``, right columns
        by ``ri``; lanes where an ``*_in_bounds`` mask is False come out
        null on that side (outer-join padding)."""
        for c in other._cols:
            if c in self._cols:
                raise TpuBackendError(f"Join column collision: {c}")
        out: Dict[str, Column] = {}
        for cols, idx, in_bounds in (
            (self._cols, li, left_in_bounds),
            (other._cols, ri, right_in_bounds),
        ):
            dev = {
                c: (col.data, col.valid, col.int_flag)
                for c, col in cols.items()
                if col.flat and (in_bounds is None or len(col) > 0)
            }
            if not dev:
                taken = {}
            elif in_bounds is None:
                taken = J.cols_take(dev, idx)
            else:
                taken = J.cols_take_or_null(dev, idx, in_bounds)
            for c, col in cols.items():
                if c in taken:
                    d, v, i = taken[c]
                    out[c] = Column(col.kind, d, v, col.vocab, int_flag=i)
                elif in_bounds is None:
                    out[c] = col.take(idx)
                else:
                    out[c] = col.take_or_null(idx, in_bounds)
        return CudaTable(out, int(li.shape[0]))

    # -- union -------------------------------------------------------------

    def union_all(self, other: "CudaTable") -> "CudaTable":
        """Rows of ``self`` then ``other``, column by column through
        ``Column.concat`` (kind promotion included). The reference's padded
        fork (``_union_all_padded``) is left out with the bucket lattice."""
        other = ensure_flat(other)
        if set(self._cols) != set(other._cols):
            raise TpuBackendError("unionAll column mismatch")
        t, o = self._depad(), other._depad()
        return CudaTable(
            {c: col.concat(o._cols[c]) for c, col in t._cols.items()},
            t._nrows + o._nrows,
        )

    # -- row shaping -------------------------------------------------------

    def skip(self, n: int) -> "CudaTable":
        t = self._depad()
        n = min(n, t._nrows)
        return CudaTable(
            {c: col.slice(n, t._nrows) for c, col in t._cols.items()}, t._nrows - n
        )

    def limit(self, n: int) -> "CudaTable":
        t = self._depad()
        n = min(n, t._nrows)
        return CudaTable({c: col.slice(0, n) for c, col in t._cols.items()}, n)

    def with_row_index(self, col: str) -> "CudaTable":
        t = self._depad()
        out = dict(t._cols)
        out[col] = Column(
            I64, torch.arange(t._nrows, dtype=torch.int64, device=_device.get()), None
        )
        return CudaTable(out, t._nrows)

    # -- ordering ----------------------------------------------------------

    def order_by_limit(
        self, items: Sequence[Tuple[str, bool]], k: int
    ) -> Optional["CudaTable"]:
        """The first ``k`` rows under ORDER BY as one top-k over a packed
        int64 rank (``jit_ops.order_topk``). None (the caller sorts and
        limits) unless every key is integral (ints, bools, string codes)
        and the ranges, a null bit per key and the row-index tiebreak fit
        62 bits."""
        t = self._depad()
        if t is not self:
            return t.order_by_limit(items, k)
        n = self._nrows
        if not items or n == 0 or k == 0:
            return None
        cols = [self._cols[c] for c, _ in items]
        if any(c.kind not in INTEGRAL_KINDS for c in cols):
            return None  # a list or element key sorts through order_by
        k = min(k, n)
        datas = tuple(c.data for c in cols)
        valids = tuple(c.valid for c in cols)
        mins, maxs = (to_host(x) for x in J.order_minmax(datas, valids))
        pack = []
        total_bits = 0
        for lo, hi in zip(mins, maxs):
            lo, hi = int(lo), int(hi)
            if lo > hi:  # all-null key: no data bits
                lo, hi = 0, 0
            span = hi - lo
            bits = span.bit_length()
            total_bits += bits + 1  # and a null bit
            pack.append((lo, span, bits))
        total_bits += max(n - 1, 0).bit_length()  # the row-index tiebreak
        if total_bits > 62:
            return None
        ascs = tuple(bool(a) for _, a in items)
        return self._take(J.order_topk(datas, valids, ascs, tuple(pack), k=k))

    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "CudaTable":
        """ORDER BY: one stable lexsort under Cypher orderability
        (``jit_ops.order_permutation``) and one gather. Object-valued keys
        raise ``TpuUnsupportedExpr``; the reference sorts them on its host
        oracle."""
        t = self._depad()
        if t is not self:
            return t.order_by(items)
        objs = [self._cols[c] for c, _ in items if self._cols[c].kind == OBJ]
        if objs:
            raise TpuUnsupportedExpr(f"ORDER BY on object-valued keys: {_obj_item(*objs)}")
        if not items:
            return self
        cols = [self._key_col(c) for c, _ in items]
        idx = J.order_permutation(
            tuple(c.data for c in cols),
            tuple(c.valid for c in cols),
            tuple(c.kind for c in cols),
            tuple(bool(asc) for _, asc in items),
        )
        return self._take(idx)

    # -- distinct / group factorization ------------------------------------

    def _key_col(self, c: str) -> Column:
        """Column ``c`` as a key: itself, or for a list or element column
        the scalar column that orders and equates as it does."""
        return LS.key_column(self._cols[c])

    def _first_occurrence_index(self, on: Sequence[str], extra_keys: Sequence[Any] = ()):
        """Stable lexsort over Cypher-equivalence keys -> (sorted row order,
        first-of-group flags over the sorted order, device group count).
        The first row of each equal-key run is the group's earliest row.
        ``extra_keys`` are higher-priority keys (a group index for DISTINCT
        aggregates). All-integer key sets whose ranges fit 63 bits sort as
        one packed key."""
        cols = [self._key_col(c) for c in on]
        datas = tuple(c.data for c in cols)
        valids = tuple(c.valid for c in cols)
        kinds = tuple(c.kind for c in cols)
        extras = tuple(extra_keys)
        pack = self._equiv_pack(datas, valids, kinds, extras, min_keys=2)
        return J.equivalence_sort(datas, valids, extras, kinds, pack=pack)

    def _equiv_pack(self, datas, valids, kinds, extras, min_keys: int):
        """The int packing of the equivalence keys over these columns, or
        None when a key is not integral, the ranges exceed 63 bits or there
        are fewer than ``min_keys`` keys (one min/max probe, one sync)."""
        # extras are group ids: int64
        if self._nrows == 0 or any(k not in INTEGRAL_KINDS for k in kinds):
            return None
        # one data key per column, a null-class key per mask, the extras:
        # decided before the device probe
        nkeys = len(extras) + sum(1 if v is None else 2 for v in valids)
        if nkeys < min_keys:
            return None
        mins, maxs = (to_host(x) for x in J.equivalence_minmax(datas, valids, extras, kinds))
        bits = [(int(hi) - int(lo)).bit_length() for lo, hi in zip(mins, maxs)]
        if sum(bits) > 63:
            return None
        return tuple((int(lo), b) for lo, b in zip(mins, bits))

    def distinct_count(self, cols: Sequence[str]) -> Optional[int]:
        """Number of distinct rows over ``cols`` without materializing them
        (the count-over-distinct pushdown). All-integer key sets take a
        packed values-only sort; other keys the first-occurrence
        factorization. None for object-valued keys (the caller runs
        ``distinct``). Under a mesh the single sort stays: the table is
        whole on the home device, so the reference's sharded tier would
        only add routing to it (ROADMAP.md §3)."""
        t = self._depad()
        if t is not self:
            return t.distinct_count(cols)
        if not cols or any(self._cols[c].kind == OBJ for c in cols):
            return None
        if self._nrows == 0:
            return 0
        # one scalar sync: an agg-class device sync, so the agg fault site
        fault_point("agg")
        keys = [self._key_col(c) for c in cols]
        datas = tuple(c.data for c in keys)
        valids = tuple(c.valid for c in keys)
        kinds = tuple(c.kind for c in keys)
        pack = self._equiv_pack(datas, valids, kinds, (), min_keys=1)
        if pack is not None:
            cnt = J.distinct_count_packed(datas, valids, (), kinds, pack)
        else:
            _, _, cnt = J.equivalence_sort(datas, valids, (), kinds, pack=None)
        with host_sync("agg"):
            return int(cnt)

    def distinct(self, cols: Optional[Sequence[str]] = None) -> "CudaTable":
        """The first row of each Cypher-equivalence class, in row order.
        Object-valued keys raise ``TpuUnsupportedExpr``; the reference
        deduplicates them on its host oracle."""
        t = self._depad()
        if t is not self:
            return t.distinct(cols)
        on = list(cols) if cols is not None else self.physical_columns
        objs = [self._cols[c] for c in on if self._cols[c].kind == OBJ]
        if objs:
            raise TpuUnsupportedExpr(f"DISTINCT on object-valued keys: {_obj_item(*objs)}")
        if not on:
            return self.limit(1) if self._nrows > 1 else self
        if self._nrows == 0:
            return self
        order, flags, cnt = self._first_occurrence_index(on)
        fault_point("compact")  # the distinct row count read below
        with host_sync("compact"):
            k = int(cnt)
        return self._take(J.first_occurrence_rows(order, flags, k=k))

    # -- grouped aggregation ------------------------------------------------

    _DEVICE_AGGS = frozenset({
        "count", "sum", "avg", "stdev", "stdevp", "min", "max",
        "percentilecont", "percentiledisc", "collect",
    })
    # DISTINCT runs as a device pre-dedup of (group, value) pairs
    _DISTINCT_AGGS = frozenset({"count", "sum", "avg", "min", "max", "collect"})

    def group(self, by, aggregations, header, parameters) -> "CudaTable":
        return self._depad()._group_device(by, aggregations, header, parameters)

    def _group_device(self, by, aggregations, header, parameters) -> "CudaTable":
        """Grouped aggregation on the device: the group ids come from
        ``distinct``'s lexsort factorization (null and NaN classes), renumbered
        in first-occurrence order (``jit_ops.group_index``); each aggregate is
        then a segment reduce over them. An aggregate or grouping key the
        device cannot compute raises ``TpuUnsupportedExpr``: the reference
        answers those on its host oracle."""
        from ...ir import expr as E

        for _, agg in aggregations:
            if not isinstance(agg, E.Agg) or agg.name.lower() not in self._DEVICE_AGGS:
                raise TpuUnsupportedExpr(f"device agg {getattr(agg, 'name', agg)}")
            if agg.distinct and agg.name.lower() not in self._DISTINCT_AGGS:
                raise TpuUnsupportedExpr(f"device agg DISTINCT {agg.name}")
        objs = [self._cols[c] for c in by if self._cols[c].kind == OBJ]
        if objs:
            raise TpuUnsupportedExpr(f"object-valued group keys: {_obj_item(*objs)}")
        n = self._nrows
        if not by and all(agg.name.lower() == "count" and agg.expr is None
                          for _, agg in aggregations):
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
        out_cols: Dict[str, Column] = {}
        if by and n == 0:
            return self._empty_group(by, aggregations, header, parameters)
        if by:
            order, flags, cnt = self._first_occurrence_index(by)
            with host_sync("agg"):
                k = int(cnt)
            seg_j, first_rows = J.group_index(order, flags, k=k)
            for c, key in self.select(by)._take(first_rows)._cols.items():
                out_cols[c] = key
        else:  # global aggregation: one group, even over zero rows
            seg_j, k = None, 1
        ev = CudaEvaluator(self, header, parameters)
        for out_col, agg in aggregations:
            name = agg.name.lower()
            if agg.expr is None:  # count(*): every row counts
                if seg_j is None:
                    counts = torch.tensor([n], dtype=torch.int64, device=dev)
                else:
                    with host_sync("agg_count"):
                        # tpulint: allow[pad-invariant] reason=count(*) per group: one output row per group, k is the answer's group count
                        counts = torch.bincount(seg_j, minlength=k)
                out_cols[out_col] = Column(I64, counts, None)
                continue
            # count reads an element's identity, every other aggregate a value
            col = ev.identity(agg.expr) if name == "count" else ev.eval(agg.expr)
            if col.kind == OBJ:
                raise TpuUnsupportedExpr("object-valued aggregation input")
            if col.kind in NESTED_KINDS:
                if name == "count" and agg.distinct:
                    # the dense rank in Cypher order, keeping its nulls
                    col = LS.key_column(col)
                elif name == "count":  # counts the non-null values
                    mask = col.valid_mask()
                    col = Column(BOOL, mask, mask)
                elif name in ("min", "max") and not agg.distinct:
                    out_cols[out_col] = _extreme_by_rank(name, seg_j, col, k)
                    continue
                elif name != "collect":
                    raise TpuUnsupportedExpr(f"{name} over {col.kind} values")
            seg_a, col_a = seg_j, col
            if agg.distinct or name in ("collect", "percentilecont", "percentiledisc"):
                if seg_a is None:  # these take explicit ids, all in group 0
                    seg_a = torch.zeros(n, dtype=torch.int64, device=dev)
                if agg.distinct:
                    seg_a, col_a = self._dedup_seg_values(seg_a, col)
            if name == "collect":
                fault_point("agg")
                out_cols[out_col] = LS.collect(seg_a, col_a, k)
            elif name in ("percentilecont", "percentiledisc"):
                out_cols[out_col] = _percentile(name, agg, seg_a, col_a, k, parameters)
            else:
                out_cols[out_col] = self._segment_agg(name, seg_a, col_a, k)
        return CudaTable(out_cols, k)

    def _empty_group(self, by, aggregations, header, parameters) -> "CudaTable":
        """Zero rows with grouping keys: no group, so an empty table of the
        key columns and one column per aggregate, of the kind the aggregate
        gives. The reference asks its host oracle here."""
        out_cols = dict(self.select(by)._cols)
        ev = CudaEvaluator(self, header, parameters)
        for out_col, agg in aggregations:
            name = agg.name.lower()
            if name == "collect":
                out_cols[out_col] = LS.list_column(
                    torch.zeros(0, dtype=torch.int64, device=_device.get()), _empty_column(I64)
                )
                continue
            if name == "count" or agg.expr is None:
                kind = I64
            else:
                kind = ev.eval(agg.expr).kind
            if name in ("avg", "stdev", "stdevp", "percentilecont"):
                kind = F64
            out_cols[out_col] = _empty_column(kind)
        return CudaTable(out_cols, 0)

    def _dedup_seg_values(self, seg_j, col: Column):
        """Device dedup of (group, value) pairs for DISTINCT aggregates: the
        first occurrence of each Cypher-equivalence class within each group
        (the group id is the leading key), in row order, so collect DISTINCT
        keeps first-appearance order as the oracle does."""
        tmp = CudaTable({"__v": col}, int(seg_j.shape[0]))
        order, flags, cnt = tmp._first_occurrence_index(["__v"], extra_keys=[seg_j])
        fault_point("agg")  # the distinct pair count read below
        with host_sync("agg"):
            k = int(cnt)
        rows = J.first_occurrence_rows(order, flags, k=k)
        return seg_j[rows], col.take(rows)

    def _segment_agg(self, name: str, seg_j, col: Column, k: int) -> Column:
        """One aggregator over (value column, group index; None: one
        group) through the ``segment_agg`` kernel gate."""
        from .hopper import segment_aggregate

        fault_point("agg")
        kind = col.kind
        if kind == DUR and name in ("sum", "avg", "min", "max"):
            return _duration_agg(name, seg_j, col, k)
        if kind == DUR and name == "count":  # the non-null durations
            mask = col.valid_mask()
            col, kind = Column(BOOL, mask, mask), BOOL
        if name in ("sum", "avg", "stdev", "stdevp") and kind not in (I64, F64):
            raise TpuUnsupportedExpr(f"{name} over {kind}")
        # mesh tier: integer aggregates as per-shard partials combined by
        # sum, min or max, exact over the integers, so bit-identical to the
        # single program (floats keep it; see parallel/agg.py)
        if (
            kind in (I64, BOOL)
            and col.int_flag is None
            and (kind == I64 or name in ("count", "min", "max"))
        ):
            from ...parallel.agg import sharded_segment_agg

            mesh_out = sharded_segment_agg(col.data, col.valid, seg_j, name, kind == BOOL, k)
            if mesh_out is not None:
                out_data, out_valid = mesh_out
                if name == "count":
                    return Column(I64, out_data, None)
                return Column(F64 if name == "avg" else kind, out_data, out_valid, col.vocab)
        out_data, out_valid, out_iflag, iflag_any = segment_aggregate(
            col.data, col.valid, col.int_flag, seg_j, name=name, kind=kind, k=k
        )
        if name == "count":
            return Column(I64, out_data, None)
        if out_iflag is not None:
            with host_sync("agg"):
                any_int = bool(iflag_any)
            if not any_int:
                out_iflag = None  # canonical metadata: no integer rows at all
        out_kind = F64 if name in ("avg", "stdev", "stdevp") else kind
        return Column(out_kind, out_data, out_valid, col.vocab, int_flag=out_iflag)

    # -- UNWIND ------------------------------------------------------------

    def explode(self, expr, col: str, header, parameters) -> "CudaTable":
        """UNWIND: a list column's elements, row by row, as one CSR expand
        materialize on the ``expand_rows`` gate — the list starts are the row
        pointers, the valid rows the frontier, the lengths the degrees;
        each lane gathers the other columns by its row and the element by
        its child position. A null list gives no row; a value that is not a
        list unwinds to itself. The reference decodes the list column on
        the host here."""
        t = self._depad()
        c = CudaEvaluator(t, header, parameters).eval(expr)
        if c.kind == OBJ:
            raise TpuUnsupportedExpr(f"UNWIND of {_obj_item(c)}")
        if c.kind == MIX and any(p.kind == LST for p in c.parts):
            raise TpuUnsupportedExpr("UNWIND of a column of lists mixed with other values")
        if c.kind == LST:
            keep = c.valid_mask() & (c.lengths() > 0)
            with host_sync("explode"):
                # tpulint: allow[pad-invariant] reason=UNWIND emits one row per list element: the answer's rows, compacted exactly
                pos = torch.nonzero(keep).squeeze(1)
            row, child_pos = LS.segment_lanes(c.starts(), pos, c.lengths()[pos], len(c.child))
            rows, value = pos[row], c.child.take(child_pos)
        else:
            keep = c.valid_mask()
            with host_sync("explode"):
                # tpulint: allow[pad-invariant] reason=UNWIND of a scalar column emits its valid rows: the answer's rows, compacted exactly
                rows = torch.nonzero(keep).squeeze(1)
            value = c.take(rows)
        out = t._take(rows)
        out._cols[col] = value
        return out

    def __repr__(self) -> str:
        return f"CudaTable({self._nrows} rows, cols={self.physical_columns})"

    # -- planner capability hooks (fused CSR expand and WCOJ paths) ---------

    @staticmethod
    def plan_expand_fastpath(planner, op, lhs, rhs, classic):
        from .expand_op import plan_expand_fastpath

        return plan_expand_fastpath(planner, op, lhs, rhs, classic)

    @staticmethod
    def plan_expand_into_fastpath(planner, op, in_plan, classic):
        from .expand_op import plan_expand_into_fastpath

        return plan_expand_into_fastpath(planner, op, in_plan, classic)

    @staticmethod
    def plan_optional_expand_fastpath(planner, op, lhs, rhs, classic):
        from .expand_op import plan_optional_expand_fastpath

        return plan_optional_expand_fastpath(planner, op, lhs, rhs, classic)

    @staticmethod
    def plan_multiway_intersect_fastpath(planner, op, in_plan, classic):
        from .wcoj import plan_multiway_intersect_fastpath

        return plan_multiway_intersect_fastpath(planner, op, in_plan, classic)

    @staticmethod
    def plan_var_expand_fastpath(planner, op, lhs, rhs, classic):
        from .expand_op import plan_var_expand_fastpath

        return plan_var_expand_fastpath(planner, op, lhs, rhs, classic)

    @staticmethod
    def plan_filter_fastpath(planner, op, child):
        from .expand_op import plan_filter_fastpath

        return plan_filter_fastpath(planner, op, child)


def _empty_column(kind: str) -> Column:
    dtype = {F64: torch.float64, BOOL: torch.bool, STR: torch.int32,
             DATE: torch.int32}.get(kind, torch.int64)
    shape = (0, 3) if kind == DUR else (0,)
    return Column(kind, torch.zeros(shape, dtype=dtype, device=_device.get()), None,
                  [] if kind == STR else None)


def _duration_agg(name: str, seg_j, col: Column, k: int) -> Column:
    """sum, avg, min or max of a duration column per group
    (``jit_ops.segment_duration_agg``). A group with no duration is null,
    but its sum is the INTEGER 0 in the oracle: where every group is such,
    the result is INTEGER zeros; where only some are, the k sums mix kinds
    and come back as host values (an OBJ column, which later operators
    refuse, ROADMAP.md §3)."""
    out, cnt = J.segment_duration_agg(col.data, col.valid, seg_j, k, name)
    fault_point("agg")  # the empty-group count read below
    empty = torch.sum(cnt == 0)
    with host_sync("agg"):
        nempty = int(empty)
    if nempty == 0:
        return Column(DUR, out, None)
    if name != "sum":
        return Column(DUR, out, cnt > 0)
    if nempty == k:
        return Column(I64, torch.zeros(k, dtype=torch.int64, device=out.device), None)
    sums = Column(DUR, out, cnt > 0).to_values()
    return Column(OBJ, _obj_array([0 if v is None else v for v in sums]), None)


def _percentile(name: str, agg, seg_j, col: Column, k: int, parameters) -> Column:
    """percentileCont/Disc as a segment-sorted gather. A fraction that is
    not a literal or parameter in [0, 1], a non-numeric input and NaN values
    raise ``TpuUnsupportedExpr``; the reference answers those on its host
    oracle."""
    from ...ir import expr as E

    if not agg.extra:
        raise TpuUnsupportedExpr("percentile without fraction")
    pe = agg.extra[0]
    if isinstance(pe, E.Lit):
        p = pe.value
    elif isinstance(pe, E.Param):
        p = (parameters or {}).get(pe.name)
    else:
        raise TpuUnsupportedExpr("non-literal percentile fraction")
    if not isinstance(p, (int, float)) or isinstance(p, bool) or not 0 <= float(p) <= 1:
        # the oracle raises its error on the first group that holds a value
        # (one device read), and answers null where none does
        valid = col.valid_mask()
        anyv = torch.any(valid)
        with host_sync("agg"):
            any_valid = bool(anyv)
        if not any_valid:
            return Column(F64 if name == "percentilecont" else I64,
                          torch.zeros(k, dtype=torch.float64 if name == "percentilecont"
                                      else torch.int64, device=valid.device),
                          torch.zeros(k, dtype=torch.bool, device=valid.device))
        from ..local.eval import aggregate_values

        with host_sync("agg_first"):
            # tpulint: allow[pad-invariant] reason=the first valid value, read once to check the percentile argument on the host: not a lane extent
            first_row = torch.nonzero(valid)[:1].squeeze(1)
        first = col.take(first_row).to_values()
        aggregate_values(name, first, False, [p])
        raise TpuUnsupportedExpr("percentile fraction out of range")
    p = float(p)
    fault_point("agg")
    kind = col.kind
    disc_kinds = (I64, F64, STR) + TEMPORAL_KINDS
    if kind not in disc_kinds or (name == "percentilecont" and kind not in (I64, F64)):
        raise TpuUnsupportedExpr(f"{name} over {kind}")
    if kind == F64:
        nan = J.any_nan_valid(col.data, col.valid)
        with host_sync("agg"):
            any_nan = bool(nan)
        if any_nan:
            raise TpuUnsupportedExpr("percentile over NaN values")
    out, out_valid, order, pos = J.segment_percentile(
        col.data, col.valid, seg_j, p, name=name, k=k
    )
    if name == "percentilecont":
        return Column(F64, out, out_valid)
    iflag = None
    if col.int_flag is not None and len(col):
        iflag = J.take_take(col.int_flag, order, pos)
    return Column(kind, out, out_valid, col.vocab, int_flag=iflag)


def _extreme_by_rank(name: str, seg_j, col: Column, k: int) -> Column:
    """``min``/``max`` of list, map, element or mixed values per group: the
    first row of the least (greatest) rank in Cypher order, as the
    oracle's ``min(vals, key=order_key)``; null for a group of nulls."""
    n = len(col)
    if n == 0:
        return col.null_like(k)
    dev = col.data.device
    rank = LS.key_column(col).data
    valid = col.valid_mask()
    seg = torch.zeros(n, dtype=torch.int64, device=dev) if seg_j is None else seg_j
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    key = (rank if name == "min" else rank.max() - rank) * max(n, 1) + rows
    sentinel = torch.iinfo(torch.int64).max
    key = torch.where(valid, key, sentinel)
    best = torch.full((k,), sentinel, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, key, "amin", include_self=True)
    found = best != sentinel
    pick = torch.where(found, torch.remainder(best, max(n, 1)), 0)
    return col.take_or_null(pick, found)


def _float_as_exact_int(c: Column) -> Column:
    """An F64 key column recast for EXACT equality against int64 keys:
    rows where the float is integral and inside the int64 range become that
    integer; all other rows (fractional, NaN, inf, out of range) become
    invalid and so never match."""
    f = c.data
    integral = (
        (f == torch.floor(f)) & (f >= -(2.0**63)) & (f < 2.0**63) & ~torch.isnan(f)
    )
    data = torch.where(integral, f, torch.zeros_like(f)).to(torch.int64)
    return Column(I64, data, c.valid_mask() & integral)
