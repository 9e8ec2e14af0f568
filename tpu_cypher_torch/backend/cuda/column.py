"""Device columns: typed torch tensors + validity masks.

The port of ``tpu_cypher/backend/tpu/column.py``: every column is a
fixed-width tensor on the backend's device (``device.get()``) plus an
optional bool validity mask (Cypher null != padding). Strings are
dictionary-encoded int32 codes over an ORDER-PRESERVING (sorted)
vocabulary, so comparisons and min/max work on codes without touching host
strings. Ids are int64 with the graph tag in bits 54 and up
(``ir.expr.PrefixId``).

The scalar kinds are I64, F64, BOOL and STR. Two nested kinds keep list,
map and element values on the device too:

* ``LST``: ``data`` is an (n, 2) int64 tensor of (start, length) per row
  over one ``child`` Column of any device kind (a list of lists nests the
  layout: its child is an ``LST``); row i holds
  the child rows ``start:start + length``. Rows may share child ranges,
  so a gather of rows moves two integers a row and never copies elements
  (an UNWIND keeps the list column beside each of its elements); a
  freshly built list is compact (the starts are the lengths' exclusive
  scan). A null list is invalid and empty (a null list is not an empty
  list: the mask tells them apart).
* ``STRUCT``: ordered, named ``fields`` of n rows each, with per-row
  validity, and a ``tag``: ``map`` (decodes to a ``CypherMap``),
  ``props`` (``properties()``: a dict of the non-null fields), ``node``
  or ``relationship`` (the element's id, label or type flags, endpoints
  and properties, the header columns ``relational/materialize.py``
  reads). ``data`` is a zero-width (n, 0) tensor that carries the row
  count and the device. A gather of a STRUCT's rows is deferred: it
  keeps the fields and composes a row index, and a field moves only when
  it is read (``field``, ``fields``), so a list of relationships whose
  lengths alone are read gathers none of them. A path is a ``STRUCT``
  tagged ``path`` of two lists, ``nodes`` and ``relationships``.
* ``MIX``: values of several kinds in one column (a list's elements, a
  ``CASE`` whose branches differ, a ``UNION`` of kinds). ``data`` is an
  (n, 2) int64 tensor of (part, row) per row over ``parts``, one device
  Column per kind: row i is row ``row`` of ``parts[part]``. Like a list's
  child, the parts are shared by gathers.

Six temporal kinds keep dates, times and durations on the device
(``temporal.py`` holds their calendar math):

* ``DATE``: int32 days since 1970-01-01;
* ``LDT`` (localdatetime): int64 microseconds since 1970-01-01T00:00;
* ``ZDT`` (datetime): int64 UTC microseconds, and ``ZT`` (time): int64
  unwrapped UTC-adjusted microseconds of the day; the column's one zone
  offset is its ``vocab`` (``['+02:00']``);
* ``LT`` (localtime): int64 microseconds since midnight;
* ``DUR`` (duration): an (n, 3) int64 tensor of (months, days,
  microseconds), the oracle's ``Duration`` with its seconds and
  microseconds as one count.

Dates mixed with datetimes, zoned values whose offsets differ from row to
row, zones named by region and elements given as Python values stay
host-exact OBJ columns, over which the compiler raises
``TpuUnsupportedExpr`` (``compiler.py``)."""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...api import types as T
from ...api.types import CypherType
from ...api.values import CypherMap, Duration, Node, Path, Relationship
from ...obs.trace import sync as host_sync
from . import device as _device

# column kinds
I64 = "i64"
F64 = "f64"
BOOL = "bool"
STR = "str"  # dictionary-encoded int32 codes
OBJ = "obj"  # host-side Python objects — not device resident
LST = "lst"  # (start, length) per row over one child Column
STRUCT = "struct"  # named child Columns
MIX = "mix"  # (part, row) per row over one part Column per kind
DATE = "date"  # int32 days since 1970-01-01
LDT = "ldt"  # int64 microseconds since 1970-01-01T00:00, no zone
ZDT = "zdt"  # int64 UTC microseconds; vocab = [the column's '+HH:MM']
ZT = "zt"  # int64 unwrapped UTC-adjusted microseconds of the day; vocab as ZDT
LT = "lt"  # int64 microseconds since midnight, no zone
DUR = "dur"  # (n, 3) int64: months, days, microseconds
NESTED_KINDS = (LST, STRUCT, MIX)
TEMPORAL_KINDS = (DATE, LDT, ZDT, ZT, LT)
SCALAR_KINDS = (I64, F64, BOOL, STR) + TEMPORAL_KINDS + (DUR,)
# STRUCT tags; an element's fields are "id", "start", "end", "label:<l>",
# "type:<t>" and "prop:<key>"
MAP, PROPS, NODE, REL, PATH = "map", "props", "node", "relationship", "path"
# kinds whose payload is one integer per row that orders and equates as the
# values do: the zoned kinds key on their UTC lane, which is the oracle's
# datetime and time equality and order
INTEGRAL_KINDS = (I64, BOOL, STR) + TEMPORAL_KINDS

_NULL_CODE = np.int32(-1)


def to_host(arr, site: str = "to_host") -> np.ndarray:
    """Device tensor -> host numpy array (identity for numpy input); the
    copy is timed as ``sync:<site>``."""
    if isinstance(arr, np.ndarray):
        return arr
    with host_sync(site):
        # tpulint: allow[host-sync] reason=the port's device-to-host copy helper: the sync is its purpose, and the session's attempt boundary types a fault it raises
        return arr.detach().cpu().numpy()


def to_device(host_arr) -> torch.Tensor:
    """Host numpy array -> tensor on the backend's device (one copy: from
    pageable host memory it waits for the device's queue, so it is timed
    as ``sync:to_device``)."""
    src = torch.from_numpy(np.ascontiguousarray(host_arr))
    with host_sync("to_device"):
        return src.to(_device.get())


def _obj_array(vals) -> np.ndarray:
    """ALWAYS-1-D object array (np.array() on equal-length list values
    silently builds 2-D, breaking concat and row gathers)."""
    arr = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        arr[i] = v
    return arr


class TpuBackendError(Exception):
    pass


def _decode_host(kind, data, valid, iflag, vocab) -> List[Any]:
    """Per-kind host-array -> Python-value decode (arrays already sliced)."""
    if kind == I64:
        return [
            int(v) if (valid is None or valid[i]) else None
            for i, v in enumerate(data)
        ]
    if kind == F64:
        return [
            (
                (int(v) if (iflag is not None and iflag[i]) else float(v))
                if (valid is None or valid[i])
                else None
            )
            for i, v in enumerate(data)
        ]
    if kind == BOOL:
        return [
            bool(v) if (valid is None or valid[i]) else None
            for i, v in enumerate(data)
        ]
    if kind == STR:
        vb = vocab or []
        return [
            (vb[v] if v >= 0 else None)
            if (valid is None or valid[i])
            else None
            for i, v in enumerate(data)
        ]
    from . import temporal as TP

    if kind in (ZDT, ZT):
        off = TP.column_offset(vocab)
        dec = TP.decode_zdt if kind == ZDT else TP.decode_zt
        return [dec(v, off) if (valid is None or valid[i]) else None
                for i, v in enumerate(data)]
    if kind == DUR:
        return [
            Duration(months=int(r[0]), days=int(r[1]), microseconds=int(r[2]))
            if (valid is None or valid[i]) else None
            for i, r in enumerate(data)
        ]
    dec = {DATE: TP.decode_date, LDT: TP.decode_ldt, LT: TP.decode_lt}[kind]
    return [dec(v) if (valid is None or valid[i]) else None for i, v in enumerate(data)]


@dataclass
class Column:
    kind: str
    data: Any  # torch tensor (device) or np object array for OBJ
    valid: Optional[Any]  # bool tensor or None (= all valid)
    vocab: Optional[List[str]] = None  # sorted, for STR
    _obj_type: Optional[CypherType] = None  # cached OBJ value type
    # F64 only: bool tensor marking rows whose Cypher value is an INTEGER
    # (mixed int/float columns are stored as f64 payloads; decode restores
    # intness). None = no integer rows.
    int_flag: Optional[Any] = None
    # host mirrors of ``data``/``valid`` when the column was BUILT from
    # host data: decoding such a column costs no device round trip
    _np_cache: Optional[np.ndarray] = None
    _np_valid: Optional[np.ndarray] = None
    # lazily-fetched (data, valid, int_flag) host tuple for decode: ONE
    # device-to-host copy per array per column lifetime
    _host_fetch: Optional[tuple] = None
    # bucket padding: the trailing ``pad`` rows are phantom rows of a
    # bucket-padded materialize (``bucketing.round_size``), ALWAYS invalid
    pad: int = 0
    # True when ``valid`` exists ONLY for the padding (the logical column
    # has no nulls) — type metadata stays non-nullable and depad restores
    # ``valid=None``
    pad_synth: bool = False
    # cached ``ints_beyond_f64`` probe (one scalar sync per column)
    _beyond_f64: Optional[bool] = None
    # LST: the element column
    child: Optional["Column"] = None
    # STRUCT: the named field columns, in order, and the tag; with
    # ``_rows`` set, row i is row ``_rows[i]`` of every field
    _fields: Optional[Dict[str, "Column"]] = None
    tag: Optional[str] = None
    _rows: Optional[Any] = None
    # MIX: the part columns, one per kind
    parts: Optional[List["Column"]] = None
    # STRUCT map or props: the fields whose key is absent where their value
    # is null (None: every field of ``props``, none of ``map``)
    sparse: Optional[frozenset] = None

    def __len__(self) -> int:
        return len(self.data) if self.kind == OBJ else int(self.data.shape[0])

    @property
    def flat(self) -> bool:
        """A device column of one tensor per row (a scalar kind): the
        batched gathers take it; OBJ and the nested kinds gather on their
        own (``take``)."""
        return self.kind in SCALAR_KINDS

    @property
    def fields(self) -> Dict[str, "Column"]:
        """STRUCT: every field, gathered by the deferred row index (once)."""
        if self._rows is not None:
            self._fields = {k: f.take(self._rows) for k, f in self._fields.items()}
            self._rows = None
        return self._fields

    def field(self, name: str) -> Optional["Column"]:
        """STRUCT: one field, gathered by the deferred row index; None when
        the struct lacks it."""
        f = self._fields.get(name)
        if f is None or self._rows is None:
            return f
        return f.take(self._rows)

    def starts(self):
        """LST: each row's first child position."""
        return self.data[:, 0]

    def lengths(self):
        """LST: the per-row element counts (0 for a null list)."""
        return self.data[:, 1]

    @property
    def logical_len(self) -> int:
        """Row count excluding pad rows."""
        return len(self) - self.pad

    def depad(self) -> "Column":
        """Slice off the pad rows (and drop a synthesized-only mask)."""
        if self.pad == 0:
            return self
        n = self.logical_len
        valid = None if self.pad_synth else (
            self.valid[:n] if self.valid is not None else None
        )
        return Column(
            self.kind,
            self.data[:n],
            valid,
            self.vocab,
            int_flag=self.int_flag[:n] if self.int_flag is not None else None,
            _np_cache=self._np_cache,
            _np_valid=self._np_valid,
        )

    # -- conversion --------------------------------------------------------

    @staticmethod
    def _build(kind, data_np, valid_np, vocab=None, iflag_np=None) -> "Column":
        iflag = None
        if iflag_np is not None and iflag_np.any():
            iflag = to_device(iflag_np)
        return Column(
            kind,
            to_device(data_np),
            to_device(valid_np) if valid_np is not None else None,
            vocab,
            int_flag=iflag,
            _np_cache=data_np,
            _np_valid=valid_np,
        )

    @staticmethod
    def from_values(values: Sequence[Any]) -> "Column":
        """Infer kind from Python values (None = null)."""
        non_null = [v for v in values if v is not None]
        n = len(values)
        valid_np = np.array([v is not None for v in values], dtype=bool)
        hv = valid_np if not valid_np.all() else None
        if not non_null:
            return Column._build(I64, np.zeros(n, np.int64), valid_np)
        _BOOLK = (bool, np.bool_)
        _INTK = (int, np.integer)
        _NUMK = (int, float, np.integer, np.floating)
        if all(isinstance(v, _BOOLK) for v in non_null):
            data = np.array(
                [bool(v) if v is not None else False for v in values], dtype=bool
            )
            return Column._build(BOOL, data, hv)
        if all(isinstance(v, _INTK) and not isinstance(v, _BOOLK) for v in non_null):
            data = np.array(
                [int(v) if v is not None else 0 for v in values], dtype=np.int64
            )
            return Column._build(I64, data, hv)
        if all(isinstance(v, _NUMK) and not isinstance(v, _BOOLK) for v in non_null):
            ints = [
                v
                for v in non_null
                if isinstance(v, _INTK) and not isinstance(v, _BOOLK)
            ]
            if any(abs(int(v)) > 2**53 for v in ints):
                # mixed int/float with ints beyond f64 exactness: keep the
                # column host-exact instead of silently rounding
                return Column(OBJ, _obj_array(values), None)
            data = np.array(
                [float(v) if v is not None else 0.0 for v in values],
                dtype=np.float64,
            )
            iflag = np.array(
                [isinstance(v, _INTK) and not isinstance(v, _BOOLK) for v in values],
                dtype=bool,
            )
            return Column._build(F64, data, hv, iflag_np=iflag)
        if all(isinstance(v, str) for v in non_null):
            vocab = sorted(set(non_null))
            index = {s: i for i, s in enumerate(vocab)}
            codes = np.array(
                [index[v] if v is not None else _NULL_CODE for v in values],
                dtype=np.int32,
            )
            return Column._build(STR, codes, hv, vocab=vocab)
        got = _temporal_from_values(values, non_null, hv)
        if got is not None:
            return got
        if all(isinstance(v, (list, tuple)) for v in non_null):
            child = Column.from_values([x for v in non_null for x in v])
            if child.kind != OBJ:
                lens = np.array([len(v) if v is not None else 0 for v in values], np.int64)
                starts = np.cumsum(lens) - lens
                return Column(LST, to_device(np.stack([starts, lens], 1).reshape(n, 2)),
                              to_device(hv) if hv is not None else None, child=child)
        elif all(type(v) in (dict, CypherMap) for v in non_null):
            kinds = {type(v) for v in non_null}
            keys = {tuple(v.keys()) for v in non_null}
            # a plain dict decodes without its null values (``properties``)
            sparse_ok = CypherMap in kinds or all(
                x is not None for v in non_null for x in v.values())
            if len(kinds) == 1 and len(keys) == 1 and sparse_ok:
                fields = {
                    k: Column.from_values([v[k] if v is not None else None for v in values])
                    for k in next(iter(keys))
                }
                if all(f.kind != OBJ for f in fields.values()):
                    return struct_column(
                        fields, n, to_device(hv) if hv is not None else None,
                        MAP if CypherMap in kinds else PROPS, device=_device.get(),
                    )
        got = _mixed_from_values(values, valid_np)
        if got is not None:
            return got
        # everything else stays host-exact: elements given as Python
        # values, mixed temporal kinds or offsets
        return Column(OBJ, _obj_array(values), None)

    @staticmethod
    def from_numpy(arr: np.ndarray, valid: Optional[np.ndarray] = None) -> "Column":
        """Bulk construction from a numpy array: one host-to-device copy."""
        arr = np.asarray(arr)
        hv = np.asarray(valid, dtype=bool).copy() if valid is not None else None
        if arr.dtype == np.bool_:
            return Column._build(BOOL, arr.copy(), hv)
        if np.issubdtype(arr.dtype, np.integer):
            return Column._build(I64, arr.astype(np.int64, copy=True), hv)
        if np.issubdtype(arr.dtype, np.floating):
            return Column._build(F64, arr.astype(np.float64, copy=True), hv)
        if np.issubdtype(arr.dtype, np.datetime64):
            # datetime64[D] is a date; any finer unit a localdatetime in
            # microseconds; NaT is null
            unit = np.datetime_data(arr.dtype)[0]
            nat = np.isnat(arr)
            if unit in ("Y", "M", "W", "D"):
                kind, host = DATE, arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
            else:
                kind, host = LDT, arr.astype("datetime64[us]").astype(np.int64)
            if nat.any():
                host = np.where(nat, 0, host).astype(host.dtype)
                hv = ~nat if hv is None else hv & ~nat
            return Column._build(kind, host, hv)
        raise TpuBackendError(f"from_numpy: unsupported dtype {arr.dtype}")

    def _host_arrays(self):
        """Host mirrors of (data, valid, int_flag), fetched at most once."""
        if self._host_fetch is None:
            data = (
                self._np_cache if self._np_cache is not None
                else to_host(self.data, "decode")
            )
            if self.valid is None:
                valid = None
            elif self._np_valid is not None:
                valid = self._np_valid
            else:
                valid = to_host(self.valid, "decode")
            iflag = (
                to_host(self.int_flag, "decode") if self.int_flag is not None else None
            )
            self._host_fetch = (data, valid, iflag)
        return self._host_fetch

    def to_values(self, row_mask: Optional[np.ndarray] = None) -> List[Any]:
        """Decode to Python values (respecting validity)."""
        if self.kind == OBJ:
            vals = list(self.data)
        elif self.kind in NESTED_KINDS:
            vals = self._decode_nested()
        else:
            data, valid, iflag = self._host_arrays()
            vals = _decode_host(self.kind, data, valid, iflag, self.vocab)
        if row_mask is not None:
            vals = [v for v, keep in zip(vals, row_mask) if keep]
        return vals

    def frame_values(self, n: int) -> Any:
        """The first ``n`` rows as a DataFrame column source (the filesystem
        and Neo4j exports, ``CudaTable.frame_columns``): one host numpy
        array for a non-empty, null-free I64, BOOL or F64 column without
        integer rows, whose dtype (int64, bool, float64) is the one pandas
        infers from the decoded values; the decoded values otherwise."""
        if n and self.kind in (I64, F64, BOOL) and self.int_flag is None:
            data, valid, _ = self._host_arrays()
            if valid is None or bool(valid[:n].all()):
                dtype = {I64: np.int64, F64: np.float64, BOOL: np.bool_}[self.kind]
                return np.asarray(data[:n], dtype=dtype)
        return self.to_values()[:n]

    def to_values_range(self, lo: int, hi: int) -> List[Any]:
        """Decode rows ``[lo, hi)`` only: the chunked decode step of cursor
        streaming (``CudaTable.rows_chunked``). A scalar column decodes its
        slice of the host arrays ``_host_arrays`` fetched once for the
        column's lifetime; a list or struct column decodes a device slice
        of itself, so a chunk copies only the elements its rows hold."""
        hi = min(hi, len(self))
        if self.kind == OBJ:
            return list(self.data[lo:hi])
        if self.kind in NESTED_KINDS:
            return self.slice(lo, hi).to_values()
        data, valid, iflag = self._host_arrays()
        return _decode_host(
            self.kind,
            data[lo:hi],
            valid[lo:hi] if valid is not None else None,
            iflag[lo:hi] if iflag is not None else None,
            self.vocab,
        )

    def _decode_nested(self) -> List[Any]:
        n = len(self)
        valid = to_host(self.valid) if self.valid is not None else None
        if self.kind == LST:
            from .lists import compact

            c = compact(self)  # only the elements the rows hold decode
            lens = to_host(c.lengths())
            vals = c.child.to_values()
            off = np.cumsum(lens) - lens
            return [
                vals[off[i]:off[i] + lens[i]] if valid is None or valid[i] else None
                for i in range(n)
            ]
        if self.kind == MIX:
            return _decode_mix(self, valid)
        cols = {k: f.to_values() for k, f in self.fields.items()}
        if self.tag == PATH:
            return [None if valid is not None and not valid[i] else Path(
                _interleave(cols["nodes"][i], cols["relationships"][i])) for i in range(n)]
        out: List[Any] = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append(None)
                continue
            row = {k: v[i] for k, v in cols.items()}
            if self.tag in (MAP, PROPS):
                sparse = sparse_names(self)
                row = {k: v for k, v in row.items() if v is not None or k not in sparse}
                out.append(CypherMap(row) if self.tag == MAP else row)
            else:
                props = {k[5:]: v for k, v in row.items()
                         if k.startswith("prop:") and v is not None}
                if self.tag == NODE:
                    out.append(Node(row["id"], [k[6:] for k, v in row.items()
                                                if k.startswith("label:") and v], props))
                else:
                    rtype = next((k[5:] for k, v in row.items()
                                  if k.startswith("type:") and v), "")
                    out.append(Relationship(row["id"], row["start"], row["end"], rtype, props))
        return out

    # -- ops ---------------------------------------------------------------

    def take(self, idx) -> "Column":
        """Gather rows by index (device tensor, or host array for OBJ)."""
        if self.kind == OBJ:
            return Column(OBJ, self.data[to_host(idx)], None)
        valid = None if self.valid is None else self.valid[idx]
        if self.kind == LST:  # two integers a row: the child is shared
            return Column(LST, self.data[idx], valid, child=self.child)
        if self.kind == MIX:  # two integers a row: the parts are shared
            return Column(MIX, self.data[idx], valid, parts=self.parts)
        if self.kind == STRUCT:  # deferred: the fields move when read
            rows = idx if self._rows is None else self._rows[idx]
            return self._struct_with(self._fields, self.data[idx], valid, rows)
        from .jit_ops import cols_take

        d, v, i = cols_take({"c": (self.data, self.valid, self.int_flag)}, idx)["c"]
        return Column(self.kind, d, v, self.vocab, int_flag=i)

    def take_or_null(self, idx, in_bounds) -> "Column":
        """Gather; rows where ``in_bounds`` is False become null (outer joins)."""
        n = int(idx.shape[0])
        if len(self) == 0:
            # empty build side: every row is an outer-join null
            if self.kind == OBJ:
                return Column(OBJ, np.empty(n, dtype=object), None)
            if self.kind in NESTED_KINDS:
                return self.null_like(n)
            dev = self.data.device
            return Column(
                self.kind,
                torch.zeros((n,) + tuple(self.data.shape[1:]), dtype=self.data.dtype, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
                self.vocab,
            )
        if self.kind == OBJ:
            out = np.empty(n, dtype=object)
            idx_np = to_host(idx)
            ib = to_host(in_bounds)
            for i in range(n):
                out[i] = self.data[idx_np[i]] if ib[i] else None
            return Column(OBJ, out, None)
        if self.kind in NESTED_KINDS:
            safe = torch.where(in_bounds, idx, torch.zeros_like(idx))
            taken = self.take(safe)
            valid = in_bounds & taken.valid_mask()
            if self.kind == STRUCT:
                return taken._struct_with(taken._fields, taken.data, valid, taken._rows)
            data = torch.where(valid[:, None], taken.data, torch.zeros_like(taken.data))
            return Column(self.kind, data, valid, child=self.child, parts=self.parts)
        from .jit_ops import cols_take_or_null

        d, v, i = cols_take_or_null(
            {"c": (self.data, self.valid, self.int_flag)}, idx, in_bounds
        )["c"]
        return Column(self.kind, d, v, self.vocab, int_flag=i)

    def concat(self, other: "Column") -> "Column":
        """Rows of ``self`` then ``other``. An all-null side adopts the
        other side's kind; I64 and F64 promote to F64 keeping Cypher
        intness, unless an int lies beyond 2**53; any other pair of kinds
        becomes a MIX column, but two temporal kinds become OBJ. STR sides
        are re-coded onto one vocab. Zoned sides whose offsets differ
        become OBJ: the column holds one offset, and a blind concat would
        re-zone one side's rows."""
        a, b = self, other
        if a.kind in NESTED_KINDS or b.kind in NESTED_KINDS:
            return _concat_nested(a, b)
        if a.kind != b.kind:
            # scan alignment fills absent properties with I64 null
            # constants: without this a STR/BOOL union would become OBJ
            if a.kind != OBJ and b.is_all_null():
                b = a.null_like(len(b))
            elif b.kind != OBJ and a.is_all_null():
                a = b.null_like(len(a))
        if a.kind != b.kind:
            if {a.kind, b.kind} == {I64, F64}:
                iside = a if a.kind == I64 else b
                if iside.ints_beyond_f64():
                    a, b = a.to_obj(), b.to_obj()
                else:
                    a, b = a.as_f64_keeping_intness(), b.as_f64_keeping_intness()
            else:
                got = None if OBJ in (a.kind, b.kind) else _mix_concat(a, b)
                if got is not None:
                    return got
                a, b = a.to_obj(), b.to_obj()
        if a.kind == OBJ:
            return Column(OBJ, np.concatenate([a.data, b.data]), None)
        if a.kind == STR:
            a, b = _unify_vocab(a, b)
        if a.kind in (ZDT, ZT) and a.vocab != b.vocab:
            return Column(OBJ, np.concatenate([a.to_obj().data, b.to_obj().data]), None)

        def cat(x, y, fill: bool):
            if x is None and y is None:
                return None
            dev = a.data.device
            if x is None:
                x = torch.full((len(a),), fill, dtype=torch.bool, device=dev)
            if y is None:
                y = torch.full((len(b),), fill, dtype=torch.bool, device=dev)
            return torch.cat([x, y])

        return Column(
            a.kind,
            torch.cat([a.data, b.data]),
            cat(a.valid, b.valid, True),
            a.vocab,
            int_flag=cat(a.int_flag, b.int_flag, False),
        )

    def ints_beyond_f64(self) -> bool:
        """True when a VALID int64 payload exceeds f64 exactness (2**53)."""
        if self.kind != I64:
            return False
        if self._beyond_f64 is None:
            big = torch.any(self.valid_mask() & (torch.abs(self.data) > 2**53))
            with host_sync("probe"):
                # tpulint: allow[host-sync] reason=one cached scalar probe per column at compare time; runs inside the session's per-attempt fault boundary
                self._beyond_f64 = bool(big)
        return self._beyond_f64

    def is_all_null(self) -> bool:
        if self.kind == OBJ:
            return all(v is None for v in self.data)
        if self.valid is None:
            return False
        anyv = torch.any(self.valid)
        with host_sync("probe"):
            # tpulint: allow[host-sync] reason=one scalar nullness probe at decode/compare time; runs inside the session's per-attempt fault boundary
            return not bool(anyv)

    def null_like(self, n: int) -> "Column":
        """n all-null rows with this column's kind and vocab."""
        if self.kind == OBJ:
            return Column(OBJ, np.array([None] * n, dtype=object), None)
        dev = self.data.device
        nulls = torch.zeros(n, dtype=torch.bool, device=dev)
        if self.kind == LST:
            return Column(LST, torch.zeros((n, 2), dtype=torch.int64, device=dev), nulls,
                          child=self.child.null_like(0))
        if self.kind == MIX:
            return Column(MIX, torch.zeros((n, 2), dtype=torch.int64, device=dev), nulls,
                          parts=self.parts)
        if self.kind == STRUCT:
            return self._struct_with(
                {k: f.null_like(n) for k, f in self._fields.items()},
                torch.empty((n, 0), dtype=torch.bool, device=dev), nulls,
            )
        if self.kind == STR:
            data = torch.full((n,), int(_NULL_CODE), dtype=torch.int32, device=dev)
        else:
            data = torch.zeros((n,) + tuple(self.data.shape[1:]), dtype=self.data.dtype,
                               device=dev)
        return Column(self.kind, data, torch.zeros(n, dtype=torch.bool, device=dev), self.vocab)

    def as_f64_keeping_intness(self) -> "Column":
        """Value-union contexts (UNION ALL): an I64 column becomes f64
        payloads with every valid row flagged a Cypher INTEGER, so decode
        restores 1 (not 1.0). Exact only below 2**53, which the caller
        checks (``ints_beyond_f64``)."""
        if self.kind == F64:
            return self
        return Column(
            F64, self.data.to(torch.float64), self.valid, int_flag=self.valid_mask()
        )

    def to_obj(self) -> "Column":
        return Column(OBJ, _obj_array(self.to_values()), None)

    def cast_f64(self) -> "Column":
        """Pure float cast (comparison contexts: intness deliberately
        dropped)."""
        if self.kind == F64:
            if self.int_flag is not None:
                return Column(F64, self.data, self.valid)
            return self
        if self.kind == I64:
            return Column(F64, self.data.to(torch.float64), self.valid)
        raise TpuBackendError(f"Cannot cast {self.kind} to f64")

    def valid_mask(self) -> Any:
        if self.kind == OBJ:
            return to_device(np.array([v is not None for v in self.data], bool))
        if self.valid is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.data.device)
        return self.valid

    def _struct_with(self, fields, data, valid, rows=None) -> "Column":
        return Column(STRUCT, data, valid, _fields=fields, tag=self.tag, _rows=rows,
                      sparse=self.sparse)

    def slice(self, lo: int, hi: int) -> "Column":
        """Contiguous row slice (a view — no gather; a list keeps sharing
        its child)."""
        if self.kind == OBJ:
            return Column(OBJ, self.data[lo:hi], None)
        valid = self.valid[lo:hi] if self.valid is not None else None
        if self.kind in (LST, MIX):
            return Column(self.kind, self.data[lo:hi], valid, child=self.child, parts=self.parts)
        if self.kind == STRUCT:
            if self._rows is not None:
                return self._struct_with(self._fields, self.data[lo:hi], valid,
                                         self._rows[lo:hi])
            return self._struct_with(
                {k: f.slice(lo, hi) for k, f in self._fields.items()},
                self.data[lo:hi], valid,
            )
        data = self.data[lo:hi]
        iflag = self.int_flag[lo:hi] if self.int_flag is not None else None
        return Column(self.kind, data, valid, self.vocab, int_flag=iflag)

    def cypher_type(self) -> CypherType:
        if self.kind == LST:
            base = T.CTList(self.child.cypher_type())
        elif self.kind == MIX:
            base = T.join_types(p.cypher_type().material for p in self.parts)
        elif self.kind == STRUCT:
            base = {NODE: T.CTNode(), REL: T.CTRelationship(),
                    PATH: T.CTPath}.get(self.tag, T.CTMap())
        if self.kind in NESTED_KINDS:
            return base.nullable if self.valid is not None else base
        base = {
            I64: T.CTInteger,
            F64: T.CTFloat,
            BOOL: T.CTBoolean,
            STR: T.CTString,
            DATE: T.CTDate,
            LDT: T.CTLocalDateTime,
            ZDT: T.CTDateTime,
            ZT: T.CTTime,
            LT: T.CTLocalTime,
            DUR: T.CTDuration,
            OBJ: T.CTAny,
        }[self.kind]
        if self.kind == F64 and self.int_flag is not None:
            base = T.join_types([T.CTInteger, T.CTFloat])
        has_null = (
            self.valid is not None and not self.pad_synth
        ) or self.kind == OBJ
        return base.nullable if has_null else base


def sparse_names(s: Column) -> frozenset:
    """The fields of a map or props STRUCT whose key is absent where the
    value is null."""
    if s.sparse is not None:
        return s.sparse
    return frozenset(s._fields) if s.tag == PROPS else frozenset()


def struct_column(fields: Dict[str, Column], n: int, valid=None, tag: str = MAP,
                  device=None, rows=None, sparse=None) -> Column:
    """A STRUCT column of ``n`` rows over ``fields``; with ``rows``, row i
    is row ``rows[i]`` of every field (``n`` is then ``len(rows)``)."""
    dev = device if device is not None else (
        next(iter(fields.values())).data.device if fields else _device.get()
    )
    return Column(STRUCT, torch.empty((n, 0), dtype=torch.bool, device=dev), valid,
                  _fields=dict(fields), tag=tag, _rows=rows, sparse=sparse)


def _cat_mask(a: Column, b: Column):
    if a.valid is None and b.valid is None:
        return None
    return torch.cat([a.valid_mask(), b.valid_mask()])


def _concat_nested(a: Column, b: Column) -> Column:
    """``concat`` where a side is LST, STRUCT or MIX: an all-null side
    adopts the other's kind; two lists concatenate their children and
    shift the second side's starts; two structs of one tag (maps of one
    key set) take the union of their fields, a field one side lacks null
    there. Any other pair becomes a MIX column, or OBJ where a side is."""
    if a.kind != b.kind:
        if a.kind in NESTED_KINDS and b.kind != MIX and b.is_all_null():
            b = a.null_like(len(b))
        elif b.kind in NESTED_KINDS and a.kind != MIX and a.is_all_null():
            a = b.null_like(len(a))
    if a.kind == b.kind == LST:
        child = concat_children(a.child, b.child)
        if child.kind != OBJ:
            shift = torch.tensor([len(a.child), 0], dtype=torch.int64, device=b.data.device)
            data = torch.cat([a.data, b.data + shift])
            return Column(LST, data, _cat_mask(a, b), child=child)
    if a.kind == b.kind == STRUCT and _part_sig(a) == _part_sig(b):
        names = list(a.fields) + [k for k in b.fields if k not in a.fields]
        fields = {}
        for k in names:
            fa, fb = a.fields.get(k), b.fields.get(k)
            fa = fa if fa is not None else fb.null_like(len(a))
            fb = fb if fb is not None else fa.null_like(len(b))
            fields[k] = fa.concat(fb)
        return struct_column(fields, len(a) + len(b), _cat_mask(a, b), a.tag,
                             device=a.data.device, sparse=a.sparse)
    got = None if OBJ in (a.kind, b.kind) else _mix_concat(a, b)
    if got is not None:
        return got
    return Column(OBJ, np.concatenate([a.to_obj().data, b.to_obj().data]), None)


# -- MIX columns ---------------------------------------------------------------


def _part_sig(c: Column):
    """What a MIX part holds one of: its kind; a struct's tag too, and a
    map's key set (a map decodes with every key it has, null or not); a
    zoned kind's offset."""
    if c.kind == STRUCT:
        return (STRUCT, c.tag) + ((tuple(c._fields), c.sparse) if c.tag == MAP else ())
    if c.kind in (ZDT, ZT):
        return (c.kind, tuple(c.vocab or ()))
    return (c.kind,)


def as_mix(c: Column) -> Column:
    """``c`` as a MIX column (itself when it is one): one part."""
    if c.kind == MIX:
        return c
    n = len(c)
    dev = c.data.device
    data = torch.stack([torch.zeros(n, dtype=torch.int64, device=dev),
                        torch.arange(n, dtype=torch.int64, device=dev)], 1)
    return Column(MIX, data, c.valid, parts=[c])


def mix_parts(c: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIX: (part, row) per row."""
    return c.data[:, 0], c.data[:, 1]


def _mix_concat(a: Column, b: Column) -> Optional[Column]:
    """Rows of ``a`` then ``b`` as one MIX column: ``b``'s parts join
    ``a``'s part of the same kind (concatenated, its rows shifted), or
    come after them. None where two parts of one kind would not stay one
    device column (temporal kinds that differ: the caller keeps OBJ)."""
    kinds = {k for c in (a, b) for k in ((p.kind for p in c.parts) if c.kind == MIX
                                          else (c.kind,))}
    if len(kinds & set(TEMPORAL_KINDS)) > 1:
        return None
    A, B = as_mix(a), as_mix(b)
    parts = list(A.parts)
    tag_lut, shift_lut = [], []
    for p in B.parts:
        same = next((i for i, q in enumerate(parts) if q is p), None)
        if same is not None:  # a shared part (a gather of one column)
            tag_lut.append(same)
            shift_lut.append(0)
            continue
        j = next((i for i, q in enumerate(parts) if _part_sig(q) == _part_sig(p)), None)
        if j is None:
            parts.append(p)
            tag_lut.append(len(parts) - 1)
            shift_lut.append(0)
            continue
        merged = parts[j].concat(p)
        if merged.kind in (OBJ, MIX):
            return None
        tag_lut.append(j)
        shift_lut.append(len(parts[j]))
        parts[j] = merged
    dev = B.data.device
    btag, brow = mix_parts(B)
    if tag_lut:
        t = torch.clamp(btag, 0, len(tag_lut) - 1)
        btag = torch.tensor(tag_lut, dtype=torch.int64, device=dev)[t]
        brow = brow + torch.tensor(shift_lut, dtype=torch.int64, device=dev)[t]
    data = torch.cat([A.data, torch.stack([btag, brow], 1)])
    return Column(MIX, data, _cat_mask(A, B), parts=parts)


def _value_class(v):
    """The MIX part a Python value goes to (numbers share one)."""
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, float, np.integer, np.floating)):
        return "num"
    if isinstance(v, (list, tuple)):
        return "list"
    if isinstance(v, CypherMap):
        return ("map", tuple(v.keys()))
    if isinstance(v, dict):
        return "props"
    return type(v).__name__


_TEMPORAL_CLASSES = frozenset({"date", "datetime", "time"})


def _mixed_from_values(values, valid_np) -> Optional[Column]:
    """Values of several kinds as a MIX column: one part per class of
    value, each built by ``from_values``; None where a part has no device
    column kind."""
    classes: Dict[Any, List[int]] = {}
    for i, v in enumerate(values):
        if v is not None:
            classes.setdefault(_value_class(v), []).append(i)
    if len(classes) < 2 or sum(c in _TEMPORAL_CLASSES for c in classes) > 1:
        return None  # dates mixed with datetimes stay host values
    n = len(values)
    tags = np.zeros(n, np.int64)
    rows = np.zeros(n, np.int64)
    parts = []
    for j, idx in enumerate(classes.values()):
        part = Column.from_values([values[i] for i in idx])
        if part.kind in (OBJ, MIX):
            return None
        parts.append(part)
        tags[idx] = j
        rows[idx] = np.arange(len(idx))
    hv = None if valid_np.all() else to_device(valid_np)
    return Column(MIX, to_device(np.stack([tags, rows], 1).reshape(n, 2)), hv, parts=parts)


def _decode_mix(c: Column, valid) -> List[Any]:
    """MIX -> Python values: each part decodes the rows it holds."""
    tags, rows = (to_host(x) for x in mix_parts(c))
    out: List[Any] = [None] * len(c)
    for j, part in enumerate(c.parts):
        sel = tags == j
        if valid is not None:
            sel &= valid
        idx = np.nonzero(sel)[0]
        if len(idx):
            vals = part.take(to_device(rows[idx])).to_values()
            for i, v in zip(idx.tolist(), vals):
                out[i] = v
    return out


def _interleave(nodes, rels) -> List[Any]:
    """A path's elements: its nodes with its relationships between them."""
    out = [nodes[0]]
    for r, nd in zip(rels, nodes[1:]):
        out += [r, nd]
    return out


def concat_children(a: Column, b: Column) -> Column:
    """Two list children end to end; an empty side adopts the other's
    kind."""
    if a.kind != b.kind:
        if len(a) == 0:
            a = b.null_like(0)
        elif len(b) == 0:
            b = a.null_like(0)
    return a.concat(b)


def _unify_vocab(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two STR columns re-coded onto one sorted vocab (their union), so
    codes compare and join as the strings do."""
    if a.vocab == b.vocab:
        return a, b
    merged = sorted(set(a.vocab or []) | set(b.vocab or []))
    return _remap(a, merged), _remap(b, merged)


def _remap(c: Column, merged: List[str]) -> Column:
    """Re-code ``c`` onto ``merged`` (a sorted superset of its vocab) by one
    device gather through a code lookup table; null codes stay -1."""
    old = c.vocab or []
    index = {s: i for i, s in enumerate(merged)}
    lut = torch.tensor(
        [index[s] for s in old] + [0], dtype=torch.int32, device=c.data.device
    )  # extra slot so an empty vocab still has a row to index
    codes = c.data.to(torch.int64)
    mapped = lut[torch.clamp(codes, 0, max(len(old) - 1, 0))]
    new_codes = torch.where(codes >= 0, mapped, torch.full_like(mapped, int(_NULL_CODE)))
    return Column(STR, new_codes, c.valid, merged)


def mask_to_idx_bucketed(mask) -> Tuple[Any, int]:
    """``mask_to_idx`` with the index tensor padded to the shape bucket:
    (index tensor of ``round_size(count)`` lanes, true count). Pad lanes
    hold index 0; consumers mark lanes at or past ``count`` invalid."""
    from ...runtime.faults import fault_point
    from .bucketing import round_size
    from .jit_ops import mask_nonzero, mask_sum

    fault_point("compact")
    total = mask_sum(mask)
    with host_sync("compact"):
        count = int(total)
    return mask_nonzero(mask, size=round_size(count)), count


def constant_column(value: Any, n: int) -> Column:
    dev = _device.get()
    if value is None:
        return Column(
            I64,
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
        )
    if isinstance(value, bool):
        return Column(BOOL, torch.full((n,), value, dtype=torch.bool, device=dev), None)
    if isinstance(value, int) and abs(value) < 2**63:
        return Column(I64, torch.full((n,), value, dtype=torch.int64, device=dev), None)
    if isinstance(value, float):
        return Column(F64, torch.full((n,), value, dtype=torch.float64, device=dev), None)
    if isinstance(value, str):
        return Column(STR, torch.zeros(n, dtype=torch.int32, device=dev), None, [value])
    if isinstance(value, (_dt.date, _dt.time, Duration)):
        one = Column.from_values([value])
        if one.kind != OBJ:
            return one.take(torch.zeros(n, dtype=torch.int64, device=dev))
    if isinstance(value, (list, tuple, dict)):
        one = Column.from_values([value])
        if one.kind in NESTED_KINDS:
            return one.take(torch.zeros(n, dtype=torch.int64, device=dev))
    return Column(OBJ, _obj_array([value] * n), None)


def _temporal_from_values(values, non_null, hv) -> Optional[Column]:
    """A temporal column from Python values, or None when they are not all
    of one temporal kind. Zoned values need one fixed offset over the
    column; a zone named by region, offsets that differ from row to row,
    and dates mixed with datetimes stay OBJ (None here, and the caller's
    last resort)."""
    from . import temporal as TP

    def build(kind, enc, dtype, vocab=None):
        data = np.array([enc(v) if v is not None else 0 for v in values], dtype=dtype)
        return Column._build(kind, data, hv, vocab=vocab)

    def one_offset():
        if not all(isinstance(v.tzinfo, _dt.timezone) for v in non_null):
            return None
        offs = {TP.offset_seconds_of(v) for v in non_null}
        return [TP.offset_str(offs.pop())] if len(offs) == 1 else None

    # a datetime is a date: test it first
    if all(isinstance(v, _dt.datetime) for v in non_null):
        if all(v.tzinfo is None for v in non_null):
            return build(LDT, TP.encode_ldt, np.int64)
        vocab = one_offset()
        return build(ZDT, TP.encode_zdt, np.int64, vocab) if vocab else None
    if all(isinstance(v, _dt.date) and not isinstance(v, _dt.datetime) for v in non_null):
        return build(DATE, TP.encode_date, np.int32)
    if all(isinstance(v, _dt.time) for v in non_null):
        if all(v.tzinfo is None for v in non_null):
            return build(LT, TP.encode_time_of_day, np.int64)
        vocab = one_offset()
        return build(ZT, TP.encode_zt, np.int64, vocab) if vocab else None
    if all(isinstance(v, Duration) for v in non_null):
        data = np.zeros((len(values), 3), dtype=np.int64)
        for i, v in enumerate(values):
            if v is not None:
                data[i] = (v.months, v.days, v.seconds * 1_000_000 + v.microseconds)
        return Column._build(DUR, data, hv)
    return None
