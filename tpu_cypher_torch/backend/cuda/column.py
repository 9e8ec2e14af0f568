"""Device columns: typed torch tensors + validity masks.

The port of ``tpu_cypher/backend/tpu/column.py``: every column is a
fixed-width tensor on the backend's device (``device.get()``) plus an
optional bool validity mask (Cypher null != padding). Strings are
dictionary-encoded int32 codes over an ORDER-PRESERVING (sorted)
vocabulary, so comparisons and min/max work on codes without touching host
strings. Ids are int64 with the graph tag in bits 54 and up
(``ir.expr.PrefixId``).

This slice carries the kinds the CSR expand path needs on device — I64,
F64, BOOL, STR — and keeps every other value (temporal values, durations,
lists, elements) as a host-exact OBJ column, whose expressions evaluate as
host islands (``compiler.py``). Device temporal kinds come with a later
slice (ROADMAP.md queue 1)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...api import types as T
from ...api.types import CypherType
from . import device as _device

# column kinds
I64 = "i64"
F64 = "f64"
BOOL = "bool"
STR = "str"  # dictionary-encoded int32 codes
OBJ = "obj"  # host-side Python objects — not device resident

_NULL_CODE = np.int32(-1)


def to_host(arr) -> np.ndarray:
    """Device tensor -> host numpy array (identity for numpy input)."""
    if isinstance(arr, np.ndarray):
        return arr
    return arr.detach().cpu().numpy()


def to_device(host_arr) -> torch.Tensor:
    """Host numpy array -> tensor on the backend's device (one copy)."""
    return torch.from_numpy(np.ascontiguousarray(host_arr)).to(_device.get())


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
    raise TpuBackendError(kind)  # pragma: no cover


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

    def __len__(self) -> int:
        return int(self.data.shape[0]) if self.kind != OBJ else len(self.data)

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
        # everything else stays host-exact (device temporal kinds are a
        # later slice)
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
        raise TpuBackendError(f"from_numpy: unsupported dtype {arr.dtype}")

    def _host_arrays(self):
        """Host mirrors of (data, valid, int_flag), fetched at most once."""
        if self._host_fetch is None:
            data = (
                self._np_cache if self._np_cache is not None
                else to_host(self.data)
            )
            if self.valid is None:
                valid = None
            elif self._np_valid is not None:
                valid = self._np_valid
            else:
                valid = to_host(self.valid)
            iflag = (
                to_host(self.int_flag) if self.int_flag is not None else None
            )
            self._host_fetch = (data, valid, iflag)
        return self._host_fetch

    def to_values(self, row_mask: Optional[np.ndarray] = None) -> List[Any]:
        """Decode to Python values (respecting validity)."""
        if self.kind == OBJ:
            vals = list(self.data)
        else:
            data, valid, iflag = self._host_arrays()
            vals = _decode_host(self.kind, data, valid, iflag, self.vocab)
        if row_mask is not None:
            vals = [v for v, keep in zip(vals, row_mask) if keep]
        return vals

    # -- ops ---------------------------------------------------------------

    def take(self, idx) -> "Column":
        """Gather rows by index (device tensor, or host array for OBJ)."""
        if self.kind == OBJ:
            return Column(OBJ, self.data[to_host(idx)], None)
        from .jit_ops import cols_take

        d, v, i = cols_take({"c": (self.data, self.valid, self.int_flag)}, idx)["c"]
        return Column(self.kind, d, v, self.vocab, int_flag=i)

    def valid_mask(self) -> Any:
        if self.kind == OBJ:
            return to_device(np.array([v is not None for v in self.data], bool))
        if self.valid is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.data.device)
        return self.valid

    def slice(self, lo: int, hi: int) -> "Column":
        """Contiguous row slice (a view — no gather)."""
        if self.kind == OBJ:
            return Column(OBJ, self.data[lo:hi], None)
        data = self.data[lo:hi]
        valid = self.valid[lo:hi] if self.valid is not None else None
        iflag = self.int_flag[lo:hi] if self.int_flag is not None else None
        return Column(self.kind, data, valid, self.vocab, int_flag=iflag)

    def cypher_type(self) -> CypherType:
        base = {
            I64: T.CTInteger,
            F64: T.CTFloat,
            BOOL: T.CTBoolean,
            STR: T.CTString,
            OBJ: T.CTAny,
        }[self.kind]
        if self.kind == F64 and self.int_flag is not None:
            base = T.join_types([T.CTInteger, T.CTFloat])
        has_null = (
            self.valid is not None and not self.pad_synth
        ) or self.kind == OBJ
        return base.nullable if has_null else base


def mask_to_idx_bucketed(mask) -> Tuple[Any, int]:
    """``mask_to_idx`` with the index tensor padded to the shape bucket:
    (index tensor of ``round_size(count)`` lanes, true count). Pad lanes
    hold index 0; consumers mark lanes at or past ``count`` invalid."""
    from ...runtime.faults import fault_point
    from .bucketing import round_size
    from .jit_ops import mask_nonzero, mask_sum

    fault_point("compact")
    count = int(mask_sum(mask))
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
    return Column(OBJ, _obj_array([value] * n), None)
