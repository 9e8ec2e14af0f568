"""The ``segment_agg`` kernel: the masked grouped segment reduce.

Replaces ``tpu_cypher/backend/tpu/pallas/aggregate.py``
(``_seg_reduce_kernel_for`` / ``_seg_reduce_pallas``, driven by
``_segment_aggregate_pallas``; entry ``segment_aggregate``). The CUDA source
is ``csrc/segment_reduce.cu``; its note states the bound on the H100
(memory: 12 bytes read per row for int64 values), the design (k <= 256
shared-memory partials per block updated by shared atomics, then a second
pass over the blocks) and how a -0.0 vs 0.0 tie breaks (min -> -0.0,
max -> 0.0, as in the JAX reference).

``_segment_aggregate_cuda`` is the torch driver around the kernel and
mirrors ``_segment_aggregate_pallas`` rule for rule: a count pass, NaN
counted apart and replaced by +-inf before the kernel, BOOL reduced as
int32, identities as the scatter formulation's. The plain PyTorch version
is ``jit_ops.segment_aggregate`` (the counterpart of ``jax.ops.segment_*``
in the reference's ``jit_ops.segment_aggregate``).

Eligibility keeps the reference's semantic rules (count over anything; sum
over I64 only, since float sums reorder; min/max over I64/BOOL/STR/F64
without int_flag bookkeeping) and re-derives the size cap: k <= 256 keeps
one block's partials in 2 KB of shared memory, and fewer than 2**31 rows
keeps the int32 segment ids and counts exact.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import jit_ops as J
from ..jit_ops import BOOL, F64, I64, STR
from . import _build, dispatch

dispatch.register(
    "segment_agg",
    "kernel_agg",
    replaces="tpu_cypher/backend/tpu/pallas/aggregate.py:83",
    source="tpu_cypher_torch/csrc/segment_reduce.cu",
)

MAX_GROUPS = 256
_MAX_BLOCKS = 1024
_ROWS_PER_THREAD = 8
_THREADS = 256
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_OPS = {"sum": 0, "min": 1, "max": 2}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.lib("segment_reduce").segment_reduce_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _identity_bits(identity, dtype) -> int:
    if dtype == torch.float64:
        t = torch.tensor([float(identity)], dtype=torch.float64)
        return int(J.f64_order_keys(t)[0])
    return int(identity)


def seg_reduce_cuda(vals, seg, identity, op: str, k: int):
    """Launch the kernel: ``jax.ops.segment_<op>(vals, seg, num_segments=k)``
    with ``identity`` for empty groups; rows with seg outside [0, k) are
    dead. ``vals`` int32/int64/float64 (no float sum), ``seg`` int32."""
    dev = vals.device
    if dev.type != "cuda" or seg.device != dev:
        raise ValueError("segment_agg: tensors must be on one CUDA device")
    if vals.dtype not in _DTYPES or seg.dtype != torch.int32:
        raise TypeError("segment_agg: vals int32/int64/float64, seg int32")
    if vals.dtype == torch.float64 and op == "sum":
        raise TypeError("segment_agg: float sums are not reduced by the kernel")
    if not 0 < k <= MAX_GROUPS:
        raise ValueError(f"segment_agg: k must be in [1, {MAX_GROUPS}]")
    n = int(vals.shape[0])
    if int(seg.shape[0]) != n or n >= 2**31:
        raise ValueError("segment_agg: vals and seg differ in length or exceed int32")
    vals, seg = vals.contiguous(), seg.contiguous()
    nblocks = max(1, min(_MAX_BLOCKS, -(-n // (_THREADS * _ROWS_PER_THREAD))))
    acc_dtype = torch.int32 if vals.dtype == torch.int32 else torch.int64
    partials = torch.empty(nblocks * k, dtype=acc_dtype, device=dev)
    out = torch.empty(k, dtype=vals.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        _launch_fn()(
            vals.data_ptr(), _DTYPES[vals.dtype], seg.data_ptr(), n, k,
            _OPS[op], _identity_bits(identity, vals.dtype), partials.data_ptr(),
            nblocks, out.data_ptr(), stream,
        ),
        "segment_agg",
    )
    return out


def _segment_aggregate_cuda(data, valid, seg_j, name: str, kind: str, k: int):
    """Kernel-backed mirror of ``jit_ops.segment_aggregate`` for the
    eligible subset (count / int sum / min / max, no int_flag): every
    masking rule, identity and output dtype of the plain version."""
    n = data.shape[0]
    dev = data.device
    v = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    seg32 = seg_j.to(torch.int32)
    cnt = seg_reduce_cuda(v.to(torch.int32), seg32, 0, "sum", k).to(torch.int64)
    if name == "count":
        return cnt, None, None, None
    if name == "sum":  # I64 only (eligibility): zero-filled masked lanes
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ssum = seg_reduce_cuda(
            torch.where(v, data.to(torch.int64), zero), seg32, 0, "sum", k
        )
        return ssum, None, None, None
    d = data.to(torch.int32) if kind == BOOL else data
    if kind == F64:
        isnan = torch.isnan(d) & v
        nn_valid = v & ~isnan
        nan_cnt = seg_reduce_cuda(
            isnan.to(torch.int32), seg32, 0, "sum", k
        ).to(torch.int64)
    else:
        nn_valid = v
        nan_cnt = None
    big = float("inf") if kind == F64 else torch.iinfo(d.dtype).max
    lowest = float("-inf") if kind == F64 else torch.iinfo(d.dtype).min
    if name == "min":
        agged = seg_reduce_cuda(
            torch.where(nn_valid, d, torch.full_like(d, big)), seg32, big, "min", k
        )
        if nan_cnt is not None:
            agged = torch.where(
                (cnt - nan_cnt == 0) & (nan_cnt > 0),
                torch.full_like(agged, float("nan")), agged,
            )
    else:
        low = -big if kind != STR else -1
        agged = seg_reduce_cuda(
            torch.where(nn_valid, d, torch.full_like(d, low)), seg32, lowest,
            "max", k,
        )
        if nan_cnt is not None:
            agged = torch.where(
                nan_cnt > 0, torch.full_like(agged, float("nan")), agged
            )
    if kind == BOOL:
        agged = agged.to(torch.bool)
    return agged, cnt > 0, None, None


def segment_aggregate(data, valid, iflag, seg_j, *, name: str, kind: str, k: int):
    """Dispatching drop-in for ``jit_ops.segment_aggregate`` (same 4-tuple
    contract)."""
    eligible = (
        0 < k <= MAX_GROUPS
        and data.ndim == 1
        and int(data.shape[0]) < 2**31
        and (
            name == "count"
            or (name == "sum" and kind == I64 and iflag is None)
            or (
                name in ("min", "max")
                and kind in (I64, BOOL, STR, F64)
                and iflag is None
            )
        )
    )
    return dispatch.launch(
        "segment_agg",
        lambda: _segment_aggregate_cuda(data, valid, seg_j, name, kind, k),
        lambda: J.segment_aggregate(data, valid, iflag, seg_j, name, kind, k),
        device=data.device,
        eligible=eligible,
    )
