"""The ``segment_agg`` kernel: the masked grouped segment aggregate.

Replaces ``tpu_cypher/backend/tpu/pallas/aggregate.py``
(``_seg_reduce_kernel_for`` / ``_seg_reduce_pallas``, driven by
``_segment_aggregate_pallas``; entry ``segment_aggregate``). The CUDA source
is ``csrc/segment_reduce.cu``; its note states the bound on the H100
(memory: each row's value, validity byte and segment id read once, 8 bytes
a row for a global int64 min), the design (one launch per aggregate: 16-byte
loads, register or per-warp shared partials, and the last block to finish
folds the blocks' partials and writes the outputs) and how a -0.0 vs 0.0
tie breaks (min -> -0.0, max -> 0.0, as in the JAX reference).

``_segment_aggregate_cuda`` is the kernel tier: one launch computes the
count, the NaN count and the sum, min or max, applies the plain version's
NaN rules and writes the 4-tuple's outputs in their own dtypes. What it
hands the kernel — the op and value-type codes, the identity of a group no
row reaches and the fill of a null or NaN row, both as int64 bits (float64
order keys for F64) — is ``kernel_plan``, which mirrors the plain version's
``torch.where(..., full_like(big/low))`` rule by rule. The plain PyTorch
version is ``jit_ops.segment_aggregate`` (the counterpart of
``jax.ops.segment_*`` in the reference's ``jit_ops.segment_aggregate``).

Segment ids are int32 or int64, or ``None`` for a global aggregate
(``k == 1``, every row in group 0): the caller writes no O(n) id array.

Eligibility keeps the reference's semantic rules (count over anything; sum
over I64 only, since float sums reorder; min/max over I64/BOOL/STR/F64
without int_flag bookkeeping) and adds min/max over the one-lane temporal
kinds (DATE's int32 days, LDT/ZDT/ZT/LT's int64 micros), whose payloads
order as their values do, so the plain version reduces them as integers and
the kernel does the same (the reference's eligibility,
``pallas/aggregate.py:199``, lists no temporal kind and sends them to its
jnp path). The size cap is re-derived: k <= 256 keeps one block's per-warp
partials in 32 KB of shared memory, and fewer than
2**31 rows keeps the counts exact in int32. The group cap is
``optimizer.cost.pallas_cap("aggregate")``, which a pinned
``TPU_CYPHER_PALLAS_MAX_GROUPS`` may lower.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from .. import jit_ops as J
from ..column import TEMPORAL_KINDS
from ..jit_ops import BOOL, F64, I64, STR
from . import _build, dispatch

dispatch.register(
    "segment_agg",
    "kernel_agg",
    replaces="tpu_cypher/backend/tpu/pallas/aggregate.py:83",
    source="tpu_cypher_torch/csrc/segment_reduce.cu",
    impls=("_lib", "_launch"),
)

MAX_GROUPS = 256
# the codes of csrc/segment_reduce.cu
OPS = {"count": 0, "sum": 1, "min": 2, "max": 3}
VTYPES = {torch.int32: 1, torch.int64: 2, torch.float64: 3, torch.bool: 4}
STYPES = {torch.int32: 1, torch.int64: 2}


class KernelPlan(NamedTuple):
    """What one aggregate hands the kernel: ``op`` and ``vtype`` codes (0
    for a count, whose values are not read), the output dtype, and the
    int64 bits of ``ident`` (a group no row reaches) and ``fill`` (a null or
    NaN row of a group); float64 bits are order keys."""

    op: int
    vtype: int
    out_dtype: torch.dtype
    ident: int
    fill: int


def f64_key(x: float) -> int:
    """The order-preserving int64 key of one float64 (``jit_ops.f64_order_keys``)."""
    bits = struct.unpack("<q", struct.pack("<d", x))[0]
    return bits ^ 0x7FFFFFFFFFFFFFFF if bits < 0 else bits


@functools.lru_cache(maxsize=None)
def kernel_plan(name: str, kind: str, dtype: torch.dtype) -> KernelPlan:
    """The plain version's identities as kernel arguments: min fills null
    and NaN rows with ``big`` and starts from it; max fills them with
    ``-big`` (``-1`` for string codes) and starts from the type's lowest.
    BOOL takes int8's bounds, as the plain version reduces it as int8."""
    if name == "count":
        return KernelPlan(OPS["count"], 0, torch.int64, 0, 0)
    if dtype not in VTYPES or (kind == F64) != (dtype == torch.float64):
        raise TypeError(f"segment_agg: {name} over {kind} stored as {dtype}")
    if name == "sum":
        if dtype != torch.int64:
            raise TypeError("segment_agg: the kernel sums int64 only")
        return KernelPlan(OPS["sum"], VTYPES[dtype], dtype, 0, 0)
    if kind == F64:
        big, lowest, low = float("inf"), float("-inf"), float("-inf")
    else:
        info = torch.iinfo(torch.int8 if kind == BOOL else dtype)
        big, lowest = info.max, info.min
        low = -big if kind != STR else -1
    ident, fill = (big, big) if name == "min" else (lowest, low)
    if kind == F64:
        ident, fill = f64_key(ident), f64_key(fill)
    return KernelPlan(OPS[name], VTYPES[dtype], dtype, int(ident), int(fill))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("segment_reduce")
    fn = lib.segment_reduce_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.segment_reduce_scratch_bytes.argtypes = [ctypes.c_int]
    lib.segment_reduce_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _segment_aggregate_cuda(data, valid, seg_j, name: str, kind: str, k: int):
    """The kernel tier of ``jit_ops.segment_aggregate`` for the eligible
    subset (count / int64 sum / min / max, no int_flag): one launch, every
    masking rule, identity and output dtype of the plain version.
    ``seg_j``: int32 or int64 ids, or None (every row in group 0)."""
    dev = data.device
    if dev.type != "cuda" or any(
        t is not None and t.device != dev for t in (valid, seg_j)
    ):
        raise ValueError("segment_agg: tensors must be on one CUDA device")
    return _launch(data, valid, seg_j, name, kind, k)


def _launch(data, valid, seg_j, name: str, kind: str, k: int):
    """Check the shapes, allocate the outputs and make the one ctypes call
    (the device check is the caller's)."""
    dev = data.device
    n = data.shape[0]
    if not 0 < k <= MAX_GROUPS or n >= 2**31:
        raise ValueError(f"segment_agg: k must be in [1, {MAX_GROUPS}], rows < 2**31")
    if valid is not None and (valid.dtype != torch.bool or valid.shape[0] != n):
        raise TypeError("segment_agg: valid must be bool, one per row")
    if seg_j is not None and (seg_j.dtype not in STYPES or seg_j.shape[0] != n):
        raise TypeError("segment_agg: segment ids must be int32 or int64, one per row")
    plan = kernel_plan(name, kind, data.dtype)
    # named, so that a copy of a strided input lives until the launch
    data, valid, seg_j = (t if t is None else t.contiguous() for t in (data, valid, seg_j))
    out = torch.empty(k, dtype=plan.out_dtype, device=dev)
    out_valid = torch.empty(k, dtype=torch.bool, device=dev) if plan.op >= OPS["min"] else None
    lib = _lib()
    stream = _build.stream(dev)
    scratch = _build.scratch_ptr("segment_agg", dev, lib.segment_reduce_scratch_bytes, stream)
    with dispatch.device_timed(dev, stream):
        rc = lib.segment_reduce_launch(
            data.data_ptr() if plan.vtype else None, plan.vtype,
            valid.data_ptr() if valid is not None else None,
            seg_j.data_ptr() if seg_j is not None else None,
            STYPES[seg_j.dtype] if seg_j is not None else 0, n, k, plan.op,
            plan.ident, plan.fill, out.data_ptr(),
            out_valid.data_ptr() if out_valid is not None else None, scratch, stream,
        )
    _build.check(rc, "segment_agg")
    return out, out_valid, None, None


def segment_aggregate(data, valid, iflag, seg_j, *, name: str, kind: str, k: int):
    """Dispatching drop-in for ``jit_ops.segment_aggregate`` (same 4-tuple
    contract; ``seg_j`` None is a global aggregate, ``k == 1``)."""
    from ....optimizer.cost import pallas_cap

    eligible = (
        0 < k <= pallas_cap("aggregate")
        and data.ndim == 1
        and int(data.shape[0]) < 2**31
        and (
            name == "count"
            or (name == "sum" and kind == I64 and iflag is None)
            or (
                name in ("min", "max")
                and kind in (I64, BOOL, STR, F64) + TEMPORAL_KINDS
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
