"""The ``expand_rows`` kernel: the CSR expand-materialize row search.

Replaces ``tpu_cypher/backend/tpu/pallas/expand.py`` (``_expand_rows_kernel``
/ ``_expand_rows_pallas``; entry ``expand_materialize_counted``). The CUDA
source is ``csrc/expand_rows.cu``; its note states the bound on the H100
(memory: 8 bytes written per lane, ``cum`` L2-resident) and what the design
does about it.

Beside it, the plain PyTorch version: ``jit_ops.expand_materialize_counted``
(the reference's repeat cascade). Both end in the ONE shared tail,
``jit_ops.finish_expand_counted``, so the tiers cannot drift past the
(row, edge) lanes; pad lanes agree once that tail has sanitized them.

Eligibility is re-derived for this card. The reference caps the frontier
at 2**18 rows because its ``cum``/``starts`` state must fit VMEM; here both
live in device memory and only the int32 lane and edge ranges bound the
call (a 449,972-row frontier is eligible).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import jit_ops as J
from . import _build, dispatch

_INT32_MAX = 2**31 - 1

dispatch.register(
    "expand_rows",
    "kernel_expand",
    replaces="tpu_cypher/backend/tpu/pallas/expand.py:82",
    source="tpu_cypher_torch/csrc/expand_rows.cu",
)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.lib("expand_rows").expand_rows_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def expand_rows_cuda(cum: torch.Tensor, starts: torch.Tensor, size: int):
    """Launch the kernel: int32 (row, edge) for ``size`` output lanes from
    the frontier's int32 degree cumsum ``cum`` (F+1 stops, leading 0) and
    int32 ``starts`` (F rows). Raises on what the kernel does not take."""
    if cum.device.type != "cuda" or starts.device != cum.device:
        raise ValueError("expand_rows: tensors must be on one CUDA device")
    if cum.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("expand_rows: cum and starts must be int32")
    if not (cum.is_contiguous() and starts.is_contiguous()):
        raise ValueError("expand_rows: inputs must be contiguous")
    nstops = int(cum.shape[0])
    if nstops != int(starts.shape[0]) + 1:
        raise ValueError("expand_rows: cum must hold one stop more than starts")
    if not 0 <= size <= _INT32_MAX or nstops > _INT32_MAX:
        raise ValueError("expand_rows: lanes and stops must fit int32")
    row = torch.empty(size, dtype=torch.int32, device=cum.device)
    edge = torch.empty(size, dtype=torch.int32, device=cum.device)
    if size == 0:
        return row, edge
    if nstops < 2:
        raise ValueError("expand_rows: lanes need a non-empty frontier")
    stream = torch.cuda.current_stream(cum.device).cuda_stream
    _build.check(
        _launch_fn()(
            cum.data_ptr(), nstops, starts.data_ptr(), row.data_ptr(),
            edge.data_ptr(), size, stream,
        ),
        "expand_rows",
    )
    return row, edge


def frontier_state(rp, pos, deg):
    """``starts`` = rp[pos] and the int32 degree cumsum with a leading 0,
    built by torch ops exactly as the TPU wrapper builds them."""
    starts = rp[pos].to(torch.int32).contiguous()
    cum = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=deg.device),
        torch.cumsum(deg, 0).to(torch.int32),
    ])
    return cum, starts


def expand_materialize_counted_cuda(rp, ci, eo, pos, deg, nvalid, size: int):
    """Kernel tier of ``expand_materialize_counted``: frontier state by
    torch ops, the row search on the card, then the shared tail."""
    cum, starts = frontier_state(rp, pos, deg)
    row, edge = expand_rows_cuda(cum, starts, size)
    return J.finish_expand_counted(
        ci, eo, row.to(torch.int64), edge.to(torch.int64), nvalid, size
    )


def expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, *, size: int):
    """Dispatching drop-in for ``jit_ops.expand_materialize_counted``:
    (row, nbr, orig, live) for ``size`` lanes, ``nvalid`` of them live."""
    frontier = int(pos.shape[0])
    eligible = (
        0 < size <= _INT32_MAX
        and 0 < frontier < _INT32_MAX
        and rp.dtype == torch.int32
        and ci.dtype == torch.int32
    )
    return dispatch.launch(
        "expand_rows",
        lambda: expand_materialize_counted_cuda(rp, ci, eo, pos, deg, nvalid, size),
        lambda: J.expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, size),
        device=pos.device,
        eligible=eligible,
    )
