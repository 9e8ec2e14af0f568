"""The ``expand_rows`` kernel: the CSR expand materialize, whole.

Replaces ``tpu_cypher/backend/tpu/pallas/expand.py`` (``_expand_rows_kernel``
/ ``_expand_rows_pallas``; entry ``expand_materialize_counted``). The CUDA
source is ``csrc/expand_rows.cu``; its note states the bound on the H100
(memory: 25 bytes written a lane, 12 read a live lane) and the design: a
small state launch (``starts``, the degree scan and the merge-path
partition points, one pass with a look-back over a scratch buffer kept per
stream), then one launch that merges the lanes with the row starts tile by
tile and writes all four outputs.

Beside it, the plain PyTorch version: ``jit_ops.expand_materialize_counted``
(the reference's repeat cascade and ``finish_expand_counted``), to which
the kernel tier is held bit for bit on the card (``chip_smoke.py``), pad
lanes included. ``frontier_state`` is the plain version of the state step.

Eligibility is re-derived for this card. The reference caps the frontier
at 2**18 rows because its ``cum``/``starts`` state must fit VMEM; here a
block stages only its tile's window of them, so only the int32 lane and
edge ranges bound the call. The frontier cap is
``optimizer.cost.pallas_cap("expand")``, which a pinned
``TPU_CYPHER_PALLAS_MAX_FRONTIER`` may lower.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import jit_ops as J
from . import _build, dispatch

_INT32_MAX = 2**31 - 1

# merge items (lanes plus row starts) a block of the row kernel takes; the
# launch functions refuse any other value than their kTileItems
TILE_ITEMS = 2048

dispatch.register(
    "expand_rows",
    "kernel_expand",
    replaces="tpu_cypher/backend/tpu/pallas/expand.py:82",
    source="tpu_cypher_torch/csrc/expand_rows.cu",
    impls=("_lib", "_launch"),
)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("expand_rows")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.expand_state_launch.argtypes = [p, p, p, i64, i64, i64, i64, p, p, p, p, p]
    lib.expand_state_launch.restype = ctypes.c_int
    lib.expand_rows_launch.argtypes = [
        p, p, p, i64, i64, i64, i64, i64, p, p, p, p, p, p, p,
    ]
    lib.expand_rows_launch.restype = ctypes.c_int
    lib.expand_rows_scratch_bytes.argtypes = [ctypes.c_int]
    lib.expand_rows_scratch_bytes.restype = ctypes.c_longlong
    return lib


def frontier_state(rp, pos, deg):
    """``starts`` = rp[pos] and the int32 degree cumsum with a leading 0,
    built by torch ops exactly as the TPU wrapper builds them: the plain
    version of the kernel tier's state launch."""
    starts = rp[pos].to(torch.int32).contiguous()
    cum = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=deg.device),
        torch.cumsum(deg, 0).to(torch.int32),
    ])
    return cum, starts


def expand_materialize_counted_cuda(rp, ci, eo, pos, deg, nvalid, size: int,
                                    with_orig: bool = True):
    """Kernel tier of ``expand_materialize_counted``: the state launch and
    the row launch. Raises on what the kernels do not take."""
    dev = pos.device
    tensors = (rp, ci, pos, deg) + ((eo,) if with_orig else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("expand_rows: tensors must be on one CUDA device")
    return _launch(rp, ci, eo, pos, deg, nvalid, size, with_orig)


def _launch(rp, ci, eo, pos, deg, nvalid, size: int, with_orig: bool):
    """Check dtypes and ranges, allocate the outputs and make the two ctypes
    calls (the device check is the caller's). ``nvalid`` is the degree
    total, as every caller passes it."""
    if rp.dtype != torch.int32 or ci.dtype != torch.int32:
        raise TypeError("expand_rows: rp and ci must be int32")
    if pos.dtype != torch.int64 or deg.dtype != torch.int64:
        raise TypeError("expand_rows: pos and deg must be int64")
    if with_orig and eo.dtype != torch.int64:
        raise TypeError("expand_rows: eo must be int64")
    frontier = int(pos.shape[0])
    if int(deg.shape[0]) != frontier:
        raise ValueError("expand_rows: pos and deg differ in length")
    if not 0 <= size <= _INT32_MAX or frontier >= _INT32_MAX:
        raise ValueError("expand_rows: lanes and frontier rows must fit int32")
    live = max(0, min(int(nvalid), size))
    if live and not frontier:
        raise ValueError("expand_rows: live lanes need a non-empty frontier")
    dev = pos.device
    # named, so that a copy of a strided input lives until the launches
    rp, ci, pos, deg = (t.contiguous() for t in (rp, ci, pos, deg))
    eo = eo.contiguous() if with_orig else None
    row = torch.empty(size, dtype=torch.int64, device=dev)
    nbr = torch.empty(size, dtype=torch.int64, device=dev)
    orig = torch.empty(size if with_orig else 0, dtype=torch.int64, device=dev)
    live_out = torch.empty(size, dtype=torch.bool, device=dev)
    if size == 0:
        return row, nbr, orig, live_out
    lib = _lib()
    stream = _build.stream(dev)
    ntiles, state = 0, (None, None, None)
    if live:  # the frontier state; without live lanes the row launch only zeroes pads
        ntiles = -(-(live + frontier) // TILE_ITEMS)
        cum = torch.empty(frontier + 1, dtype=torch.int32, device=dev)
        starts = torch.empty(frontier, dtype=torch.int32, device=dev)
        parts = torch.empty(ntiles + 1, dtype=torch.int32, device=dev)
        _build.check(
            lib.expand_state_launch(
                rp.data_ptr(), pos.data_ptr(), deg.data_ptr(), frontier, live,
                ntiles, TILE_ITEMS, starts.data_ptr(), cum.data_ptr(),
                parts.data_ptr(),
                _build.scratch_ptr("expand_rows", dev, lib.expand_rows_scratch_bytes, stream),
                stream,
            ),
            "expand_rows",
        )
        state = (cum.data_ptr(), starts.data_ptr(), parts.data_ptr())
    # only the row launch is timed: its start event queues behind the state
    # kernel, so the pair holds little of the host's launch calls
    with dispatch.device_timed(dev, stream):
        rc = lib.expand_rows_launch(
            *state, frontier, live, ntiles, TILE_ITEMS,
            size, ci.data_ptr(), eo.data_ptr() if with_orig else None,
            row.data_ptr(), nbr.data_ptr(), orig.data_ptr() if with_orig else None,
            live_out.data_ptr(), stream,
        )
    _build.check(rc, "expand_rows")
    return row, nbr, orig, live_out


def expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, *, size: int,
                               with_orig: bool = True):
    """Dispatching drop-in for ``jit_ops.expand_materialize_counted``:
    (row, nbr, orig, live) for ``size`` lanes, ``nvalid`` of them live.
    With ``with_orig=False`` neither tier reads ``eo``, and ``orig`` comes
    back as an empty int64 tensor."""
    from ....optimizer.cost import pallas_cap

    frontier = int(pos.shape[0])
    eligible = (
        0 < size <= _INT32_MAX
        and 0 < frontier <= pallas_cap("expand")
        and rp.dtype == torch.int32
        and ci.dtype == torch.int32
    )
    return dispatch.launch(
        "expand_rows",
        lambda: expand_materialize_counted_cuda(
            rp, ci, eo, pos, deg, nvalid, size, with_orig
        ),
        lambda: J.expand_materialize_counted(
            rp, ci, eo, pos, deg, nvalid, size, with_orig=with_orig
        ),
        device=pos.device,
        eligible=eligible,
    )
