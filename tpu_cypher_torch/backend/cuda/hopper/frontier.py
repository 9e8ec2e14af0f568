"""The ``frontier_deg_sum`` kernel: the single-hop count(*) reduction.

Replaces ``tpu_cypher/backend/tpu/pallas/frontier.py``
(``_deg_sum_kernel`` / ``_csr_deg_sum_pallas``; entry
``csr_frontier_degree_sum``). The CUDA source is
``csrc/frontier_deg_sum.cu``; its note states the bound on the H100 (about
17 bytes per frontier row, so at the slice's 100,000 rows one launch and
the host work around it cost more than the bytes) and the design (one
launch: 16-byte loads of ``pos``, int64 sums per thread, a block partial,
and the last block to finish sums the partials).

The wrapper is thin, since the host is the cost at this size: it checks
dtypes and devices, copies only an input that is not contiguous,
allocates the 0-d output and nothing else (the partials live in one
zeroed scratch buffer per device and stream, which the kernel leaves ready
for the next launch), and makes one ctypes call of eight arguments.

The plain PyTorch version, ``deg_sum_plain``, is the counterpart of the
reference's ``_csr_deg_sum_jnp`` (two gathers and a masked sum).

Eligibility is re-derived for this card: the reference's node cap (a VMEM
budget for the degree vector) and max-degree cap (an int32 block sum) do
not apply — the kernel reads ``row_ptr`` from device memory and sums in
int64 — so any non-empty frontier is eligible, unless a pinned
``TPU_CYPHER_PALLAS_MAX_NODES`` lowers ``optimizer.cost.pallas_cap("frontier")``
below the node count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch

dispatch.register(
    "frontier_deg_sum",
    "kernel_frontier",
    replaces="tpu_cypher/backend/tpu/pallas/frontier.py:60",
    source="tpu_cypher_torch/csrc/frontier_deg_sum.cu",
    impls=("_lib", "_launch"),
)


def deg_sum_plain(rp, pos, present):
    """Sum over present frontier rows of ``rp[pos+1] - rp[pos]`` (int64)."""
    from ..jit_ops import row_degrees

    deg = row_degrees(rp, pos)
    return torch.sum(torch.where(present, deg, torch.zeros_like(deg)))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("frontier_deg_sum")
    fn = lib.frontier_deg_sum_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.frontier_deg_sum_scratch_bytes.argtypes = [ctypes.c_int]
    lib.frontier_deg_sum_scratch_bytes.restype = ctypes.c_longlong
    return lib


def deg_sum_cuda(rp, pos, present):
    """Launch the kernel; returns a 0-d int64 tensor on the card."""
    dev = pos.device
    if dev.type != "cuda" or rp.device != dev or present.device != dev:
        raise ValueError("frontier_deg_sum: tensors must be on one CUDA device")
    return _launch(rp, pos, present)


def _launch(rp, pos, present):
    """Check dtypes and shapes, allocate the output and make the one ctypes
    call (the device check is the caller's)."""
    dev = pos.device
    if rp.dtype != torch.int32 or pos.dtype != torch.int64 or present.dtype != torch.bool:
        raise TypeError("frontier_deg_sum: rp int32, pos int64, present bool")
    frontier = pos.shape[0]
    if present.shape[0] != frontier:
        raise ValueError("frontier_deg_sum: pos and present differ in length")
    rp, pos, present = rp.contiguous(), pos.contiguous(), present.contiguous()
    out = torch.empty((), dtype=torch.int64, device=dev)
    lib = _lib()
    stream = _build.stream(dev)
    scratch = _build.scratch_ptr("frontier_deg_sum", dev, lib.frontier_deg_sum_scratch_bytes,
                                 stream)
    with dispatch.device_timed(dev, stream):
        rc = lib.frontier_deg_sum_launch(
            rp.data_ptr(), rp.shape[0], pos.data_ptr(), present.data_ptr(), frontier,
            scratch, out.data_ptr(), stream,
        )
    _build.check(rc, "frontier_deg_sum")
    return out


def csr_frontier_degree_sum(rp, pos, present):
    """``sum over frontier rows of (rp[pos+1] - rp[pos])`` with ``present``
    masking, as a 0-d int64 tensor. A graph with no node has no degree to
    read: zero, before the gate."""
    from ....optimizer.cost import pallas_cap

    if int(rp.shape[0]) < 2:
        return torch.zeros((), dtype=torch.int64, device=pos.device)

    eligible = (
        int(pos.shape[0]) > 0
        and rp.dtype == torch.int32
        and int(rp.shape[0]) - 1 <= pallas_cap("frontier")
    )
    return dispatch.launch(
        "frontier_deg_sum",
        lambda: deg_sum_cuda(rp, pos, present),
        lambda: deg_sum_plain(rp, pos, present),
        device=pos.device,
        eligible=eligible,
    )
