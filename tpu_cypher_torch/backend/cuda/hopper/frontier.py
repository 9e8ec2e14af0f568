"""The ``frontier_deg_sum`` kernel: the single-hop count(*) reduction.

Replaces ``tpu_cypher/backend/tpu/pallas/frontier.py``
(``_deg_sum_kernel`` / ``_csr_deg_sum_pallas``; entry
``csr_frontier_degree_sum``). The CUDA source is
``csrc/frontier_deg_sum.cu``; its note states the bound on the H100 (about
17 bytes per frontier row, so at the slice's 100,000 rows it is bound by
its two launches, not by bytes) and the design (grid-stride int64
accumulation, warp-shuffle block reduce, one second pass over the
per-block partials).

The plain PyTorch version, ``deg_sum_plain``, is the counterpart of the
reference's ``_csr_deg_sum_jnp`` (two gathers and a masked sum).

Eligibility is re-derived for this card: the reference's node cap (a VMEM
budget for the degree vector) and max-degree cap (an int32 block sum) do
not apply — the kernel reads ``row_ptr`` from device memory and sums in
int64 — so any non-empty frontier is eligible.
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
)

_MAX_BLOCKS = 1024


def deg_sum_plain(rp, pos, present):
    """Sum over present frontier rows of ``rp[pos+1] - rp[pos]`` (int64)."""
    deg = (rp[pos + 1] - rp[pos]).to(torch.int64)
    return torch.sum(torch.where(present, deg, torch.zeros_like(deg)))


@functools.lru_cache(maxsize=None)
def _launch_fn():
    lib = _build.lib("frontier_deg_sum")
    fn = lib.frontier_deg_sum_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.frontier_deg_sum_threads.restype = ctypes.c_int
    return fn, int(lib.frontier_deg_sum_threads())


def deg_sum_cuda(rp, pos, present):
    """Launch the kernel; returns a 0-d int64 tensor on the card."""
    dev = pos.device
    if dev.type != "cuda" or rp.device != dev or present.device != dev:
        raise ValueError("frontier_deg_sum: tensors must be on one CUDA device")
    if rp.dtype != torch.int32 or pos.dtype != torch.int64 or present.dtype != torch.bool:
        raise TypeError("frontier_deg_sum: rp int32, pos int64, present bool")
    rp, pos, present = rp.contiguous(), pos.contiguous(), present.contiguous()
    frontier = int(pos.shape[0])
    if int(present.shape[0]) != frontier:
        raise ValueError("frontier_deg_sum: pos and present differ in length")
    fn, threads = _launch_fn()
    nblocks = max(1, min(_MAX_BLOCKS, -(-frontier // threads)))
    partials = torch.empty(nblocks, dtype=torch.int64, device=dev)
    out = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        fn(
            rp.data_ptr(), int(rp.shape[0]), pos.data_ptr(), present.data_ptr(),
            frontier, partials.data_ptr(), nblocks, out.data_ptr(), stream,
        ),
        "frontier_deg_sum",
    )
    return out[0]


def csr_frontier_degree_sum(rp, pos, present):
    """``sum over frontier rows of (rp[pos+1] - rp[pos])`` with ``present``
    masking, as a 0-d int64 tensor."""
    eligible = int(pos.shape[0]) > 0 and rp.dtype == torch.int32
    return dispatch.launch(
        "frontier_deg_sum",
        lambda: deg_sum_cuda(rp, pos, present),
        lambda: deg_sum_plain(rp, pos, present),
        device=pos.device,
        eligible=eligible,
    )
