"""The ``intersect`` kernel: the WCOJ sorted-key range count.

Replaces ``tpu_cypher/backend/tpu/pallas/intersect.py``
(``_range_count_kernel`` / ``_range_count_pallas``; entry
``intersect_range_count``). The CUDA source is ``csrc/range_count.cu``;
its note states the bound on the H100 (25 bytes per query with the keys
L2-resident, or the search's int32 operations, whichever is larger) and
what the design does about it.

Beside it, the plain PyTorch version ``range_count_plain``: two
``torch.searchsorted`` calls, a ``where`` and a sum, the counterpart of
the reference's ``_range_count_jnp``. The total is a ``torch.sum`` on
either tier, as the reference sums outside its kernel too.

Eligibility is re-derived for this card. The reference caps the
power-of-two padded key list at 2**20 because both int32 key planes must
fit VMEM; here the keys stay in device memory, so only these bound the
call: int64 keys, ``0 < nk < 2**31`` (the kernel's int32 positions; the
CSR already caps an edge list there) and ``nq > 0``. An SF10 KNOWS key
list (4.5M keys) is eligible.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, dispatch

_INT32_MAX = 2**31 - 1

dispatch.register(
    "intersect",
    "kernel_intersect",
    replaces="tpu_cypher/backend/tpu/pallas/intersect.py:106",
    source="tpu_cypher_torch/csrc/range_count.cu",
)


def range_count_plain(keys, q, qvalid):
    """Per query: the left insertion point in the ascending ``keys`` and
    the count of keys equal to it (0 where ``qvalid`` is False), both
    int64, plus their int64 total."""
    lo = torch.searchsorted(keys, q, side="left")
    hi = torch.searchsorted(keys, q, side="right")
    counts = torch.where(qvalid, hi - lo, torch.zeros_like(lo))
    return lo, counts, torch.sum(counts)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.lib("range_count").range_count_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def range_count_cuda(keys, q, qvalid):
    """Launch the kernel: (lo, counts) int64 for every query lane. Raises
    on what the kernel does not take."""
    dev = keys.device
    if dev.type != "cuda" or q.device != dev or qvalid.device != dev:
        raise ValueError("intersect: tensors must be on one CUDA device")
    if (keys.dtype, q.dtype, qvalid.dtype) != (torch.int64, torch.int64, torch.bool):
        raise TypeError("intersect: keys and q must be int64, qvalid bool")
    if not (keys.is_contiguous() and q.is_contiguous() and qvalid.is_contiguous()):
        raise ValueError("intersect: inputs must be contiguous")
    nk, nq = int(keys.shape[0]), int(q.shape[0])
    if int(qvalid.shape[0]) != nq:
        raise ValueError("intersect: qvalid must have one entry per query")
    if not 0 < nk <= _INT32_MAX:
        raise ValueError("intersect: the key list must be non-empty and fit int32")
    lo = torch.empty(nq, dtype=torch.int64, device=keys.device)
    counts = torch.empty(nq, dtype=torch.int64, device=keys.device)
    if nq == 0:
        return lo, counts
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    _build.check(
        _launch_fn()(
            keys.data_ptr(), nk, q.data_ptr(), qvalid.data_ptr(),
            lo.data_ptr(), counts.data_ptr(), nq, stream,
        ),
        "intersect",
    )
    return lo, counts


def _range_count_kernel_tier(keys, q, qvalid):
    lo, counts = range_count_cuda(keys, q.contiguous(), qvalid.contiguous())
    return lo, counts, torch.sum(counts)


def intersect_range_count(keys, q, qvalid):
    """Dispatching drop-in for the reference's ``intersect_range_count``:
    per query lane the first sorted key position matching ``q`` and the
    match count (0 where ``qvalid`` is False), plus the int64 total.
    ``keys`` must be ascending int64."""
    nk = int(keys.shape[0])
    eligible = (
        0 < nk <= _INT32_MAX
        and int(q.shape[0]) > 0
        and keys.dtype == torch.int64
        and q.dtype == torch.int64
    )
    return dispatch.launch(
        "intersect",
        lambda: _range_count_kernel_tier(keys, q, qvalid),
        lambda: range_count_plain(keys, q, qvalid),
        device=q.device,
        eligible=eligible,
    )
