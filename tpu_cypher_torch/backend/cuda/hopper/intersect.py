"""The ``intersect`` kernel: the WCOJ sorted-key range count.

Replaces ``tpu_cypher/backend/tpu/pallas/intersect.py``
(``_range_count_kernel`` / ``_range_count_pallas``; entry
``intersect_range_count``). The CUDA source is ``csrc/range_count.cu``;
its note states the bound on the H100 (the keys once, 25 bytes per query
and the index, with the keys L2-resident) and the design: a bucket-start
table over the high bits of the keys, a 16-byte record per bucket (its
start and, for a bucket of at most 6 keys, their 16-bit offsets, else
its end), then a search in which each query reads its bucket's record
and, only for a large bucket, searches that bucket's short range of keys.

Beside it, the plain PyTorch version ``range_count_plain``: two
``torch.searchsorted`` calls, a ``where`` and a sum, the counterpart of
the reference's ``_range_count_jnp``. The total is a ``torch.sum`` on
either tier, as the reference sums outside its kernel too.
``bucket_start_plain`` computes the index's bucket starts by torch ops.

Eligibility is re-derived for this card. The reference caps the
power-of-two padded key list at 2**20 because both int32 key planes must
fit VMEM; here the keys stay in device memory, so only these bound the
call: int64 keys, ``0 < nk < 2**31`` (the kernel's int32 positions; the
CSR already caps an edge list there) and ``nq > 0``. An SF10 KNOWS key
list (4.5M keys) is eligible. The key cap is
``optimizer.cost.pallas_cap("intersect")``, which a pinned
``TPU_CYPHER_PALLAS_MAX_KEYS`` may lower.
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
    impls=("_lib", "_launch"),
)


def range_count_plain(keys, q, qvalid):
    """Per query: the left insertion point in the ascending ``keys`` and
    the count of keys equal to it (0 where ``qvalid`` is False), both
    int64, plus their int64 total."""
    lo = torch.searchsorted(keys, q, side="left")
    hi = torch.searchsorted(keys, q, side="right")
    counts = torch.where(qvalid, hi - lo, torch.zeros_like(lo))
    return lo, counts, torch.sum(counts)


def bucket_bits(nk: int) -> int:
    """log2 of the index's bucket count B for ``nk`` keys: the largest
    power of two at most nk/2 (2 to 4 keys a bucket over the key span, so
    that most buckets fit their record's 6 inline keys), and at least 2
    buckets."""
    return min(30, max(1, (nk // 2).bit_length() - 1))


def bucket_start_plain(keys, bits: int):
    """The index's bucket starts, by torch ops: ``start[b]`` = the left
    insertion point of ``kmin + (b << shift)`` for b < 2**bits (``nk``
    where that value lies past the last key), and ``start[2**bits]`` =
    nk, int32; ``shift`` = max(0, bit_length(kmax - kmin) - bits)."""
    nk, nb = int(keys.shape[0]), 1 << bits
    kmin, kmax = int(keys[0]), int(keys[-1])
    shift = max(0, (kmax - kmin).bit_length() - bits)
    live = ((kmax - kmin) >> shift) + 1  # buckets whose first value is <= kmax
    b = torch.arange(live, dtype=torch.int64, device=keys.device)
    # kmin + (b << shift) in two halves, so that no partial sum leaves int64
    half = b << max(shift - 1, 0)
    first = kmin + half + (half if shift else 0)
    start = torch.full((nb + 1,), nk, dtype=torch.int32, device=keys.device)
    start[:live] = torch.searchsorted(keys, first, side="left").to(torch.int32)
    return start


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("range_count")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.range_count_launch.argtypes = [p, i64, ctypes.c_int, p, p, p, p, p, p, i64, p]
    lib.range_count_launch.restype = ctypes.c_int
    return lib


def range_count_cuda(keys, q, qvalid, bits=None):
    """Launch the index and the search kernels: (lo, counts) int64 for
    every query lane. ``bits`` overrides ``bucket_bits(nk)``. Raises on
    what the kernels do not take."""
    dev = keys.device
    if dev.type != "cuda" or q.device != dev or qvalid.device != dev:
        raise ValueError("intersect: tensors must be on one CUDA device")
    return _launch(keys, q, qvalid, bits)


def _launch(keys, q, qvalid, bits=None):
    """Check dtypes and shapes, allocate the outputs, the bucket starts and
    the bucket records (torch's caching allocator, on the launch's
    stream) and make the one ctypes call (the device check is the
    caller's)."""
    if (keys.dtype, q.dtype, qvalid.dtype) != (torch.int64, torch.int64, torch.bool):
        raise TypeError("intersect: keys and q must be int64, qvalid bool")
    if not (keys.is_contiguous() and q.is_contiguous() and qvalid.is_contiguous()):
        raise ValueError("intersect: inputs must be contiguous")
    nk, nq = int(keys.shape[0]), int(q.shape[0])
    if int(qvalid.shape[0]) != nq:
        raise ValueError("intersect: qvalid must have one entry per query")
    if not 0 < nk <= _INT32_MAX:
        raise ValueError("intersect: the key list must be non-empty and fit int32")
    bits = bucket_bits(nk) if bits is None else bits
    if not 1 <= bits <= 30:
        raise ValueError("intersect: the index needs 2 to 2**30 buckets")
    dev = keys.device
    lo = torch.empty(nq, dtype=torch.int64, device=dev)
    counts = torch.empty(nq, dtype=torch.int64, device=dev)
    if nq == 0:
        return lo, counts
    start = torch.empty((1 << bits) + 1, dtype=torch.int32, device=dev)
    records = torch.empty((1 << bits, 4), dtype=torch.int32, device=dev)
    lib, stream = _lib(), _build.stream(dev)
    with dispatch.device_timed(dev, stream):
        rc = lib.range_count_launch(
            keys.data_ptr(), nk, bits, start.data_ptr(), records.data_ptr(), q.data_ptr(),
            qvalid.data_ptr(), lo.data_ptr(), counts.data_ptr(), nq, stream,
        )
    _build.check(rc, "intersect")
    return lo, counts


def _range_count_kernel_tier(keys, q, qvalid):
    lo, counts = range_count_cuda(keys, q.contiguous(), qvalid.contiguous())
    return lo, counts, torch.sum(counts)


def intersect_range_count(keys, q, qvalid):
    """Dispatching drop-in for the reference's ``intersect_range_count``:
    per query lane the first sorted key position matching ``q`` and the
    match count (0 where ``qvalid`` is False), plus the int64 total.
    ``keys`` must be ascending int64."""
    from ....optimizer.cost import pallas_cap

    nk = int(keys.shape[0])
    eligible = (
        0 < nk <= pallas_cap("intersect")
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
