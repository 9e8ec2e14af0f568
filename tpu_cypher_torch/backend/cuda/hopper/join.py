"""The ``join_probe`` kernel: the equi-join probe over a hash table.

Replaces ``tpu_cypher/backend/tpu/pallas/join.py`` (``_probe_kernel`` /
``_hash_probe_pallas``, driven by ``join_probe_bucketed``, and the jnp
``_hash_build`` that feeds it). The CUDA source is ``csrc/hash_probe.cu``:
a build kernel and a probe kernel. Its note states the bound on the H100
(25 bytes per probe lane plus the table once) and what the design does
about it.

The build keeps the reference's hash and claim rule: claim rounds over
the unique keys of the valid-first sorted build side, in which every
unplaced key tries slot ``(h + round) & (size - 1)`` and the smallest lane
wins a free slot. So at the same ``size`` its table equals the
reference's slot for slot. Unlike the reference it claims until every key
is placed (the reference stops after 16 rounds and answers from
searchsorted) and records the largest offset any key needed; the probe
runs to that bound and stops early at an empty slot, so it is exact by
construction and never declines for the data's sake. The build kernel
runs all rounds in one launch and leaves the bound on the device, so the
kernel tier syncs nothing with the host. ``hash_build`` is the build's
plain version in torch ops, held slot for slot against the reference
(``tests/test_torch_join.py``) and against the kernel (``chip_smoke.py``).

The probe's plain version is ``jit_ops.join_probe``: two
``torch.searchsorted`` over the sorted build keys, a ``where`` and a sum.
Both tiers return (valid build rows, lo, counts, total) with ``lo`` zeroed
wherever the count is 0, so they agree bit for bit on every lane.

Eligibility is re-derived for this card. The reference caps the build at
2**17 keys because its four table vectors must fit VMEM, and keeps float
keys on searchsorted because a bitwise compare would split -0.0 from 0.0.
Here the table stays in device memory, and float keys are made 0.0 where
they are -0.0 before their bits are read as int64 keys (NaN keys are
invalid on both sides, as in ``join_build``), so sorted runs of equal
float keys stay runs of one bit pattern. Only these bound the call: one
dimension on each side, a non-empty probe and ``nvalid <= 2**30`` (the
table's ``2 * nvalid`` slots take uint32 indices). A build with no valid
key is a table of empty slots, which the kernel probes like any other.
The build cap is ``optimizer.cost.pallas_cap("join")``, which a pinned
``TPU_CYPHER_PALLAS_MAX_BUILD`` may lower.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import jit_ops as J
from ..bucketing import round_up_pow2
from . import _build, dispatch

_MAX_BUILD = 2**30
_MIX_LO = 2654435761
_MIX_HI = 2246822519

dispatch.register(
    "join_probe",
    "kernel_join",
    replaces="tpu_cypher/backend/tpu/pallas/join.py:167",
    source="tpu_cypher_torch/csrc/hash_probe.cu",
    impls=("_lib", "hash_build_cuda", "hash_probe_cuda"),
)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32 in int64 without overflow:
    torch has no uint32 multiply, and the full product can pass 2**63."""
    low = (x & 0xFFFF) * c
    high = ((x >> 16) * (c & 0xFFFF)) & 0xFFFF
    return (low + (high << 16)) & 0xFFFFFFFF


def slot_hash(keys: torch.Tensor, size: int) -> torch.Tensor:
    """The reference's multiplicative uint32 mix of an int64 key's two
    halves, shifted to ``[0, size)`` (``size`` a power of two >= 2)."""
    m = (size - 1).bit_length()
    lo = keys & 0xFFFFFFFF
    hi = (keys >> 32) & 0xFFFFFFFF
    return (_mul32(lo, _MIX_LO) ^ _mul32(hi, _MIX_HI)) >> (32 - m)


def table_size(nvalid: int) -> int:
    """Slots for ``nvalid`` valid build rows: the smallest power of two >=
    2 * nvalid (load <= 1/2 whatever the duplicates), as the reference
    sizes its table from the valid build count."""
    return round_up_pow2(2 * nvalid, 2)


def hash_build(keys, size: int = 0):
    """The build kernel's plain version: the open-addressing table over the
    unique keys of ``keys``, the int64 keys of the valid build side in
    ``join_build``'s order (equal keys contiguous; float keys come as
    their bits, see ``_probe_keys``). Returns (table, max_off): ``table`` is
    int32 of shape (size, 4), one slot per row as (key lo32, key hi32,
    first sorted position, run length), run length 0 marking an empty slot;
    every key sits at offset <= ``max_off`` from its hash slot. ``size``
    defaults to ``table_size``.

    The rounds keep fixed shapes over the unique keys; lanes that do not win
    a round write to a dump slot past the table, as in the reference."""
    dev, nvalid = keys.device, int(keys.shape[0])
    first = torch.ones(nvalid, dtype=torch.bool, device=dev)
    first[1:] = keys[1:] != keys[:-1]
    fpos = torch.nonzero(first, as_tuple=True)[0]
    nu = int(fpos.shape[0])
    cnt = torch.diff(fpos, append=torch.tensor([nvalid], dtype=torch.int64, device=dev))
    ukeys = keys[fpos]
    size = size or table_size(nvalid)
    if size < max(nu, 2) or size & (size - 1):
        raise ValueError(f"hash_build: {size} slots cannot hold {nu} keys")
    h = slot_hash(ukeys, size)
    table = torch.zeros(size + 1, 4, dtype=torch.int32, device=dev)
    key_col = table.view(torch.int64)[:, 0]
    fpos32, cnt32 = fpos.to(torch.int32), cnt.to(torch.int32)
    lane = torch.arange(nu, dtype=torch.int64, device=dev)
    dump = torch.full((), size, dtype=torch.int64, device=dev)
    live = torch.ones(nu, dtype=torch.bool, device=dev)
    off = 0
    while nu:
        trial = (h + off) & (size - 1)
        want = live & (table[trial, 3] == 0)
        claim = torch.full((size + 1,), nu, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, trial, dump), lane, "amin")
        win = want & (claim[trial] == lane)
        slot = torch.where(win, trial, dump)
        key_col[slot] = ukeys
        table[slot, 2] = fpos32
        table[slot, 3] = cnt32
        live &= ~win
        off += 1
        # tpulint: allow[host-sync] reason=the build kernel's plain version (CPU tensors, or a check of the kernel): the kernel tier syncs nothing
        if not bool(live.any()):
            break
    # the last round placed the last keys; no key needs more offset
    return table[:size], max(off - 1, 0)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("hash_probe")
    p = ctypes.c_void_p
    lib.hash_build_launch.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, p, p, p]
    lib.hash_build_launch.restype = ctypes.c_int
    lib.hash_probe_launch.argtypes = [
        p, ctypes.c_int, p, p, p, p, p, ctypes.c_int64, p,
    ]
    lib.hash_probe_launch.restype = ctypes.c_int
    return lib


def hash_build_cuda(keys, size: int):
    """Launch the build kernel over ``keys`` (int64, as for ``hash_build``)
    into ``size`` slots. Returns (table, max_off): the (size, 4) int32
    table and a one-element int32 tensor holding the probe bound, both
    left on the device."""
    dev = keys.device
    if dev.type != "cuda" or keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("hash_build: keys must be one int64 CUDA vector")
    n = int(keys.shape[0])
    if size < 2 or size & (size - 1) or size < n or n > _MAX_BUILD:
        raise ValueError(f"hash_build: {size} slots for {n} keys")
    keys = keys.contiguous()
    table = torch.empty(size, 4, dtype=torch.int32, device=dev)
    claim = torch.empty(size, dtype=torch.int32, device=dev)
    off = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    stream = _build.stream(dev)
    _build.check(
        _lib().hash_build_launch(
            keys.data_ptr(), n, (size - 1).bit_length(), table.data_ptr(),
            claim.data_ptr(), off.data_ptr(), meta.data_ptr(), stream,
        ),
        "join_probe (hash build)",
    )
    return table, meta[:1]


def hash_probe_cuda(table, max_off, q, qvalid=None):
    """Launch the probe kernel: (lo, counts) int64 for every probe lane of
    the int64 keys ``q`` (``qvalid``: bool, or None for all valid) against
    ``hash_build_cuda``'s table and its bound ``max_off`` (a one-element
    int32 tensor on the table's device). Raises on what the kernel does
    not take."""
    dev = table.device
    if dev.type != "cuda" or any(
        t is not None and t.device != dev for t in (max_off, q, qvalid)
    ):
        raise ValueError("join_probe: tensors must be on one CUDA device")
    if table.dtype != torch.int32 or max_off.dtype != torch.int32 or (
        q.dtype != torch.int64
    ) or (qvalid is not None and qvalid.dtype != torch.bool):
        raise TypeError("join_probe: table and bound int32, q int64, qvalid bool")
    size = int(table.shape[0])
    if table.dim() != 2 or table.shape[1] != 4 or size < 2 or size & (size - 1):
        raise ValueError("join_probe: the table must be (2**k, 4) slots, k >= 1")
    if not (table.is_contiguous() and q.is_contiguous()) or (
        qvalid is not None and not qvalid.is_contiguous()
    ):
        raise ValueError("join_probe: inputs must be contiguous")
    nq = int(q.shape[0])
    if qvalid is not None and int(qvalid.shape[0]) != nq:
        raise ValueError("join_probe: qvalid must have one entry per probe lane")
    lo = torch.empty(nq, dtype=torch.int64, device=dev)
    counts = torch.empty(nq, dtype=torch.int64, device=dev)
    if nq == 0:
        return lo, counts
    stream = _build.stream(dev)
    _build.check(
        _lib().hash_probe_launch(
            table.data_ptr(), (size - 1).bit_length(), max_off.data_ptr(),
            q.data_ptr(), qvalid.data_ptr() if qvalid is not None else None,
            lo.data_ptr(), counts.data_ptr(), nq, stream,
        ),
        "join_probe",
    )
    return lo, counts


def _probe_keys(rd, r_order, nvalid: int, ld, lvalids, is_f64: bool):
    """The kernel tier's keys: (the valid build keys in sorted order, the
    probe keys, the probe validity or None), all int64 but the validity.
    Float keys become their bits after -0.0 is made 0.0, and a NaN probe
    key is invalid (as ``jit_ops.join_probe`` has it)."""
    keys = rd[r_order[:nvalid]]
    lvalid = None
    for m in lvalids:
        lvalid = m if lvalid is None else lvalid & m
    if is_f64:
        nan = torch.isnan(ld)
        lvalid = ~nan if lvalid is None else lvalid & ~nan
        keys = (keys.to(torch.float64) + 0.0).view(torch.int64)
        ld = (ld.to(torch.float64) + 0.0).view(torch.int64)
    q = ld.to(torch.int64).contiguous()
    return keys.to(torch.int64), q, lvalid.contiguous() if lvalid is not None else None


def _join_probe_kernel_tier(rd, r_order, ld, lvalids, nvalid: int, is_f64: bool):
    keys, q, qvalid = _probe_keys(rd, r_order, nvalid, ld, lvalids, is_f64)
    table, max_off = hash_build_cuda(keys, table_size(nvalid))
    lo, counts = hash_probe_cuda(table, max_off, q, qvalid)
    return r_order[:nvalid], lo, counts, torch.sum(counts)


def join_probe(rd, r_order, ld, lvalids, nvalid: int, *, is_f64: bool, is_bool: bool):
    """Dispatching drop-in for ``jit_ops.join_probe``: (valid build rows,
    lo, counts, total) for the probe keys ``ld`` against the build keys
    ``rd`` in ``join_build``'s valid-first order ``r_order``."""
    from ....optimizer.cost import pallas_cap

    eligible = (
        ld.dim() == 1
        and rd.dim() == 1
        and int(ld.shape[0]) > 0
        and nvalid <= pallas_cap("join")
    )
    return dispatch.launch(
        "join_probe",
        lambda: _join_probe_kernel_tier(rd, r_order, ld, lvalids, nvalid, is_f64),
        lambda: J.join_probe(
            rd, r_order, ld, lvalids, nvalid=nvalid, is_f64=is_f64, is_bool=is_bool
        ),
        device=ld.device,
        eligible=eligible,
    )
