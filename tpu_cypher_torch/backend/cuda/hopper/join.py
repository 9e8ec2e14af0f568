"""The ``join_probe`` kernel: the equi-join probe over a hash table.

Replaces ``tpu_cypher/backend/tpu/pallas/join.py`` (``_probe_kernel`` /
``_hash_probe_pallas``, driven by ``join_probe_bucketed``, and the jnp
``_hash_build`` that feeds it). The CUDA source is ``csrc/hash_probe.cu``:
a build kernel behind one memset, and a probe kernel that also writes the
total. Its note states the bound on the H100 (per probe lane the key at
its own width, a byte per mask and 16 B out; the table once) and what the
design does about it.

The kernel tier is three device operations on the call's stream (the
memset, the build, the probe) and allocates four tensors (the table with
its bound row, ``lo``, counts and the total); it syncs nothing with the
host. Both kernels read the keys where they lie, at their own width: the
build gathers ``rd[r_order[i]]`` for the ``nvalid`` valid sorted rows, the
probe reads ``ld`` and ANDs up to two validity masks (the wrapper folds
more with torch ops first; only multi-key joins have more). Integer keys
widen to int64 as ``.to(torch.int64)`` does, float keys are the bits of
``x + 0.0`` (so -0.0 and 0.0 are one key), and a NaN probe key is
invalid, as ``jit_ops.join_probe`` has it.

The build gives each unique key the first free slot on its linear path
from the reference's hash, claimed with one ``atomicCAS`` in one launch
(no claim rounds), and records the largest offset any key needed; the
probe runs to that bound and stops early at an empty slot, so it is exact
by construction and never declines for the data's sake. Which of two
colliding keys gets the nearer slot depends on which CAS lands first, so
the kernel's table is held to its plain version ``hash_build`` (the
reference's claim rounds, slot for slot with the reference in
``tests/test_torch_join.py``) by ``table_invariants``: what the probe
reads is the same.

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

from ....obs.trace import sync as host_sync
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
    impls=("_lib", "_build_launch", "_probe_launch"),
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
    their bits, see ``plain_keys``). Returns (table, max_off): ``table`` is
    int32 of shape (size, 4), one slot per row as (key lo32, key hi32,
    first sorted position, run length), run length 0 marking an empty slot;
    every key sits at offset <= ``max_off`` from its hash slot. ``size``
    defaults to ``table_size``.

    The rounds keep fixed shapes over the unique keys; lanes that do not win
    a round write to a dump slot past the table, as in the reference."""
    dev, nvalid = keys.device, int(keys.shape[0])
    first = torch.ones(nvalid, dtype=torch.bool, device=dev)
    first[1:] = keys[1:] != keys[:-1]
    with host_sync("join"):
        # tpulint: allow[pad-invariant] reason=the plain build's key run starts: their count sizes a hash table that rounds up pow2 (table_size)
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
        left = live.any()
        with host_sync("join"):
            # tpulint: allow[host-sync] reason=the build kernel's plain version (CPU tensors, or a check of the kernel): the kernel tier syncs nothing
            done = not bool(left)
        if done:
            break
    # the last round placed the last keys; no key needs more offset
    return table[:size], max(off - 1, 0)


def plain_keys(rd, r_order, nvalid: int, ld, lvalids, is_f64: bool):
    """The keys as the kernels read them, in torch ops: (the valid build
    keys in sorted order, the probe keys, the probe validity or None), all
    int64 but the validity. Integer keys widen as ``.to(torch.int64)``
    does; float keys become their bits after -0.0 is made 0.0, and a NaN
    probe key is invalid (as ``jit_ops.join_probe`` has it)."""
    keys = rd[r_order[:nvalid]]
    lvalid = None
    for m in lvalids:
        lvalid = m if lvalid is None else lvalid & m
    if is_f64:
        nan = torch.isnan(ld)
        lvalid = ~nan if lvalid is None else lvalid & ~nan
        keys = (keys.to(torch.float64) + 0.0).view(torch.int64)
        ld = (ld.to(torch.float64) + 0.0).view(torch.int64)
    return keys.to(torch.int64), ld.to(torch.int64), lvalid


def table_invariants(table, bound: int, keys) -> list:
    """The problems of a table built from ``keys`` (the valid build side's
    int64 keys in sorted order, as ``hash_build`` takes them), found by
    what the probe reads; an empty list when there are none. ``table`` is
    (size, 4) int32 slots (the bound row left off) and ``bound`` its probe
    bound. It holds when:

    * the multiset of (key, first, run) over occupied slots equals
      ``hash_build``'s;
    * as many slots are occupied as there are unique keys;
    * every key sits at an offset <= ``bound`` from its hash slot, with no
      empty slot before it on its path;
    * ``bound`` is the largest such offset (0 with no key).

    Slot order is left free: the build kernel's CAS decides it."""
    size = int(table.shape[0])
    want, _ = hash_build(keys.to(table.device), size)

    def occupied(t):
        """(slots, keys, first positions, runs) of the occupied slots, in
        key order."""
        with host_sync("join_check"):
            # tpulint: allow[pad-invariant] reason=occupied slots of a built table, read by the invariant checker only, never on the query path
            slots = torch.nonzero(t[:, 3] != 0, as_tuple=True)[0]
        k = t.contiguous().view(torch.int64)[:, 0][slots]
        order = torch.argsort(k, stable=True)
        return slots[order], k[order], t[slots[order], 2], t[slots[order], 3]

    g_slots, g_keys, g_first, g_run = occupied(table)
    _, w_keys, w_first, w_run = occupied(want)
    problems = []
    nunique = int(w_keys.shape[0])
    if int(g_keys.shape[0]) != nunique:
        problems.append(f"{int(g_keys.shape[0])} occupied slots for {nunique} unique keys")
        return problems
    if not (torch.equal(g_keys, w_keys) and torch.equal(g_first, w_first)
            and torch.equal(g_run, w_run)):
        problems.append("the occupied slots' (key, first, run) differ from hash_build's")
    # each key's offset from its hash slot, and the empty slots on its path
    # (a prefix count over the table twice over: the path may wrap)
    h = slot_hash(g_keys, size)
    off = (g_slots - h) & (size - 1)
    empty = (table[:, 3] == 0).to(torch.int64)
    before = torch.cat([empty.new_zeros(1), torch.cumsum(torch.cat([empty, empty]), 0)])
    gaps = before[h + off] - before[h]
    worst = int(off.max()) if nunique else 0
    if worst > bound:
        problems.append(f"a key sits at offset {worst}, past the bound {bound}")
    elif worst != bound:
        problems.append(f"the bound {bound} is not the largest offset {worst}")
    with host_sync("join_check"):
        # tpulint: allow[host-sync] reason=a check of the build kernel's table (tests, chip_smoke.py), never on the kernel tier
        any_gap = bool((gaps > 0).any())
    if any_gap:
        problems.append("an empty slot lies on a key's path before the key")
    return problems


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.lib("hash_probe")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hash_build_launch.argtypes = [p, i32, p, i32, i32, p, p]
    lib.hash_build_launch.restype = i32
    lib.hash_probe_launch.argtypes = [p, i32, p, i32, p, p, ctypes.c_int64, p, p, p, p, p]
    lib.hash_probe_launch.restype = i32
    lib.hash_probe_scratch_bytes.argtypes = [i32]
    lib.hash_probe_scratch_bytes.restype = ctypes.c_longlong
    return lib


# the kernels' key-type codes (``csrc/hash_probe.cu``)
_KEY_TYPES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 2, torch.int32: 3,
    torch.int64: 4, torch.float64: 5,
}


def _key_operand(x, is_f64: bool):
    """``x`` as a kernel reads it: (a contiguous tensor, its key-type
    code). Float keys are float64; integer and bool keys keep their width,
    save a type the kernels do not read (int16, say), which widens to
    int64 first."""
    if is_f64:
        x = x.to(torch.float64)
    elif x.dtype not in _KEY_TYPES or x.dtype == torch.float64:
        x = x.to(torch.int64)
    return x.contiguous(), _KEY_TYPES[x.dtype]


def hash_build_cuda(rd, r_order, nvalid: int, size: int, is_f64: bool = False):
    """Build the table of the ``nvalid`` valid build rows ``rd[r_order[:nvalid]]``
    (``join_build``'s key data and order) into ``size`` slots: one memset
    and the build kernel. Returns the (size + 1, 4) int32 table, left on
    the device: ``size`` slots as for ``hash_build``, then a row whose
    first entry is the probe bound."""
    dev = rd.device
    if dev.type != "cuda" or r_order.device != dev:
        raise ValueError("hash_build: rd and r_order must be on one CUDA device")
    return _build_launch(rd, r_order, nvalid, size, is_f64)


def _build_launch(rd, r_order, nvalid: int, size: int, is_f64: bool):
    """Check, allocate the table and make the one ctypes call (the device
    check is the caller's)."""
    if rd.dim() != 1 or r_order.dim() != 1 or r_order.dtype != torch.int64:
        raise TypeError("hash_build: rd must be a vector, r_order an int64 vector")
    if not 0 <= nvalid <= min(int(r_order.shape[0]), _MAX_BUILD):
        raise ValueError(f"hash_build: {nvalid} valid rows of {int(r_order.shape[0])}")
    if size < 2 or size & (size - 1) or size < nvalid:
        raise ValueError(f"hash_build: {size} slots for {nvalid} keys")
    keys, code = _key_operand(rd, is_f64)
    order = r_order.contiguous()
    table = torch.empty(size + 1, 4, dtype=torch.int32, device=rd.device)
    lib, stream = _lib(), _build.stream(rd.device)
    with dispatch.device_timed(rd.device, stream):
        rc = lib.hash_build_launch(
            keys.data_ptr(), code, order.data_ptr(), nvalid, (size - 1).bit_length(),
            table.data_ptr(), stream,
        )
    _build.check(rc, "join_probe (hash build)")
    return table


def hash_probe_cuda(table, ld, lvalids=(), is_f64: bool = False):
    """Probe ``hash_build_cuda``'s table with the keys ``ld`` under the
    validity masks ``lvalids`` (bool, any number): one launch. Returns
    (lo, counts, total), int64, the total 0-d. Raises on what the kernel
    does not take."""
    dev = table.device
    if dev.type != "cuda" or ld.device != dev or any(m.device != dev for m in lvalids):
        raise ValueError("join_probe: tensors must be on one CUDA device")
    return _probe_launch(table, ld, lvalids, is_f64)


def _probe_launch(table, ld, lvalids, is_f64: bool):
    """Check, fold the masks past two, allocate the outputs and make the
    one ctypes call (the device check is the caller's)."""
    if table.dtype != torch.int32 or any(m.dtype != torch.bool for m in lvalids):
        raise TypeError("join_probe: the table int32, the masks bool")
    size = int(table.shape[0]) - 1
    if table.dim() != 2 or table.shape[1] != 4 or size < 2 or size & (size - 1):
        raise ValueError("join_probe: the table must be (2**k + 1, 4) rows, k >= 1")
    if not table.is_contiguous():
        raise ValueError("join_probe: the table must be contiguous")
    nq = int(ld.shape[0])
    if ld.dim() != 1 or any(m.shape != (nq,) for m in lvalids):
        raise ValueError("join_probe: keys and masks must be vectors of one length")
    masks = list(lvalids)
    while len(masks) > 2:
        masks[-2:] = [masks[-2] & masks[-1]]
    masks = [m.contiguous() for m in masks] + [None] * (2 - len(masks))
    q, code = _key_operand(ld, is_f64)
    dev = table.device
    lo = torch.empty(nq, dtype=torch.int64, device=dev)
    counts = torch.empty(nq, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    if nq == 0:
        return lo, counts, total.zero_()
    lib = _lib()
    stream = _build.stream(dev)
    scratch = _build.scratch_ptr("join_probe", dev, lib.hash_probe_scratch_bytes, stream)
    with dispatch.device_timed(dev, stream):
        rc = lib.hash_probe_launch(
            table.data_ptr(), (size - 1).bit_length(), q.data_ptr(), code,
            *(m.data_ptr() if m is not None else None for m in masks),
            nq, lo.data_ptr(), counts.data_ptr(), total.data_ptr(), scratch, stream,
        )
    _build.check(rc, "join_probe")
    return lo, counts, total


def _join_probe_kernel_tier(rd, r_order, ld, lvalids, nvalid: int, is_f64: bool):
    table = hash_build_cuda(rd, r_order, nvalid, table_size(nvalid), is_f64)
    lo, counts, total = hash_probe_cuda(table, ld, lvalids, is_f64)
    return r_order[:nvalid], lo, counts, total


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
