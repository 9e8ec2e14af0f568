"""Torch-op composites for the CudaTable/expand hot path.

The port of the slice's part of ``tpu_cypher/backend/tpu/jit_ops.py``.
PyTorch runs eagerly, so there is no ``jit`` here: each function is a
plain sequence of torch ops on tensors that already live on the backend's
device. Data-dependent output sizes keep the reference's two-phase
discipline: a size pass, one scalar device->host sync, then a materialize
pass at that size (bucket-padded lanes past the true count are dead).

Gathers: ``jnp.take`` under ``jit`` clamps or fills an out-of-range index,
while torch raises on the CPU and trips a device-side assert on CUDA, so
every index gathered with here is in range by construction or clipped
explicitly.

Column dicts map name -> (data, valid_or_None, iflag_or_None), as in the
reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...obs.trace import sync as host_sync

I64 = "i64"
F64 = "f64"
BOOL = "bool"
STR = "str"
DUR = "dur"  # (n, 3) int64: months, days, microseconds (column.DUR)

# the duration order key (api.values.duration_order_us, the oracle's): a
# month is 30.4375 days
from ...api.values import _DUR_DAY_US as DUR_DAY_US  # noqa: E402
from ...api.values import _DUR_MONTH_US as DUR_MONTH_US  # noqa: E402


def dur_order_key(d: torch.Tensor) -> torch.Tensor:
    """The average-length microseconds of (months, days, micros) rows."""
    return d[:, 0] * DUR_MONTH_US + d[:, 1] * DUR_DAY_US + d[:, 2]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    if x.shape[0] > 1:
        out[1:] = torch.cumsum(x[:-1], 0)
    return out


def _repeat_padded(x: torch.Tensor, counts: torch.Tensor, total: int) -> torch.Tensor:
    """``jnp.repeat(x, counts, total_repeat_length=total)``: emissions past
    ``total`` are dropped, and a shortfall repeats ``x``'s LAST value (even
    when its own count is 0) — ``torch.repeat_interleave`` has no such
    argument, so the tail is written explicitly."""
    with host_sync("expand"):
        out = torch.repeat_interleave(x, counts)
    m = int(out.shape[0])
    if m >= total:
        return out[:total]
    if x.shape[0] == 0:
        return torch.zeros(total, dtype=x.dtype, device=x.device)
    return torch.cat([out, x[-1:].expand(total - m)])


def _expand_rows(starts, counts, total: int):
    """Emit ``counts[i]`` rows for source row i; returns (row index per
    output row, flat position ``starts[i] + k`` for the k-th emission of
    row i) — the repeat cascade every segment-materialize shares."""
    nrows = counts.shape[0]
    row = _repeat_padded(_arange(nrows, counts), counts, total)
    base = starts.to(torch.int64) - _exclusive_cumsum(counts)
    flat = _repeat_padded(base, counts, total) + _arange(total, counts)
    return row, flat


def _live_lanes(total: int, nvalid, like: torch.Tensor) -> torch.Tensor:
    """lane < nvalid over a bucket-padded axis of ``total`` lanes."""
    return _arange(total, like) < nvalid


def _pack_fold(keys, pack):
    """Fold integer key tensors into one 63-bit key: ``pack`` holds one
    (lo, bits) per key."""
    ints = [k.to(torch.int64) for k in keys]
    acc = torch.zeros_like(ints[0])
    for k, (lo, b) in zip(ints, pack):
        acc = (acc << b) | (k - lo)
    return acc


def _sort_key(k: torch.Tensor) -> torch.Tensor:
    """A key ``torch.sort`` orders as ``lax.sort`` orders it: bools as int8,
    floats as int64 order keys with -0.0 made 0.0 and every NaN one NaN
    (above +inf). The order keys spare the question of how a device sort
    ranks -0.0 against 0.0."""
    if k.dtype == torch.bool:
        return k.to(torch.int8)
    if k.dtype == torch.float64:
        canon = torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k + 0.0)
        return f64_order_keys(canon)
    return k


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(tuple(reversed(keys)))``: the stable permutation that
    sorts by ``keys[0]``, ties by ``keys[1]`` and so on; equal rows keep
    their order. One stable sort per key, from the last key to the
    primary."""
    n = keys[0].shape[0]
    order = _arange(n, keys[0])
    for k in reversed(keys):
        order = order[torch.sort(_sort_key(k)[order], stable=True).indices]
    return order


# ---------------------------------------------------------------------------
# masks / compaction
# ---------------------------------------------------------------------------


def mask_sum(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask, dtype=torch.int64)


def row_tail_mask(template: torch.Tensor, n) -> torch.Tensor:
    """bool[len(template)]: lane < n — the row validity of a tail-padded
    column axis."""
    return _arange(template.shape[0], template) < n


def concat_pair(a, b):
    return torch.cat([a, b])


def mask_nonzero(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size)[0]``: the True positions, cut or
    zero-padded to ``size`` lanes."""
    with host_sync("compact"):
        # tpulint: allow[pad-invariant] reason=the sized compaction primitive itself: it cuts or zero-pads the exact positions to the caller's size
        idx = torch.nonzero(mask, as_tuple=True)[0]
    m = int(idx.shape[0])
    if m >= size:
        return idx[:size]
    return torch.cat([idx, torch.zeros(size - m, dtype=idx.dtype, device=idx.device)])


def mask_to_idx(mask, site: str = "compact") -> Tuple[Any, int]:
    """Boolean device mask -> (index tensor, count); one scalar sync, timed
    as ``sync:<site>`` (the caller's fault site where it names one)."""
    from ...runtime.faults import fault_point

    fault_point("compact")
    with host_sync(site):
        # tpulint: allow[pad-invariant] reason=the exact-compact primitive itself; bucketed callers go through column.mask_to_idx_bucketed
        idx = torch.nonzero(mask, as_tuple=True)[0]
    return idx, int(idx.shape[0])


def and_valid_mask(data, valid):
    """filter mask = data & valid (valid=None: every row valid)."""
    return data & valid if valid is not None else data


def any_nan_valid(data, valid):
    nan = torch.isnan(data)
    return torch.any(nan & valid if valid is not None else nan)


def take_take(a, idx_outer, idx_inner):
    return a[idx_outer[idx_inner.to(torch.int64)].to(torch.int64)]


# ---------------------------------------------------------------------------
# batched column gathers
# ---------------------------------------------------------------------------


def cols_take(cols: Dict[str, Tuple[Any, Any, Any]], idx):
    idx = idx.to(torch.int64)
    out = {}
    for c, (data, valid, iflag) in cols.items():
        out[c] = (
            data[idx],
            valid[idx] if valid is not None else None,
            iflag[idx] if iflag is not None else None,
        )
    return out


def cols_take_or_null(cols: Dict[str, Tuple[Any, Any, Any]], idx, in_bounds):
    """``cols_take`` where lanes with ``in_bounds`` False come out null
    (their index is clamped to row 0 before the gather)."""
    safe = torch.where(in_bounds, idx.to(torch.int64), torch.zeros((), dtype=torch.int64, device=idx.device))
    out = {}
    for c, (data, valid, iflag) in cols.items():
        d = data[safe]
        v = valid[safe] if valid is not None else torch.ones_like(in_bounds)
        i = iflag[safe] & in_bounds if iflag is not None else None
        out[c] = (d, v & in_bounds, i)
    return out


def tree_take(arrays, idx):
    """Gather a tuple of same-length tensors (or one tensor) by one index."""
    idx = idx.to(torch.int64)
    if isinstance(arrays, torch.Tensor):
        return arrays[idx]
    return tuple(a[idx] for a in arrays)


def cols_take_counted(cols: Dict[str, Tuple[Any, Any, Any]], idx, count):
    """``cols_take`` for a BUCKET-PADDED gather: rows gathered at lanes
    past the true ``count`` come out INVALID."""
    idx = idx.to(torch.int64)
    live = _arange(idx.shape[0], idx) < count
    out = {}
    for c, (data, valid, iflag) in cols.items():
        d = data[idx]
        v = valid[idx] & live if valid is not None else live
        i = iflag[idx] if iflag is not None else None
        out[c] = (d, v, i)
    return out


# ---------------------------------------------------------------------------
# sort-probe join phases
# ---------------------------------------------------------------------------


def _fold_valid(n: int, masks, like: torch.Tensor) -> torch.Tensor:
    valid = torch.ones(n, dtype=torch.bool, device=like.device)
    for m in masks:
        valid = valid & m
    return valid


def join_build(rd, rvalids, is_f64: bool, is_bool: bool):
    """Build-side prep: fold validity masks, NaN-exclude float keys, sort
    valid-first by key. Returns (key data, order, valid count).

    ``jnp.lexsort((rd, ~rvalid))``: equal keys keep their row order as in
    the reference (-0.0 and 0.0 are equal keys; NaN keys are invalid)."""
    rvalid = _fold_valid(rd.shape[0], rvalids, rd)
    if is_f64:
        rvalid = rvalid & ~torch.isnan(rd)
    if is_bool:
        rd = rd.to(torch.int8)
    r_order = _lexsort([~rvalid, rd])
    return rd, r_order, torch.sum(rvalid, dtype=torch.int64)


def join_probe(rd, r_order, ld, lvalids, nvalid: int, is_f64: bool, is_bool: bool):
    """Probe side: binary-search the sorted build keys. Returns (valid
    build row indices, lo, match counts, total), all int64. The plain
    version of the ``join_probe`` kernel, whose contract it states: ``lo``
    is the first sorted build position of the probe key where the count is
    positive, and 0 wherever the count is 0 (the reference leaves the
    insertion point there, which nothing downstream reads)."""
    lvalid = _fold_valid(ld.shape[0], lvalids, ld)
    if is_f64:
        lvalid = lvalid & ~torch.isnan(ld)
    if is_bool:
        ld = ld.to(torch.int8)
    r_idx_valid = r_order[:nvalid]
    r_sorted = rd[r_idx_valid]
    lo = torch.searchsorted(r_sorted, ld, side="left")
    hi = torch.searchsorted(r_sorted, ld, side="right")
    zero = torch.zeros((), dtype=torch.int64, device=ld.device)
    counts = torch.where(lvalid, hi - lo, zero)
    lo = torch.where(counts > 0, lo, zero)
    return r_idx_valid, lo, counts, torch.sum(counts)


def join_materialize(r_idx_valid, lo, counts, total: int):
    """Match pairs: ``counts[i]`` rows for probe row i, at sorted build
    positions ``lo[i] + k``; returns (left rows, right rows)."""
    left_rows, flat = _expand_rows(lo, counts, total)
    if not total:
        return left_rows, torch.zeros(0, dtype=torch.int64, device=lo.device)
    return left_rows, r_idx_valid[flat]


def unmatched_mask(hit_rows, n: int):
    """Bool mask of the rows of an ``n``-row side never matched (outer-join
    padding)."""
    hit = torch.zeros(n, dtype=torch.bool, device=hit_rows.device)
    hit[hit_rows] = True
    return ~hit


def outer_pad_left(left_rows, right_rows, miss_idx, nmiss: int, nmatched: int):
    """Append one all-null-right row per unmatched probe row."""
    dev = left_rows.device
    left = torch.cat([left_rows, miss_idx])
    right = torch.cat([right_rows, torch.zeros(nmiss, dtype=torch.int64, device=dev)])
    matched = torch.cat([
        torch.ones(nmatched, dtype=torch.bool, device=dev),
        torch.zeros(nmiss, dtype=torch.bool, device=dev),
    ])
    return left, right, matched


def outer_pad_right(left_rows, right_rows, right_matched, rmiss_idx, nmiss: int, ncur: int):
    """Append one all-null-left row per unmatched build row (full outer)."""
    dev = left_rows.device
    left = torch.cat([left_rows, torch.zeros(nmiss, dtype=torch.int64, device=dev)])
    right = torch.cat([right_rows, rmiss_idx])
    left_matched = torch.cat([
        torch.ones(ncur, dtype=torch.bool, device=dev),
        torch.zeros(nmiss, dtype=torch.bool, device=dev),
    ])
    right_matched = torch.cat([
        right_matched, torch.ones(nmiss, dtype=torch.bool, device=dev)
    ])
    return left, right, left_matched, right_matched


def extra_keys_keep(l_datas, l_valids, r_datas, r_valids, left_rows, right_rows, kinds):
    """Multi-key equi-join post-filter: AND of per-pair ``=`` equality
    (NaN never matches; validity masks carry match eligibility)."""
    keep = torch.ones(left_rows.shape[0], dtype=torch.bool, device=left_rows.device)
    for ld, lv, rd, rv, k in zip(l_datas, l_valids, r_datas, r_valids, kinds):
        lvals = ld[left_rows]
        eq = lvals == rd[right_rows]
        if k == F64:
            eq = eq & ~torch.isnan(lvals)
        if lv is not None:
            eq = eq & lv[left_rows]
        if rv is not None:
            eq = eq & rv[right_rows]
        keep = keep & eq
    return keep


# ---------------------------------------------------------------------------
# fused CSR expand phases
# ---------------------------------------------------------------------------


def compact_lookup(dev_ids, ids, valid):
    """Element ids -> (compact positions, present mask)."""
    n = dev_ids.shape[0]
    pos = torch.clamp(torch.searchsorted(dev_ids, ids), 0, n - 1)
    ok = dev_ids[pos] == ids
    if valid is not None:
        ok = ok & valid
    return pos.to(torch.int64), ok


def row_degrees(rp, pos) -> torch.Tensor:
    """``rp[pos + 1] - rp[pos]`` as int64. ``pos`` comes from
    ``compact_lookup``, clipped to [0, num_nodes-1], so ``pos + 1`` stays
    inside ``rp``, except on a graph with no node: there ``rp`` has one
    entry, every row is absent, and no gather runs (on the card it would
    read past the row pointers)."""
    if int(rp.shape[0]) < 2:
        return torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    return (rp[pos + 1] - rp[pos]).to(torch.int64)


def expand_degrees_total(rp, pos, present):
    """Per-frontier-row degree (0 for absent rows) and its device total."""
    deg = row_degrees(rp, pos)
    deg = torch.where(present, deg, torch.zeros_like(deg))
    return deg, torch.sum(deg)


def finish_expand_counted(ci, eo, row, edge, nvalid, size: int):
    """Tail of the repeat cascade's expand-materialize: sanitize pad lanes
    to row/edge 0, gather neighbour/edge-orig, mask the gathers dead. With
    ``eo`` None no orig is gathered and ``orig`` is an empty int64 tensor.
    The Hopper kernel (``hopper/expand.py``) computes the same four outputs
    in its own launch and is held to this one bit for bit on the card."""
    live = _live_lanes(size, nvalid, row)
    zero = torch.zeros((), dtype=torch.int64, device=row.device)
    row = torch.where(live, row, zero)
    edge = torch.where(live, edge, zero)
    nbr = torch.where(live, ci[edge].to(torch.int64), zero)
    if eo is None:
        orig = torch.zeros(0, dtype=torch.int64, device=row.device)
    else:
        orig = torch.where(live, eo[edge], zero)
    return row, nbr, orig, live


def expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, size: int,
                               with_orig: bool = True):
    """The plain PyTorch version of the ``expand_rows`` kernel: the
    reference's repeat cascade at a (possibly bucketed) static ``size`` >=
    the true total ``nvalid``; pad lanes come out sanitized and dead. With
    ``with_orig=False`` ``eo`` is not read and ``orig`` is empty."""
    row, edge = _expand_rows(rp[pos], deg, size)
    return finish_expand_counted(ci, eo if with_orig else None, row, edge, nvalid, size)


def into_materialize_counted(eo, lo, counts, nvalid, size: int):
    """Emit ``counts[i]`` lanes for query i at sorted key positions
    ``lo[i] + k``, at a (possibly bucketed) ``size`` >= the true total
    ``nvalid``: (query row, ``eo`` at the key position, live). Pad lanes
    are sanitized to row/edge 0 and come out dead."""
    row, edge = _expand_rows(lo, counts, size)
    live = _live_lanes(size, nvalid, row)
    zero = torch.zeros((), dtype=torch.int64, device=row.device)
    row = torch.where(live, row, zero)
    edge = torch.where(live, edge, zero)
    return row, eo[edge], live


# ---------------------------------------------------------------------------
# the run programs of the factorized tier (factorized.py)
# ---------------------------------------------------------------------------


def csr_run_bounds(rp, pos, present, nvalid: int):
    """Per-lane adjacency run bounds straight off the CSR row pointers:
    ``(lo, cnt, total)``, lane ``i``'s suffix run being
    ``ci[lo[i]:lo[i] + cnt[i]]``. Absent frontier ids and lanes past
    ``nvalid`` carry ``cnt = 0``, so they weigh no flat row; the clip keeps
    the row-pointer gather in range for them."""
    dev = pos.device
    live = present & (torch.arange(pos.shape[0], dtype=torch.int64, device=dev) < nvalid)
    p = torch.clamp(pos, 0, max(int(rp.shape[0]) - 2, 0))
    start = rp[p].to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lo = torch.where(live, start, zero)
    cnt = torch.clamp(torch.where(live, rp[p + 1].to(torch.int64) - start, zero), min=0)
    return lo, cnt, torch.sum(cnt)


def runs_weights(cnts, nlanes: int):
    """Per-lane flat-row weight ``w = prod_j cnt_j`` (0 past ``nlanes``),
    its inclusive cumsum ``W`` and the flat total: lane ``i`` owns flat
    rows ``[W[i] - w[i], W[i])``. Lanes are sized exactly, so ``W`` needs
    no sentinel: a lane of weight 0 ends where its predecessor does, and
    a search ``searchsorted(W, f, right)`` for ``f < total`` lands on the
    lane that owns ``f``."""
    w = torch.clamp(cnts[0].to(torch.int64), min=0)
    for cnt in cnts[1:]:
        w.mul_(torch.clamp(cnt.to(torch.int64), min=0))
    if nlanes < int(w.shape[0]):
        w[nlanes:] = 0
    return w, torch.cumsum(w, 0), torch.sum(w)


def run_positions(i, inner, los, cnts):
    """Per level, the run position of each decoded flat row from its lane
    ``i`` and its within-lane remainder ``inner``: the remainder read as a
    mixed-radix number over the lane's level counts, the last level
    fastest (the flat enumeration order)."""
    pos = []
    for lo, cnt in zip(reversed(los), reversed(cnts)):
        c = torch.clamp(cnt[i], min=1)
        pos.append(lo[i] + inner % c)
        inner = inner // c
    return tuple(reversed(pos))


def drop_loops_mask(nbr, pos, row):
    return nbr != pos[row]


def concat_expand_halves(row1, nbr1, orig1, row2, nbr2, orig2):
    """Undirected expand: the primary half, then the opposite half with
    Start/End reported swapped."""
    swapped = torch.cat([
        torch.zeros(row1.shape[0], dtype=torch.bool, device=row1.device),
        torch.ones(row2.shape[0], dtype=torch.bool, device=row2.device),
    ])
    return (
        torch.cat([row1, row2]),
        torch.cat([nbr1, nbr2]),
        torch.cat([orig1, orig2]),
        swapped,
    )


def gather_swapped(a_data, b_data, a_valid, b_valid, orig, swapped):
    """Start/End columns of an undirected expand: per-row pick between the
    canonical (a) and flipped (b) rel-scan column, gathered by ``orig``."""
    orig = orig.to(torch.int64)
    a = a_data[orig]
    b = b_data[orig]
    data = torch.where(swapped, b, a)
    valid = None
    if a_valid is not None or b_valid is not None:
        ones = torch.ones(orig.shape[0], dtype=torch.bool, device=orig.device)
        av = a_valid[orig] if a_valid is not None else ones
        bv = b_valid[orig] if b_valid is not None else ones
        valid = torch.where(swapped, bv, av)
    return data, valid


def far_lookup(row_map, nbr):
    """Far-end node-scan row per neighbour (-1: lacks the far labels).
    ``nbr`` holds compact ids; the clip keeps a sanitized or stray lane in
    range instead of faulting the gather."""
    n = row_map.shape[0]
    far_rows = row_map[torch.clamp(nbr, 0, max(n - 1, 0))]
    return far_rows, far_rows >= 0


# ---------------------------------------------------------------------------
# the left-outer expand and the ExpandInto probe
# ---------------------------------------------------------------------------


def optional_expand_degrees(rp, pos, present, nrows=None):
    """Row counts for a LEFT-OUTER expand: matched rows emit their degree,
    unmatched (or absent-frontier) rows exactly ONE null-padded row.
    ``nrows``: the table's logical row count; rows past it (bucket pads)
    are not input rows and emit NOTHING (a pad row is not an unmatched
    row). Returns (deg, counts, total)."""
    deg = row_degrees(rp, pos)
    zero = torch.zeros_like(deg)
    deg = torch.where(present, deg, zero)
    counts = torch.clamp(deg, min=1)
    if nrows is not None:
        real = _arange(counts.shape[0], counts) < nrows
        deg = torch.where(real, deg, zero)
        counts = torch.where(real, counts, zero)
    return deg, counts, torch.sum(counts)


def optional_expand_materialize(rp, ci, eo, pos, deg, counts, total: int):
    """(row, nbr, orig, matched) of a left-outer expand: the reference's
    repeat cascade over ``counts``, the plain version of the optional lane
    merge (``expand_op._optional_lanes``). An unmatched row's one lane
    reads the clipped edge at its row start (masked null downstream)."""
    starts = rp[pos].to(torch.int64)
    row, flat = _expand_rows(starts, counts, total)
    matched = (flat - starts[row]) < deg[row]
    nedges = int(ci.shape[0])
    if nedges == 0:
        return (row, torch.zeros(total, dtype=torch.int64, device=row.device),
                torch.zeros(total, dtype=torch.int64, device=row.device), matched)
    safe = torch.clamp(flat, 0, nedges - 1)
    return row, ci[safe].to(torch.int64), eo[safe], matched


def optional_place(deg, counts, total: int, lanes):
    """The tail of the optional lane merge: ``lanes`` (row, nbr, orig) are
    the matched lanes merged over ``deg`` (None when no row matched). When
    every row matched they are the answer as they stand; otherwise each
    goes to its offset in the ``counts`` scan, moved up by the unmatched
    rows before its row, and each unmatched row gets one lane at its row
    start with ``nbr`` and ``orig`` 0 (masked null downstream). The
    layout of ``optional_expand_materialize`` on every lane's row and
    ``matched``, and on every matched lane's ``nbr`` and ``orig``."""
    dev = counts.device
    if lanes is not None and int(lanes[0].shape[0]) == total:
        return (*lanes, torch.ones(total, dtype=torch.bool, device=dev))
    unmatched = counts - deg  # 1 for an unmatched input row, else 0
    # an unmatched row writes its lane at its row start; every other row
    # writes to a dump slot past the end
    at = torch.where(unmatched > 0, _exclusive_cumsum(counts),
                     torch.full_like(counts, total))
    row = torch.empty(total + 1, dtype=torch.int64, device=dev)
    row.index_copy_(0, at, _arange(counts.shape[0], counts))
    row = row[:total]
    nbr = torch.zeros(total, dtype=torch.int64, device=dev)
    orig = torch.zeros(total, dtype=torch.int64, device=dev)
    matched = torch.zeros(total, dtype=torch.bool, device=dev)
    if lanes is not None:
        row_m = lanes[0]
        to = _arange(row_m.shape[0], row_m) + _exclusive_cumsum(unmatched)[row_m]
        for buf, vals in zip((row, nbr, orig), lanes):
            buf[to] = vals
        matched[to] = True
    return row, nbr, orig, matched


def into_probe(s_pos, t_pos, ok, n: int, drop_loops: bool):
    """ExpandInto's probe queries: the ``src*N + dst`` key of each (source,
    target) row and its validity, loop rows dropped for the swapped half
    of an undirected close. The caller range-counts them over the sorted
    edge keys on the ``intersect`` gate: with it, the reference's
    ``into_probe`` (two searchsorted calls)."""
    probe = s_pos * n + t_pos
    if drop_loops:
        ok = ok & (s_pos != t_pos)
    return probe, ok


def concat_into_halves(row1, orig1, row2, orig2):
    """Undirected ExpandInto: the primary half, then the swapped half with
    Start/End reported swapped."""
    swapped = torch.cat([
        torch.zeros(row1.shape[0], dtype=torch.bool, device=row1.device),
        torch.ones(row2.shape[0], dtype=torch.bool, device=row2.device),
    ])
    return torch.cat([row1, row2]), torch.cat([orig1, orig2]), swapped


# ---------------------------------------------------------------------------
# fused count chain: scan -> expand^k -> count(*) without materializing
# ---------------------------------------------------------------------------


def _csr_spmv(rp, ci, w):
    """(A w)[n] = sum of w[ci[e]] over n's CSR edge range, as a cumsum
    difference at row_ptr boundaries (gathers + one scan, no scatter).
    Pad edges (``ci`` = -1) clip to 0 and land past ``rp[-1]``, where no
    boundary reads them."""
    t = w[torch.clamp(ci, min=0).to(torch.int64)]
    ps = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), torch.cumsum(t, 0)])
    rp64 = rp.to(torch.int64)
    return ps[rp64[1:]] - ps[rp64[:-1]]


def _chain_body(dev_ids, ids, valid, hops, num_nodes: int, spmv):
    """The fused count chain (see ``path_count_chain``)."""
    w = torch.ones(num_nodes, dtype=torch.int64, device=dev_ids.device)
    for (rp_a, ci_a, rp_b, ci_b, loop_cnt, mask) in reversed(hops):
        if mask is not None:  # far-label filter of this hop
            w = torch.where(mask, w, torch.zeros_like(w))
        nw = spmv(rp_a, ci_a, w)
        if rp_b is not None:
            nw = nw + spmv(rp_b, ci_b, w) - loop_cnt * w
        w = nw
    # base frontier: one completion-count gather per input row
    pos = torch.clamp(torch.searchsorted(dev_ids, ids), 0, num_nodes - 1)
    present = dev_ids[pos] == ids
    if valid is not None:
        present = present & valid
    return torch.sum(torch.where(present, w[pos], torch.zeros_like(w[pos])))


def path_count_chain(dev_ids, ids, valid, hops, num_nodes: int):
    """Total path count of a typed expand chain WITHOUT materializing any
    intermediate row set, evaluated right to left: ``w[n]`` = number of
    chain completions starting at node n; each hop is one CSR SpMV;
    far-label filters multiply ``w`` by a node mask; the base frontier
    collapses to one gather + sum over the input id column.

    ``hops`` (deepest/first-executed hop first): per hop
    ``(rp_a, ci_a, rp_b, ci_b, loop_cnt, mask)`` — directed hops leave the
    ``_b`` half None; undirected hops carry both orientations and the
    per-node self-loop counts."""
    return _chain_body(dev_ids, ids, valid, hops, num_nodes, _csr_spmv)


def _sharded_spmv(mesh):
    """The SpMV over a CSR whose ``col_idx`` is split into contiguous edge
    slices (``GraphIndex.csr_shards``): per shard a local cumsum over its
    edge range, the ``row_ptr`` bounds clipped into the shard by its start
    offset, the per-node partial sums combined (the reference's
    ``_sharded_spmv``, a ``shard_map`` with one ``psum``). ``rp`` is the
    tuple of per-shard ``row_ptr`` copies, ``ci`` the ``ShardedRows``."""
    from ...parallel.mesh import combine

    def spmv(rp, ci, w):
        parts = []
        for i in mesh.local_shards():
            c, lo, hi = ci.parts[i], ci.bounds[i], ci.bounds[i + 1]
            wi = w.to(c.device)
            t = wi[c.to(torch.int64)]
            ps = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), torch.cumsum(t, 0)])
            r64 = rp[i].to(torch.int64)
            a = torch.clamp(r64[:-1] - lo, 0, hi - lo)
            b = torch.clamp(r64[1:] - lo, 0, hi - lo)
            parts.append(ps[b] - ps[a])
        return combine(mesh, parts, "sum", w.device)

    return spmv


def path_count_chain_on_mesh(mesh):
    """``path_count_chain`` with the sharded SpMV: each hop's tuple carries
    ``GraphIndex.csr_shards``' (per-shard ``row_ptr``, split ``col_idx``)
    in place of ``(rp, ci)``."""
    spmv = _sharded_spmv(mesh)

    def run(dev_ids, ids, valid, hops, num_nodes: int):
        return _chain_body(dev_ids, ids, valid, hops, num_nodes, spmv)

    return run


# ---------------------------------------------------------------------------
# the chain walk: per-hop (base key, position, liveness) frontiers for the
# fused var-length expand, the DISTINCT-endpoints count and the
# relationship-unique chain count. Each function takes one hop's merged
# ``lanes``, the list ``[row, nbr, orig, live]`` of ``expand_rows``
# (``orig`` empty where the walk reads no edge; ``live`` None at the exact
# lane count, the lane < nvalid mask on the bucket lattice), and computes
# what the reference's computes after its ``_expand_rows`` merge: the
# gathers, masks, keys and sort.
# ---------------------------------------------------------------------------


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=like.device)


def _lane_mask(live, mask, nbr):
    """Lanes alive after the far-label mask, or None when every lane is."""
    present = mask[nbr] if mask is not None else None
    if live is not None:
        present = live if present is None else (present & live)
    return present


def rel_rows_of_ids(sorted_ids, perm, q, valid):
    """Canonical rel-scan row per queried global relationship id, or -1
    when the id is not in the scan (or the query row is null): a binary
    search over ``GraphIndex.rel_row_index``, the id-space bridge of the
    var-length walk's forbidden edges."""
    n = sorted_ids.shape[0]
    if n == 0:
        return torch.full(q.shape, -1, dtype=torch.int64, device=q.device)
    i = torch.clamp(torch.searchsorted(sorted_ids, q), 0, n - 1)
    hit = sorted_ids[i] == q
    if valid is not None:
        hit = hit & valid
    return torch.where(hit, perm[i], torch.full_like(perm[i], -1))


def varlen_hop(lanes, row0, prev_edges):
    """One hop of a var-length expansion. State per partial path: origin
    input row ``row0`` (None on the first hop: the expansion row is the
    origin), current node ``nbr`` and the edge scan rows walked so far
    (``prev_edges``). A path that would reuse an edge gets ``iso`` False:
    it emits nothing and expands no further, as the unrolled planner's
    ``id(step_i) <> id(step_j)`` filters."""
    row, nbr, orig, live = lanes
    new_row0 = row0[row] if row0 is not None else row
    new_prev = tuple(pe[row] for pe in prev_edges)
    iso = _ones(row.shape[0], row) if live is None else live
    for pe in new_prev:
        iso = iso & (orig != pe)
    return new_row0, nbr, orig, new_prev + (orig,), iso


def varlen_emit(nbr, iso, row_map):
    """Emission at one path length: far-node scan row (-1 = target labels
    missing), surviving-row mask, surviving count."""
    far = row_map[nbr]
    keep = iso & (far >= 0)
    # tpulint: allow[pad-mask-discipline] reason=iso is all ones only on an unbucketed walk (nvalid None), where round_size is the identity and no lane is padded; a bucketed walk's iso starts from the gate's live mask
    return far, keep, torch.sum(keep, dtype=torch.int64)


def varlen_zero(pos, present, row_map):
    """Length-0 emission: each input row whose source node is present and
    carries the target labels emits itself once (target = source)."""
    far = row_map[pos]
    keep = present & (far >= 0)
    return _arange(pos.shape[0], pos), far, keep, torch.sum(keep, dtype=torch.int64)


def concat_rows(parts):
    """Concatenate per-level (row0, far) pairs into one output frame."""
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


_KEY_SENTINEL = (1 << 62) - 1  # sorts after every valid endpoint key


def distinct_hop_materialize(lanes, akey, mask):
    """One middle hop of a distinct-endpoints chain: expand (pos, akey)
    into per-edge (akey', pos', present'), keeping only the base key and
    the current node. ``mask``: far-label node mask or None."""
    row, nbr, _, live = lanes
    present = _lane_mask(live, mask, nbr)
    return akey[row], nbr, _ones(row.shape[0], row) if present is None else present


def _endpoint_key(akey, row, nbr, use_a: bool, use_c: bool, num_nodes: int):
    """The packed endpoint key per lane, always a tensor of its own (never
    ``akey`` itself), which ``_run_count`` may overwrite."""
    if use_a and use_c:
        key = akey[row]
        return key.mul_(num_nodes).add_(nbr)
    if use_a:
        return akey[row]
    return nbr.clone()


def _run_count(key, present):
    """Distinct keys among the present lanes: absent lanes take the
    sentinel, which sorts after every endpoint key, so the sorted keys'
    runs less the sentinel's own run are the reference's count of
    boundaries under ``valid_n``, with no read of ``valid_n`` on the host.
    ``key`` is overwritten in place."""
    if present is not None:
        key.masked_fill_(~present, _KEY_SENTINEL)
    if int(key.shape[0]) == 0:
        return torch.zeros((), dtype=torch.int64, device=key.device)
    s = torch.sort(key).values
    runs = torch.sum(s[1:] != s[:-1], dtype=torch.int64) + 1
    if present is None:
        return runs
    return runs - (s[-1] == _KEY_SENTINEL).to(torch.int64)


def distinct_pairs_count_final(lanes, akey, mask, use_a: bool, use_c: bool,
                               num_nodes: int):
    """Final hop fused with the distinct count: the last expansion's (base
    key, far position) pairs packed into one int64 key, sorted, and the
    run boundaries counted. Masked-out lanes sort to a sentinel tail.
    ``lanes`` is emptied, so the sort's peak holds the keys alone."""
    row, nbr, _, live = lanes
    lanes.clear()
    present = _lane_mask(live, mask, nbr)
    key = _endpoint_key(akey, row, nbr, use_a, use_c, num_nodes)
    del row, nbr, live
    return _run_count(key, present)


def unique_hop_materialize(lanes, akey, mask, prevs, mask_idx: tuple):
    """``distinct_hop_materialize`` carrying walked-edge scan rows for
    relationship uniqueness: (akey', pos', edge', prevs', present').
    ``mask_idx`` names the carried arrays the new edge must differ from;
    violating lanes come out present'=False (their next-hop degrees are
    zero), the same mechanism as ``varlen_hop``."""
    row, nbr, orig, live = lanes
    prevs_out = tuple(p[row] for p in prevs)
    present = _lane_mask(live, mask, nbr)
    if present is None:
        present = _ones(row.shape[0], row)
    for i in mask_idx:
        present = present & (orig != prevs_out[i])
    return akey[row], nbr, orig, prevs_out, present


def chain_count_final_unique(lanes, mask, prevs, mask_idx: tuple):
    """Final hop of a relationship-unique chain count(*): the last
    expansion's liveness, summed (the SpMV chain carries no edge
    identity, so unique chains count through the walk)."""
    row, nbr, orig, live = lanes
    ok = _lane_mask(live, mask, nbr)
    if ok is None:
        ok = _ones(row.shape[0], row)
    for i in mask_idx:
        ok = ok & (orig != prevs[i][row])
    return torch.sum(ok, dtype=torch.int64)


def distinct_pairs_count_final_unique(lanes, akey, mask, prevs, use_a: bool,
                                      use_c: bool, num_nodes: int, mask_idx: tuple):
    """``distinct_pairs_count_final`` with walked-edge uniqueness masks:
    lanes whose final edge equals a carried chain edge sort to the
    sentinel tail (they are not paths under relationship isomorphism).
    ``lanes`` is emptied, as there."""
    row, nbr, orig, live = lanes
    lanes.clear()
    present = _lane_mask(live, mask, nbr)
    for i in mask_idx:
        ne = orig != prevs[i][row]
        present = ne if present is None else (present & ne)
    key = _endpoint_key(akey, row, nbr, use_a, use_c, num_nodes)
    del row, nbr, orig, live
    return _run_count(key, present)


def into_close_queries(lanes, akey, mask, src_is_base: bool, num_nodes: int,
                       undirected: bool):
    """The final hop of a count(*) cycle chain up to its closing probe: per
    lane the ``src*N + dst`` key of the (base, far) pair in the closing
    relationship's orientation and its validity; an undirected close adds
    the swapped orientation with loops dropped. Returns a list of (probe,
    ok); the caller range-counts each over the sorted edge keys on the
    ``intersect`` gate and sums the totals: the reference's
    ``into_close_count``. ``lanes`` is emptied, so the probes outlive no
    row or nbr."""
    row, nbr, _, live = lanes
    lanes.clear()
    ok = _lane_mask(live, mask, nbr)
    if ok is None:
        ok = _ones(row.shape[0], row)
    a = akey[row]
    del row, live
    out = []
    if undirected:
        s, t = (a, nbr) if src_is_base else (nbr, a)
        out.append((t * num_nodes + s, ok & (s != t)))
        del s, t
    # ``a`` is this function's own gather: the forward probe may reuse it
    probe = a.mul_(num_nodes).add_(nbr) if src_is_base else nbr * num_nodes + a
    return [(probe, ok)] + out


def into_close_unique_queries(lanes, akey, mask, prevs, src_is_base: bool,
                              num_nodes: int, mask_idx: tuple):
    """``into_close_queries`` for a directed close with relationship
    uniqueness: a lane whose final edge equals a carried chain edge named
    by ``mask_idx`` is invalid. Returns (probe, ok, orig, the carried
    edges at the lanes) for ``into_close_count_unique``. ``lanes`` is
    emptied."""
    row, nbr, orig, live = lanes
    lanes.clear()
    ok = _lane_mask(live, mask, nbr)
    if ok is None:
        ok = _ones(row.shape[0], row)
    prevs_r = tuple(p[row] for p in prevs)
    for i in mask_idx:
        ok = ok & (orig != prevs_r[i])
    a = akey[row]
    probe = a * num_nodes + nbr if src_is_base else nbr * num_nodes + a
    return probe, ok, orig, prevs_r


def into_close_count_unique(counts, probe, ok, orig, prevs_r, keys_by_orig,
                            sub_idx: tuple, sub_cur: bool):
    """The close count of a relationship-unique chain from its probe's
    per-lane range counts (``counts``, the ``intersect`` gate's over the
    sorted edge keys): the reference's ``into_close_count_unique`` after
    its searchsorted calls.

    ``sub_cur`` / ``sub_idx``: closing-rel-vs-chain-rel pairs (the final
    hop's own edge, carried edges by index into ``prevs_r``). The probe
    range counts every type-set edge with key (s, t); a chain edge is in
    that range iff its own ``src*N + dst`` key (``keys_by_orig``) equals
    the probe key, so subtracting the key-match indicator removes exactly
    that edge from the closing candidates. Two forbidden rels may bind the
    SAME edge, so each subtraction is gated on differing from every edge
    already subtracted: each distinct forbidden in-range edge subtracts
    once (parallel edges keep distinct scan rows)."""
    cnt = counts
    subbed = []
    if sub_cur:
        cnt = cnt - (keys_by_orig[orig] == probe).to(torch.int64)
        subbed.append(orig)
    for i in sub_idx:
        p = prevs_r[i]
        ind = keys_by_orig[p] == probe
        for e in subbed:
            ind = ind & (p != e)
        cnt = cnt - ind.to(torch.int64)
        subbed.append(p)
    return torch.sum(torch.where(ok, cnt, torch.zeros_like(cnt)))


# ---------------------------------------------------------------------------
# the dense count tier: 2-hop path counts as matrix products
#
# The port of the reference's MXU tier (``jit_ops.py`` ``mxu_close_count``,
# ``mxu_distinct_pairs``, the tiled variants and their finishes). For a
# graph whose dense adjacency fits the card, the counts of a 2-hop chain
# are one chain of products A1 @ A2 with exact small-integer entries
# (multiplicities <= 256, checked at build). These are plain large matrix
# products outside any kernel, as the reference leaves them to XLA, so
# they stay ``torch.mm`` (no hand-written kernel replaces them).
#
# Exactness. On the card a product is ``torch.mm(a, b,
# out_dtype=torch.float32)``: bf16 operands, float32 accumulation and a
# float32 result on the tensor cores, the counterpart of the reference's
# ``preferred_element_type=jnp.float32`` (a plain bf16 ``torch.mm``
# returns bf16 and would round a cell above 256). On the CPU that overload
# does not exist, so the plain version multiplies float32 copies. Both are
# exact under the callers' guard (``rowsum1 * entry2 (* entry_c) <=
# 2**24``): every partial sum of a cell is then an integer below 2**24.
# ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
# (True by default) allows reduced-precision reductions in bf16-OUTPUT
# products only; these ask for float32 output, and the flag is never set
# here (serving threads share it). Each row block's cells are reduced by
# exact casts to integers (float32 -> int32 -> an int64 sum), where the
# reference sums in float64 and rounds: the same value. The row block of
# one product is ``MM_ROWS`` rows, where the reference steps by 256: a few
# large products keep the tensor cores fuller than many thin ones, and a
# block's float32 cells (84 MB at SF1's 10,240 columns) stay small beside
# the matrices. ``chip_smoke.py`` phase 4 times the products against one
# whole ``torch.mm`` and the flop bound.
# ---------------------------------------------------------------------------

MM_ROWS = 2048


def frontier_multiplicity(pos, present, n: int):
    """int64[n] count of frontier rows per compact node (absent rows spill
    into a dropped slot): the dense tier's row-weight vector."""
    slot = torch.where(present, pos, torch.full_like(pos, n))
    with host_sync("expand_mult"):
        return torch.bincount(slot, minlength=n + 1)[:n]


def _mm_operand(b):
    """The right operand as the product takes it: the bf16 matrix on the
    card, a float32 copy (made once per count) on the CPU."""
    return b if b.device.type == "cuda" else b.to(torch.float32)


def _mm_f32(a, b_op):
    """``a @ b`` with a float32 result (see the section note)."""
    if a.device.type == "cuda":
        return torch.mm(a, b_op, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b_op)


def _close_block_count(p2, c_blk, mask_c, mult_blk):
    """sum over the block's rows a of mult[a] * sum_c P2[a, c] * C[a, c]
    (* mask_c[c]): every cell is an integer of at most 2**24."""
    prod = p2 * c_blk.to(torch.float32)
    if mask_c is not None:
        prod = prod * mask_c.to(torch.float32)[None, :]
    rows = torch.sum(prod.to(torch.int32), dim=1, dtype=torch.int64)
    return torch.sum(rows * mult_blk)


def _distinct_block_count(p2, mask_c, pres_blk):
    """Nonzero cells of the block's product, over present rows and
    label-masked columns."""
    hit = p2 > 0.5
    if mask_c is not None:
        hit = hit & (mask_c[None, :] > 0.5)
    return torch.count_nonzero(hit & pres_blk[:, None])


def mxu_close_count(a1, a2, c, mult, mask_b, mask_c, block: int):
    """count(*) of (a)-[r1]->(b)-[r2]->(c'), (a)-[rc]->(c') as
    sum_a mult[a] * sum_c (A1 @ A2)[a, c] * C[a, c]: per row block one
    (block, N) @ (N, N) product and one elementwise product with the
    closing adjacency. ``mult``: frontier multiplicity per source row
    (int64); masks: optional bf16 0/1 vectors folding far-label filters.
    Returns a 0-d int64 tensor on the matrices' device."""
    n = a1.shape[0]
    b_op = _mm_operand(a2)
    acc = torch.zeros((), dtype=torch.int64, device=a1.device)
    for i in range(0, n, block):
        blk = a1[i:i + block]
        if mask_b is not None:
            blk = blk * mask_b[None, :]
        acc += _close_block_count(_mm_f32(blk, b_op), c[i:i + block], mask_c,
                                  mult[i:i + block])
    return acc


def mxu_distinct_pairs(a1, a2, present, mask_b, mask_c, block: int):
    """count(DISTINCT a, c) over a 2-hop chain as the nonzero count of the
    boolean product: per row block (block, N) @ (N, N), then a > 0 test.
    ``present``: bool per source row (frontier membership). Returns a 0-d
    int64 tensor."""
    n = a1.shape[0]
    b_op = _mm_operand(a2)
    acc = torch.zeros((), dtype=torch.int64, device=a1.device)
    for i in range(0, n, block):
        blk = a1[i:i + block]
        if mask_b is not None:
            blk = blk * mask_b[None, :]
        acc += _distinct_block_count(_mm_f32(blk, b_op), mask_c, present[i:i + block])
    return acc


def _mxu_tiled_p2(t1, t2, mask_b):
    """The tiled contraction: yields each row block's (i, P2_i), where
    P2_i = (A1[Bi, :] masked) @ A2 accumulated in float32 from one
    (block, block) @ (block, Npad) product per k; no (Npad, Npad) matrix
    exists."""
    block, npad, nb = t1.block, t1.npad, t1.nblocks
    for i in range(nb):
        a1_i = t1.tile(i)
        if mask_b is not None:
            a1_i = a1_i * mask_b[None, :]
        p2 = torch.zeros((block, npad), dtype=torch.float32, device=a1_i.device)
        for k in range(nb):
            p2 += _mm_f32(a1_i[:, k * block:(k + 1) * block], _mm_operand(t2.tile(k)))
        yield i, p2


def mxu_close_count_tiled(t1, t2, tc, mult, mask_b, mask_c) -> int:
    """Tiled variant of ``mxu_close_count``: the three adjacencies arrive
    as ``DenseTiles`` row-block providers, so the dense tier's node cap
    does not apply. A ``mxu_tile`` fault site per row block."""
    from ...runtime.faults import fault_point

    block = t1.block
    acc = torch.zeros((), dtype=torch.int64, device=mult.device)
    for i, p2 in _mxu_tiled_p2(t1, t2, mask_b):
        fault_point("mxu_tile")
        acc += _close_block_count(p2, tc.tile(i), mask_c, mult[i * block:(i + 1) * block])
    with host_sync("mxu_tile"):
        return int(acc)


def mxu_distinct_pairs_tiled(t1, t2, present, mask_b, mask_c) -> int:
    """Tiled variant of ``mxu_distinct_pairs`` (see above)."""
    from ...runtime.faults import fault_point

    block = t1.block
    acc = torch.zeros((), dtype=torch.int64, device=present.device)
    for i, p2 in _mxu_tiled_p2(t1, t2, mask_b):
        fault_point("mxu_tile")
        acc += _distinct_block_count(p2, mask_c, present[i * block:(i + 1) * block])
    with host_sync("mxu_tile"):
        return int(acc)


# ---------------------------------------------------------------------------
# grouped aggregation: the plain version of the segment_agg kernel
# ---------------------------------------------------------------------------


def _segment_reduce(vals, seg, k: int, op: str, identity):
    """``jax.ops.segment_<op>(vals, seg, num_segments=k)``: an empty
    segment yields ``identity``. Floats reduce min/max through their
    order-preserving int64 keys, so a -0.0 vs 0.0 tie resolves the way the
    JAX reference resolves it (min -> -0.0, max -> 0.0) in any order."""
    if vals.dtype == torch.float64 and op in ("min", "max"):
        keys = f64_order_keys(vals)
        # tpulint: allow[host-sync, sync-span] reason=a CPU scalar: the identity's order key from a host tensor, no device read
        ident = int(f64_order_keys(torch.tensor([float(identity)], dtype=torch.float64))[0])
        out = torch.full((k,), ident, dtype=torch.int64, device=vals.device)
        out = out.scatter_reduce(
            0, seg.to(torch.int64), keys, "amin" if op == "min" else "amax",
            include_self=True,
        )
        return f64_from_order_keys(out)
    out = torch.full((k,), identity, dtype=vals.dtype, device=vals.device)
    if op == "sum":
        return out.index_add_(0, seg.to(torch.int64), vals)
    return out.scatter_reduce(
        0, seg.to(torch.int64), vals, "amin" if op == "min" else "amax",
        include_self=True,
    )


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float64 square root, correctly rounded as the reference's (IEEE)
    ``jnp.sqrt`` is. CUDA's double ``sqrt`` is; torch's CPU kernel is not
    (one ulp off on about 1% of inputs with its AVX-512 path), so a CPU
    tensor takes numpy's."""
    if x.device.type == "cpu":
        # tpulint: allow[host-sync, sync-span] reason=the CPU branch: x lives in host memory, no device read
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def f64_order_keys(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 keys with the same order (-0.0 < 0.0): the bit
    pattern, with all but the sign bit flipped for negative values. The
    ``segment_reduce.cu`` kernel uses the same map."""
    bits = x.view(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)


def f64_from_order_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of ``f64_order_keys``."""
    bits = torch.where(keys < 0, keys ^ 0x7FFFFFFFFFFFFFFF, keys)
    return bits.view(torch.float64)


def segment_aggregate(data, valid, iflag, seg_j, name: str, kind: str, k: int):
    """One aggregator over (value column, group index): null masking, NaN
    orderability and Cypher intness exactly as the reference's
    ``jit_ops.segment_aggregate``. Returns (out_data, out_valid_or_None,
    out_iflag_or_None, iflag_any_or_None). ``seg_j`` None is a global
    aggregate: every row in group 0, as a stride-0 view (no id array)."""
    n = data.shape[0]
    dev = data.device
    if seg_j is None:
        seg_j = torch.zeros((), dtype=torch.int64, device=dev).expand(n)
    v = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    cnt = _segment_reduce(v.to(torch.int64), seg_j, k, "sum", 0)
    if name == "count":
        return cnt, None, None, None
    if name in ("sum", "avg", "stdev", "stdevp"):
        zero = torch.zeros((), dtype=data.dtype, device=dev)
        ssum = _segment_reduce(torch.where(v, data, zero), seg_j, k, "sum", 0)
        if name == "sum":
            if kind == F64:
                # Cypher sum over no values is the INTEGER 0, and the sum
                # of an all-integer group is an INTEGER
                empty = cnt == 0
                if iflag is not None:
                    int_if_valid = torch.where(v, iflag, torch.ones_like(iflag))
                    all_int = (
                        _segment_reduce(
                            int_if_valid.to(torch.int8), seg_j, k, "min",
                            torch.iinfo(torch.int8).max,
                        )
                        == 1
                    )
                    out_iflag = all_int | empty
                else:
                    out_iflag = empty
                return (
                    torch.where(empty, torch.zeros_like(ssum), ssum), None,
                    out_iflag, torch.any(out_iflag),
                )
            return ssum, None, None, None
        if name == "avg":
            avg = ssum.to(torch.float64) / torch.clamp(cnt, min=1)
            return avg, cnt > 0, None, None
        x = data.to(torch.float64)
        mean = ssum.to(torch.float64) / torch.clamp(cnt, min=1)
        diff = torch.where(v, x - mean[seg_j.to(torch.int64)], torch.zeros_like(x))
        ssq = _segment_reduce(diff * diff, seg_j, k, "sum", 0.0)
        denom = torch.clamp(cnt - (1 if name == "stdev" else 0), min=1)
        out = _sqrt_rn(ssq / denom)
        return torch.where(cnt >= 2, out, torch.zeros_like(out)), None, None, None
    # min / max with Cypher orderability: numbers < NaN; nulls skipped
    d = data.to(torch.int8) if kind == BOOL else data
    if kind == F64:
        isnan = torch.isnan(d) & v
        nn_valid = v & ~isnan
        nan_cnt = _segment_reduce(isnan.to(torch.int64), seg_j, k, "sum", 0)
    else:
        nn_valid = v
        nan_cnt = None
    big = float("inf") if kind == F64 else torch.iinfo(d.dtype).max
    lowest = float("-inf") if kind == F64 else torch.iinfo(d.dtype).min
    if name == "min":
        filled = torch.where(nn_valid, d, torch.full_like(d, big))
        agged = _segment_reduce(filled, seg_j, k, "min", big)
        if nan_cnt is not None:
            # all-NaN group: min is NaN (NaN sorts above numbers)
            agged = torch.where(
                (cnt - nan_cnt == 0) & (nan_cnt > 0),
                torch.full_like(agged, float("nan")), agged,
            )
    else:
        low = -big if kind != STR else -1
        filled = torch.where(nn_valid, d, torch.full_like(d, low))
        agged = _segment_reduce(filled, seg_j, k, "max", lowest)
        if nan_cnt is not None:
            # any NaN: NaN is the maximum under Cypher orderability
            agged = torch.where(
                nan_cnt > 0, torch.full_like(agged, float("nan")), agged
            )
    if kind == BOOL:
        agged = agged.to(torch.bool)
    out_iflag = None
    iflag_any = None
    if kind == F64 and iflag is not None and n:
        # Cypher intness of the winning value: the FIRST row (in row
        # order) matching the aggregate carries it
        seg64 = seg_j.to(torch.int64)
        cand = nn_valid & (d == agged[seg64])
        first_row = _segment_reduce(
            torch.where(cand, _arange(n, d), torch.full_like(seg64, n)),
            seg_j, k, "min", torch.iinfo(torch.int64).max,
        )
        safe_row = torch.clamp(first_row, 0, max(n - 1, 0))
        out_iflag = iflag[safe_row] & (first_row < n)
        iflag_any = torch.any(out_iflag)
    return agged, cnt > 0, out_iflag, iflag_any


def segment_duration_agg(data, valid, seg_j, k: int, name: str):
    """sum, avg, min or max of (months, days, micros) rows per group, as
    the oracle aggregates durations: sum and avg component by component
    (avg floors the months, the days, the whole seconds and the
    microseconds left over each on its own, as ``Duration(m // k, d // k,
    s // k, us // k)`` does), min and max by the average-length key, the
    first row in row order winning a tie (Python's ``min``/``max``).
    ``seg_j`` None is one group. Returns ((k, 3) int64, the count of
    non-null rows per group)."""
    n = data.shape[0]
    dev = data.device
    if seg_j is None:
        seg_j = torch.zeros((), dtype=torch.int64, device=dev).expand(n)
    seg = seg_j.to(torch.int64)
    v = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    cnt = _segment_reduce(v.to(torch.int64), seg, k, "sum", 0)
    if name in ("sum", "avg"):
        z = torch.where(v[:, None], data, torch.zeros_like(data))
        m, d, us = (_segment_reduce(c, seg, k, "sum", 0) for c in z.unbind(1))
        if name == "sum":
            return torch.stack([m, d, us], 1), cnt
        c = torch.clamp(cnt, min=1)
        s_n, us_n = torch.div(us, 1_000_000, rounding_mode="floor"), torch.remainder(us, 1_000_000)
        out = torch.stack([
            torch.div(m, c, rounding_mode="floor"), torch.div(d, c, rounding_mode="floor"),
            torch.div(s_n, c, rounding_mode="floor") * 1_000_000
            + torch.div(us_n, c, rounding_mode="floor"),
        ], 1)
        return out, cnt
    key = dur_order_key(data)
    info = torch.iinfo(torch.int64)
    op, fill = ("min", info.max) if name == "min" else ("max", info.min)
    best = _segment_reduce(torch.where(v, key, torch.full_like(key, fill)), seg, k, op, fill)
    hit = v & (key == best[seg])
    first = _segment_reduce(torch.where(hit, _arange(n, key), torch.full_like(key, n)),
                            seg, k, "min", n)
    return data[torch.clamp(first, 0, max(n - 1, 0))] if n else torch.zeros(
        (k, 3), dtype=torch.int64, device=dev), cnt


# ---------------------------------------------------------------------------
# equivalence sort (distinct / group factorization)
# ---------------------------------------------------------------------------


def _equivalence_keys(datas, valids, kinds):
    """Key tensors whose row equality is Cypher equivalence: a null payload
    becomes 0 (outer joins leave arbitrary data under valid=False), NaN is
    its own class (a flag key), -0.0 equals 0.0, bools are int8, and the
    null-class key is left out when the column has no mask. distinct and
    group only: join keys have ``=`` semantics instead (NaN never
    matches)."""
    keys = []
    for d, v, k in zip(datas, valids, kinds):
        if k == DUR:
            # one key per component: row equality is Duration equality
            for c in d.unbind(1):
                keys.append(c if v is None else torch.where(v, c, torch.zeros_like(c)))
            if v is not None:
                keys.append(~v)
            continue
        if k == F64:
            valid = v if v is not None else torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
            nan = torch.isnan(d) & valid
            d = torch.where(valid & ~nan, d, torch.zeros_like(d))
            d = d + 0.0
            keys.append(nan)
        elif k == BOOL:
            d = d.to(torch.int8)
        if v is None:
            keys.append(d)
        else:
            keys.append(torch.where(v, d, torch.zeros((), dtype=d.dtype, device=d.device)))
            keys.append(~v)
    return keys


def _first_flags(keys, order):
    """First-of-run flags over the rows in ``order``."""
    n = order.shape[0]
    diff = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=order.device)
    for k in keys:
        ks = k[order]
        diff = diff | (ks[1:] != ks[:-1])
    return torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=order.device), diff])


def equivalence_minmax(datas, valids, extra_keys, kinds):
    """Per-key (min, max) over the equivalence keys, for the host to decide
    the int packing from one sync. Only called when every key is
    integral."""
    keys = list(extra_keys) + _equivalence_keys(datas, valids, kinds)
    ints = [k.to(torch.int64) for k in keys]
    return (
        torch.stack([k.min() for k in ints]),
        torch.stack([k.max() for k in ints]),
    )


def equivalence_sort(datas, valids, extra_keys, kinds, pack=None):
    """(order, first-of-group flags over sorted order, group count).
    ``pack``: None, or one (lo, bits) per key: all-int keys folded into one
    63-bit key (one stable sort instead of one per key)."""
    keys = list(extra_keys) + _equivalence_keys(datas, valids, kinds)
    if pack is not None:
        keys = [_pack_fold(keys, pack)]
    order = _lexsort(keys)
    flags = _first_flags(keys, order)
    return order, flags, torch.sum(flags, dtype=torch.int64)


def distinct_count_packed(datas, valids, extra_keys, kinds, pack):
    """Distinct-row count over packable all-integer equivalence keys: fold
    into one int64 key, sort the values, count run boundaries."""
    keys = list(extra_keys) + _equivalence_keys(datas, valids, kinds)
    acc = _pack_fold(keys, pack)
    if acc.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=acc.device)
    s = torch.sort(acc).values
    return torch.sum(s[1:] != s[:-1], dtype=torch.int64) + 1


def first_occurrence_rows(order, flags, k: int):
    """Distinct row indices (original order) from a sorted factorization."""
    idx = mask_nonzero(flags, size=k)
    return torch.sort(order[idx]).values


def group_index(order, flags, k: int):
    """(row -> group id in first-occurrence order, first row of each group
    in row order)."""
    n = order.shape[0]
    flag_idx = mask_nonzero(flags, size=k)
    seg_sorted = torch.cumsum(flags.to(torch.int64), 0) - 1
    seg_rows = torch.zeros(n, dtype=torch.int64, device=order.device)
    seg_rows[order] = seg_sorted
    first_rows_keyorder = order[flag_idx]
    rank_order = torch.sort(first_rows_keyorder, stable=True).indices
    rank = torch.zeros(k, dtype=torch.int64, device=order.device)
    rank[rank_order] = _arange(k, order)
    seg_j = rank[seg_rows]
    first_rows = torch.sort(first_rows_keyorder).values
    return seg_j, first_rows


# ---------------------------------------------------------------------------
# ORDER BY permutation
# ---------------------------------------------------------------------------


def order_permutation(datas, valids, kinds, ascs):
    """Stable lexsort permutation under Cypher orderability (numbers < NaN
    < null ascending; DESC reverses all three ranks). Items arrive in ORDER
    BY priority order; within an item the null rank is the primary key,
    then the NaN rank, then the value."""
    keys = []
    for d, v, k, asc in zip(datas, valids, kinds, ascs):
        null = ~v if v is not None else torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
        if k == DUR:
            # equal average lengths keep their row order (the sort is
            # stable), as the oracle's order key does
            d = dur_order_key(d)
        if k == BOOL:
            d = d.to(torch.int8)
        if k == F64:
            nan = torch.isnan(d)
            d = torch.where(nan, torch.zeros_like(d), d)
        else:
            nan = None
        item = [null.to(torch.int8)]
        if nan is not None:
            item.append(nan.to(torch.int8))
        item.append(d)
        keys.extend(item if asc else [-x for x in item])
    return _lexsort(keys)


# ---------------------------------------------------------------------------
# ORDER BY ... LIMIT k as top-k over one packed key
# ---------------------------------------------------------------------------


def order_minmax(datas, valids):
    """(min, max) per key over VALID rows only (invalid payloads are
    arbitrary and must not widen the packing range)."""
    info = torch.iinfo(torch.int64)
    mins, maxs = [], []
    for d, v in zip(datas, valids):
        d = d.to(torch.int64)
        if v is not None:
            mins.append(torch.min(torch.where(v, d, torch.full_like(d, info.max))))
            maxs.append(torch.max(torch.where(v, d, torch.full_like(d, info.min))))
        else:
            mins.append(torch.min(d))
            maxs.append(torch.max(d))
    return torch.stack(mins), torch.stack(maxs)


def order_topk(datas, valids, ascs, pack, k: int):
    """Row indices of the first ``k`` rows under Cypher orderability, as one
    top-k over a packed int64 rank. Keys arrive in ORDER BY priority order;
    each contributes (1 null bit | data bits) with DESC keys reversed, so
    lexicographic order is integer order. The original row index in the
    lowest bits makes every key unique, so the k smallest are the rows a
    stable sort puts first. All-integer keys only (the caller budgets the
    bits)."""
    acc = torch.zeros(datas[0].shape[0], dtype=torch.int64, device=datas[0].device)
    for d, v, asc, (lo, span, bits) in zip(datas, valids, ascs, pack):
        val = d.to(torch.int64) - lo
        if v is not None:
            val = torch.where(v, val, torch.zeros_like(val))
            null_rank = (~v).to(torch.int64)  # nulls last ascending
        else:
            null_rank = torch.zeros_like(val)
        if not asc:
            val = span - val
            null_rank = 1 - null_rank  # nulls first descending
        acc = (acc << 1) | null_rank
        acc = (acc << bits) | val
    n = acc.shape[0]
    rowbits = max(n - 1, 0).bit_length()
    acc = (acc << rowbits) | _arange(n, acc)
    return torch.topk(acc, k, largest=False, sorted=True).indices


# ---------------------------------------------------------------------------
# percentiles
# ---------------------------------------------------------------------------


def segment_percentile(data, valid, seg_j, p: float, name: str, k: int):
    """percentileCont/Disc: one segment-sorted gather. Returns (out_data,
    out_valid, order, positions); the caller maps the gathered rows back
    for the disc variant's int_flag."""
    n = data.shape[0]
    dev = data.device
    v = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    cnt = _segment_reduce(v.to(torch.int64), seg_j, k, "sum", 0)
    # an explicit invalid flag as the secondary key: a value sentinel could
    # tie with real data and let a null row's payload be gathered
    order = _lexsort([seg_j, ~v, data])
    sorted_val = data[order]
    sizes = _segment_reduce(torch.ones(n, dtype=torch.int64, device=dev), seg_j, k, "sum", 0)
    starts = _exclusive_cumsum(sizes)
    safe_cnt = torch.clamp(cnt, min=1)
    last = max(n - 1, 0)
    if name == "percentiledisc":
        if p > 0:
            idx = torch.ceil(p * safe_cnt.to(torch.float64)).to(torch.int64) - 1
        else:
            idx = torch.zeros_like(safe_cnt)
        idx = torch.minimum(torch.clamp(idx, min=0), safe_cnt - 1)
        pos = torch.clamp(starts + idx, 0, last)
        out = sorted_val[pos] if n else torch.zeros(k, dtype=data.dtype, device=dev)
        return out, cnt > 0, order, pos
    fidx = p * (safe_cnt.to(torch.float64) - 1)
    lo = torch.floor(fidx).to(torch.int64)
    hi = torch.ceil(fidx).to(torch.int64)
    frac = fidx - lo.to(torch.float64)
    pos_lo = torch.clamp(starts + lo, 0, last)
    pos_hi = torch.clamp(starts + hi, 0, last)
    if n:
        vlo = sorted_val[pos_lo].to(torch.float64)
        vhi = sorted_val[pos_hi].to(torch.float64)
        out = vlo * (1 - frac) + vhi * frac
    else:
        out = torch.zeros(k, dtype=torch.float64, device=dev)
    return out, cnt > 0, order, pos_lo
