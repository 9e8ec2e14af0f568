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

import torch

I64 = "i64"
F64 = "f64"
BOOL = "bool"
STR = "str"


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
    idx = torch.nonzero(mask, as_tuple=True)[0]
    m = int(idx.shape[0])
    if m >= size:
        return idx[:size]
    return torch.cat([idx, torch.zeros(size - m, dtype=idx.dtype, device=idx.device)])


def mask_to_idx(mask) -> Tuple[Any, int]:
    """Boolean device mask -> (index tensor, count); one scalar sync."""
    from ...runtime.faults import fault_point

    fault_point("compact")
    idx = torch.nonzero(mask, as_tuple=True)[0]
    return idx, int(idx.shape[0])


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


def expand_degrees_total(rp, pos, present):
    """Per-frontier-row degree (0 for absent rows) and its device total.
    ``pos`` comes from ``compact_lookup``, clipped to [0, num_nodes-1], so
    ``pos + 1`` stays inside ``rp``."""
    deg = (rp[pos + 1] - rp[pos]).to(torch.int64)
    deg = torch.where(present, deg, torch.zeros_like(deg))
    return deg, torch.sum(deg)


def finish_expand_counted(ci, eo, row, edge, nvalid, size: int):
    """Tail shared by every counted expand-materialize formulation (the
    repeat cascade AND the Hopper row-search kernel): sanitize pad lanes
    to row/edge 0, gather neighbour/edge-orig, mask the gathers dead. ONE
    definition so the two formulations cannot drift."""
    live = _live_lanes(size, nvalid, row)
    zero = torch.zeros((), dtype=torch.int64, device=row.device)
    row = torch.where(live, row, zero)
    edge = torch.where(live, edge, zero)
    nbr = ci[edge].to(torch.int64)
    orig = eo[edge]
    nbr = torch.where(live, nbr, zero)
    orig = torch.where(live, orig, zero)
    return row, nbr, orig, live


def expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, size: int):
    """The plain PyTorch version of the ``expand_rows`` kernel: the
    reference's repeat cascade at a (possibly bucketed) static ``size`` >=
    the true total ``nvalid``; pad lanes come out sanitized and dead."""
    row, edge = _expand_rows(rp[pos], deg, size)
    return finish_expand_counted(ci, eo, row, edge, nvalid, size)


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
    out_iflag_or_None, iflag_any_or_None)."""
    n = data.shape[0]
    dev = data.device
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
        out = torch.sqrt(ssq / denom)
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
