"""List columns on the device: the segment work behind ``LST`` values.

An ``LST`` column (``column.py``) holds a (start, length) pair per row
over one child column: a CSR layout whose rows may share child ranges.
Reading the elements of a set of lists — an UNWIND, a comprehension's
element rows, the compaction before decode — is a CSR expand
materialize, so every such read runs on the ``expand_rows`` kernel gate
(``segment_lanes``): the starts are the row pointers, the lengths the
degrees, the child positions the neighbours. The rest are torch ops:
per-list sums by ``index_add_``, ``collect`` by a stable sort of the
group ids and a count per group, and the exact dense ranks that let
``group``, ``distinct`` and ``order_by`` treat a list as one integer key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .column import (
    BOOL,
    F64,
    I64,
    LST,
    NODE,
    REL,
    SCALAR_KINDS,
    STR,
    STRUCT,
    TEMPORAL_KINDS,
    Column,
    concat_children,
)

# what lists and maps still lack on the device
NESTED_ITEM = "ROADMAP.md queue 1, item 6.4"
_INT32_MAX = 2**31 - 1


def _unsupported(what: str):
    from .compiler import TpuUnsupportedExpr

    return TpuUnsupportedExpr(f"{what}: {NESTED_ITEM}")


def list_column(lens: torch.Tensor, child: Column, valid=None, starts=None) -> Column:
    """An LST column of per-row lengths over ``child``; without ``starts``
    the lists lie one after another from child position 0."""
    lens = lens.to(torch.int64)
    if starts is None:
        starts = torch.cumsum(lens, 0) - lens
    return Column(LST, torch.stack([starts.to(torch.int64), lens], 1), valid, child=child)


def segment_lanes(rp, pos, deg, nchild: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every element of the segments ``rp[pos[i]] .. rp[pos[i]] + deg[i]``,
    row by row and in order: (index into ``pos``, child position) per lane.
    One CSR expand materialize through the ``expand_rows`` gate, with the
    child positions as the column index; none for an empty result."""
    from .hopper import expand_materialize_counted

    total = int(deg.sum()) if int(deg.shape[0]) else 0
    dev = deg.device
    if total == 0:  # before the gate: it takes no empty frontier
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    itype = torch.int32 if nchild <= _INT32_MAX else torch.int64
    ci = torch.arange(nchild, dtype=itype, device=dev)
    row, nbr, _, _ = expand_materialize_counted(
        rp.to(itype), ci, None, pos, deg.to(torch.int64), total,
        size=total, with_orig=False,
    )
    return row, nbr


def elements(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owning row, child position) of every element of every list, row by
    row and in list order, on the ``expand_rows`` gate."""
    rows = torch.arange(len(col), dtype=torch.int64, device=col.data.device)
    return segment_lanes(col.starts(), rows, col.lengths(), len(col.child))


def compact(col: Column) -> Column:
    """The same lists with a child of exactly their elements, in row
    order (a decode reads no element the rows do not hold)."""
    _, pos = elements(col)
    return list_column(col.lengths(), col.child.take(pos), col.valid)


def segment_sum(x: torch.Tensor, parent: torch.Tensor, n: int) -> torch.Tensor:
    """Per-list int64 sums of a per-element tensor."""
    out = torch.zeros(n, dtype=torch.int64, device=parent.device)
    return out.index_add_(0, parent, x.to(torch.int64))


def singleton_lists(col: Column) -> Column:
    """Each row's value as a one-element list."""
    return list_column(torch.ones(len(col), dtype=torch.int64, device=col.data.device), col)


def collect(seg, col: Column, k: int) -> Column:
    """collect per group on the device: nulls dropped, each group's values
    in row order (a stable sort of the group ids), the lengths from a count
    per group."""
    if col.kind == LST:
        raise _unsupported("collect of lists")
    keep = col.valid_mask()
    rows = torch.nonzero(keep).squeeze(1)
    g = seg[rows]
    order = torch.sort(g, stable=True).indices
    return list_column(torch.bincount(g, minlength=k), col.take(rows[order]))


def _ordered_f64_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys of float64 values in numeric order, -0.0 equal to 0.0 and
    every NaN one key above +inf."""
    d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d + 0.0)
    b = d.view(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)


def element_key(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 key in Cypher order, validity) per row of a scalar or element
    column: elements by id, strings by their sorted-vocab code, temporal
    values by their payload (zoned ones by the UTC lane)."""
    if col.kind == STRUCT and col.tag in (NODE, REL):
        return col.field("id").data, col.valid_mask()
    if col.kind in (I64, BOOL, STR) + TEMPORAL_KINDS:
        return col.data.to(torch.int64), col.valid_mask()
    if col.kind == F64:
        return _ordered_f64_key(col.data), col.valid_mask()
    if col.kind == STRUCT:
        raise _unsupported("a map as a key")
    raise _unsupported(f"a list of {col.kind} as a key")


def list_rank(col: Column) -> Column:
    """An exact dense rank per list, in Cypher's list order (element by
    element, a shorter prefix first, a null element after every value):
    lists are equal iff their ranks are. Null lists keep their nullness.
    Rows that share a (start, length) pair are ranked once, and no list is
    padded: by prefix doubling over the distinct lists' elements, the rank
    of the run of ``2 * step`` elements that starts at an element (cut at
    its list's end, which ranks below every value) is the rank of the pair
    (its run of ``step``, the run of ``step`` after it). ceil(log2 of the
    longest list) rounds of a sort over the elements rank each list by its
    first element's run."""
    n = len(col)
    dev = col.data.device
    pairs, inv = torch.unique(col.data, dim=0, return_inverse=True)
    lens = pairs[:, 1]
    width = int(lens.max()) if n else 0
    if width == 0:
        return Column(I64, torch.zeros(n, dtype=torch.int64, device=dev), col.valid)
    first = torch.cumsum(lens, 0) - lens  # each distinct list's first lane
    parent, pos = segment_lanes(pairs[:, 0], torch.arange(len(pairs), device=dev), lens,
                                len(col.child))
    key, kvalid = element_key(col.child.take(pos))
    cls = torch.where(kvalid, 1, 2)  # a value, or a null element
    _, r = torch.unique(torch.stack([cls, torch.where(kvalid, key, 0)], 1), dim=0,
                        return_inverse=True)
    r = r + 1  # 0: past the list's end
    total = int(r.shape[0])
    lane = torch.arange(total, dtype=torch.int64, device=dev)
    left = lens[parent] - (lane - first[parent])  # elements from here to the end
    step = 1
    while step < width:
        after = torch.where(left > step, r[torch.clamp(lane + step, max=total - 1)], 0)
        _, r = torch.unique(r * (total + 1) + after, return_inverse=True)
        r = r + 1
        step *= 2
    head = torch.where(lens > 0, r[torch.clamp(first, max=total - 1)], 0)
    _, dense = torch.unique(head, return_inverse=True)
    return Column(I64, dense[inv].to(torch.int64), col.valid)


def key_column(col: Column) -> Column:
    """The scalar column that stands in for ``col`` as a grouping, DISTINCT
    or ORDER BY key: an element's id, a list's dense rank; a map raises."""
    if col.kind == LST:
        return list_rank(col)
    if col.kind == STRUCT:
        return Column(I64, element_key(col)[0], col.valid)
    return col


def concat_rows(a: Column, b: Column, valid: Optional[torch.Tensor]) -> Column:
    """Per-row list concatenation ``a[i] ++ b[i]`` (rows where ``valid`` is
    False are null): the lanes of both sides, stably sorted by their row."""
    la, lb = a.lengths(), b.lengths()
    if valid is not None:
        zero = torch.zeros_like(la)
        la, lb = torch.where(valid, la, zero), torch.where(valid, lb, zero)
    child = concat_children(a.child, b.child)
    if child.kind not in SCALAR_KINDS and child.kind != STRUCT:
        raise _unsupported("concatenation of lists of mixed kinds")
    rows = torch.arange(len(a), dtype=torch.int64, device=la.device)
    ra, pa = segment_lanes(a.starts(), rows, la, len(a.child))
    rb, pb = segment_lanes(b.starts(), rows, lb, len(b.child))
    order = torch.sort(torch.cat([ra, rb]), stable=True).indices
    pos = torch.cat([pa, pb + len(a.child)])[order]
    return list_column(la + lb, child.take(pos), valid)
