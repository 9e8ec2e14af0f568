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

from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from .column import (
    LST,
    MIX,
    OBJ,
    STRUCT,
    Column,
    concat_children,
)

# what lists still lack on the device: pattern comprehensions
NESTED_ITEM = "ROADMAP.md queue 1, item 6.5"
_INT32_MAX = 2**31 - 1


def _unsupported(what: str):
    from .compiler import TpuUnsupportedExpr

    return TpuUnsupportedExpr(what)


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

    fault_point("expr")  # the lane total read below
    with host_sync("expr"):
        total = int(deg.sum()) if int(deg.shape[0]) else 0
    dev = deg.device
    if total == 0:  # before the gate: it takes no empty frontier
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    itype = torch.int32 if nchild <= _INT32_MAX else torch.int64
    ci = torch.arange(nchild, dtype=itype, device=dev)
    # tpulint: allow[pad-invariant] reason=the explode's lanes are the list elements themselves, one output row each: sized exactly
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
    keep = col.valid_mask()
    with host_sync("expr"):
        # tpulint: allow[pad-invariant] reason=collect keeps the valid rows as list elements: the answer's values, compacted exactly
        rows = torch.nonzero(keep).squeeze(1)
    g = seg[rows]
    order = torch.sort(g, stable=True).indices
    with host_sync("expr"):
        return list_column(torch.bincount(g, minlength=k), col.take(rows[order]))


def list_rank(col: Column) -> Column:
    """An exact dense rank per list in Cypher's list order (element by
    element, a shorter prefix first, a null element after every value):
    lists are equal iff their ranks are. Null lists keep their nullness
    (``values.rank``)."""
    from .values import rank

    return rank(col)


def key_column(col: Column) -> Column:
    """The scalar column that stands in for ``col`` as a grouping, DISTINCT
    or ORDER BY key: a list's, map's, element's or mixed value's dense
    rank in Cypher order (``values.rank``); a scalar column is its own
    key."""
    if col.kind in (LST, STRUCT, MIX):
        from .values import rank

        return rank(col)
    return col


def concat_rows(a: Column, b: Column, valid: Optional[torch.Tensor]) -> Column:
    """Per-row list concatenation ``a[i] ++ b[i]`` (rows where ``valid`` is
    False are null): each side's lanes placed at their row's offset in the
    result, ``a``'s first."""
    la, lb = a.lengths(), b.lengths()
    if valid is not None:
        zero = torch.zeros_like(la)
        la, lb = torch.where(valid, la, zero), torch.where(valid, lb, zero)
    child = concat_children(a.child, b.child)
    if child.kind == OBJ:
        raise _unsupported("concatenation of lists of temporal values of mixed kinds "
                           "(ROADMAP.md §3)")
    n = len(a)
    dev = la.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    out_lens = la + lb
    out_start = torch.cumsum(out_lens, 0) - out_lens
    fault_point("expr")  # the element total read below
    size = 0
    if n:
        total = out_lens.sum()
        with host_sync("expr"):
            size = int(total)
    pos = torch.empty(size, dtype=torch.int64, device=dev)
    for lens, side, shift, lead in ((la, a, 0, None), (lb, b, len(a.child), la)):
        r, p = segment_lanes(side.starts(), rows, lens, len(side.child))
        j = torch.arange(int(r.shape[0]), dtype=torch.int64, device=dev) - (
            torch.cumsum(lens, 0) - lens)[r]
        dst = out_start[r] + j + (lead[r] if lead is not None else 0)
        pos[dst] = p + shift
    return list_column(out_lens, child.take(pos), valid)
