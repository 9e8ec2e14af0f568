"""Cypher equality and orderability over device columns of every kind.

Two functions carry list, map, path and mixed values (``LST``, ``STRUCT``,
``MIX``; ``column.py``) wherever the scalar kinds compare on their
payloads:

* ``rank``: an exact dense int64 rank per row in Cypher's orderability
  (the local oracle's ``order_key``): values of different kinds order by
  their class (map, node, relationship, list, string, boolean, number,
  temporal, duration), numbers across INTEGER and FLOAT exactly, lists
  element by element with a shorter prefix first and a null element after
  every value, maps by their (key, value) pairs in key order. Two rows
  share a rank iff the oracle's equivalence (``cypher_equivalent``) holds,
  so the rank is the key that grouping, DISTINCT, ORDER BY and joins use
  in the value's place. Each row's key is a few int64 lanes (class and
  payload); a list's payload is the rank of its element sequence, found by
  prefix doubling over its elements (``_seq_rank``), read on the
  ``expand_rows`` gate (``lists.segment_lanes``) level by level.
* ``equal``: three-valued ``=`` as the oracle's ``cypher_equals``: values
  of different kinds are unequal, lists of different lengths too, an
  element comparison that decides nothing makes the list's result null,
  ``1 = 1.0`` is true and ``NaN`` equals nothing.

A path as a key has no device rank: the oracle orders paths by their
text, so it raises ``TpuUnsupportedExpr`` naming ROADMAP.md §3.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from .column import (
    BOOL,
    DUR,
    F64,
    I64,
    LST,
    MAP,
    MIX,
    NODE,
    OBJ,
    PATH,
    PROPS,
    REL,
    STR,
    STRUCT,
    TEMPORAL_KINDS,
    Column,
    _unify_vocab,
    mix_parts,
    sparse_names,
)

# the oracle's class order (api/values.py ``_TYPE_ORDER``)
_MAP_CLASS, _NODE_CLASS, _REL_CLASS, _LIST_CLASS = 0, 1, 2, 3
_STR_CLASS, _BOOL_CLASS, _NUM_CLASS, _TIME_CLASS, _DUR_CLASS = 5, 6, 7, 8, 9
_LANES = 4  # class and three payload lanes
# the oracle's average month and day (``duration_order_us``)
_DUR_MONTH_US, _DUR_DAY_US = 2_629_800_000_000, 86_400_000_000
_F64_TOP = 2.0**63 - 1024.0  # the largest float64 below 2**63


def _unsupported(what: str):
    from .compiler import TpuUnsupportedExpr

    return TpuUnsupportedExpr(what)


def _ordered_f64_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys of float64 values in numeric order, -0.0 equal to 0.0 and
    every NaN one key above +inf."""
    d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d + 0.0)
    b = d.view(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)


def _number_lanes(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two int64 lanes that order and equate numbers across INTEGER and
    FLOAT exactly: the float64 nearest the value (below 2**63), and what
    the integer lies above it."""
    if col.kind == F64:
        return _ordered_f64_key(col.data), torch.zeros_like(col.data, dtype=torch.int64)
    x = col.data
    f0 = torch.clamp(x.to(torch.float64), max=_F64_TOP)
    return _ordered_f64_key(f0), x - f0.to(torch.int64)


def _lanes(col: Column) -> torch.Tensor:
    """(n, _LANES) int64 keys whose lexicographic order is the rows'
    Cypher order and whose equality is their equivalence (null rows are
    the caller's: their lanes are arbitrary)."""
    n = len(col)
    dev = col.data.device
    out = torch.zeros((n, _LANES), dtype=torch.int64, device=dev)
    kind = col.kind
    if kind == MIX:
        tags, rows = mix_parts(col)
        maps = [j for j, p in enumerate(col.parts) if p.kind == STRUCT and p.tag in (MAP, PROPS)]
        map_ranks = dict(zip(maps, _maps_rank([col.parts[j] for j in maps]))) if maps else {}
        kinds = [p.kind for p in col.parts]
        if sum(k in TEMPORAL_KINDS for k in kinds) > 1:
            raise _unsupported("a key of temporal values of mixed kinds (ROADMAP.md §3)")
        valid = col.valid_mask()  # a null row's (part, row) points anywhere
        for j, part in enumerate(col.parts):
            with host_sync("expr"):
                # tpulint: allow[pad-invariant] reason=exact compaction of one value kind's rows for the order keys: value columns carry no pad lanes
                sel = torch.nonzero(valid & (tags == j)).squeeze(1)
            if j in map_ranks:
                lanes = torch.zeros((len(part), _LANES), dtype=torch.int64, device=dev)
                lanes[:, 0] = _MAP_CLASS
                lanes[:, 1] = map_ranks[j]
            else:
                lanes = _lanes(part)
            out[sel] = lanes[rows[sel]]
        return out
    if kind in (I64, F64):
        out[:, 0] = _NUM_CLASS
        out[:, 1], out[:, 2] = _number_lanes(col)
    elif kind == BOOL:
        out[:, 0] = _BOOL_CLASS
        out[:, 1] = col.data.to(torch.int64)
    elif kind == STR:
        out[:, 0] = _STR_CLASS
        out[:, 1] = col.data.to(torch.int64)
    elif kind in TEMPORAL_KINDS:
        out[:, 0] = _TIME_CLASS
        out[:, 1] = col.data.to(torch.int64)
    elif kind == DUR:
        m, d, u = col.data.unbind(1)
        out[:, 0] = _DUR_CLASS
        out[:, 1] = m * _DUR_MONTH_US + d * _DUR_DAY_US + u
        out[:, 2], out[:, 3] = m, d
    elif kind == LST:
        out[:, 0] = _LIST_CLASS
        out[:, 1] = _list_rank(col)
    elif kind == STRUCT and col.tag in (NODE, REL):
        out[:, 0] = _NODE_CLASS if col.tag == NODE else _REL_CLASS
        out[:, 1] = col.field("id").data
    elif kind == STRUCT and col.tag in (MAP, PROPS):
        out[:, 0] = _MAP_CLASS
        out[:, 1] = _maps_rank([col])[0]
    elif kind == STRUCT and col.tag == PATH:
        raise _unsupported("a path as a key: the oracle orders paths by their text "
                           "(ROADMAP.md §3)")
    else:
        raise _unsupported(f"a key of {kind} values")
    return out


def rank(col: Column) -> Column:
    """The exact dense rank of every row in Cypher order, equal iff the
    values are equivalent; null rows keep their nullness (rank 0)."""
    if col.kind == OBJ:
        raise _unsupported("a key of object values")
    n = len(col)
    dev = col.data.device
    if n == 0:
        return Column(I64, torch.zeros(0, dtype=torch.int64, device=dev), col.valid)
    valid = col.valid_mask()
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    with host_sync("expr"):
        # tpulint: allow[pad-invariant] reason=exact compaction of the valid rows to rank: value columns carry no pad lanes
        rows = torch.nonzero(valid).squeeze(1)
    if int(rows.shape[0]):
        lanes = _lanes(col)[rows]
        with host_sync("expr"):
            _, inv = torch.unique(lanes, dim=0, return_inverse=True)
        out[rows] = inv
    return Column(I64, out, col.valid)


def joint_rank(cols: List[Column]) -> List[Column]:
    """``rank`` taken over the rows of several columns together, so that
    the ranks compare across them (the two sides of a join)."""
    both = cols[0]
    for c in cols[1:]:
        both = both.concat(c)
    r = rank(both)
    out, lo = [], 0
    for c in cols:
        out.append(r.slice(lo, lo + len(c)))
        lo += len(c)
    return out


def _seq_rank(lens: torch.Tensor, parent: torch.Tensor, er: torch.Tensor) -> torch.Tensor:
    """The dense rank of each of ``len(lens)`` sequences laid end to end
    (sequence ``parent[l]`` holds lane ``l``), in lexicographic order of
    their element ranks ``er`` (>= 1), a shorter prefix first: by prefix
    doubling, the rank of the run of ``2 * step`` elements from a lane (cut
    at its sequence's end, which ranks below every element) is the rank of
    the pair (its run of ``step``, the run of ``step`` after it).
    ceil(log2 of the longest sequence) rounds of one sort each."""
    m = int(lens.shape[0])
    dev = lens.device
    fault_point("expr")  # the longest sequence read below
    with host_sync("expr"):
        width = int(lens.max()) if m else 0
    if width == 0:
        return torch.zeros(m, dtype=torch.int64, device=dev)
    first = torch.cumsum(lens, 0) - lens
    total = int(er.shape[0])
    r = er
    lane = torch.arange(total, dtype=torch.int64, device=dev)
    left = lens[parent] - (lane - first[parent])  # elements from here to the end
    step = 1
    while step < width:
        after = torch.where(left > step, r[torch.clamp(lane + step, max=total - 1)], 0)
        with host_sync("expr"):
            _, r = torch.unique(r * (total + 1) + after, return_inverse=True)
        r = r + 1
        step *= 2
    head = torch.where(lens > 0, r[torch.clamp(first, max=total - 1)], 0)
    with host_sync("expr"):
        _, dense = torch.unique(head, return_inverse=True)
    return dense.to(torch.int64)


def _element_ranks(col: Column) -> torch.Tensor:
    """Per row of ``col`` a rank >= 1 for a sequence's element: its value's
    rank, a null after every value."""
    r = rank(col)
    valid = col.valid_mask()
    top = int(r.data.max()) + 1 if len(col) else 0
    return torch.where(valid, r.data + 1, top + 1)


def _list_rank(col: Column) -> torch.Tensor:
    """Every list's rank (null lists: 0); rows that share a (start, length)
    pair are ranked once, the distinct lists' elements read on the
    ``expand_rows`` gate."""
    from .lists import segment_lanes

    n = len(col)
    dev = col.data.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    data = torch.where(col.valid_mask()[:, None], col.data, torch.zeros_like(col.data))
    with host_sync("expr"):
        pairs, inv = torch.unique(data, dim=0, return_inverse=True)
    lens = pairs[:, 1]
    parent, pos = segment_lanes(pairs[:, 0], torch.arange(len(pairs), device=dev), lens,
                                len(col.child))
    if int(parent.shape[0]) == 0:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    er = _element_ranks(col.child.take(pos))
    return _seq_rank(lens, parent, er)[inv]


def _present(s: Column, name: str) -> torch.Tensor:
    """Whether each row of the map ``s`` has the key ``name``: a ``map``
    has every key it was built with, null or not; ``properties`` only its
    non-null ones (``column.sparse_names``)."""
    f = s.field(name)
    n = len(s)
    if f is None:
        return torch.zeros(n, dtype=torch.bool, device=s.data.device)
    if name in sparse_names(s):
        return f.valid_mask()
    return torch.ones(n, dtype=torch.bool, device=s.data.device)


def _maps_rank(parts: List[Column]) -> List[torch.Tensor]:
    """Ranks of the rows of several map columns together, in the oracle's
    map order: the sequence of (key, value) pairs in key order, compared
    pair by pair (a key first, then its value, a null value after every
    other), a shorter sequence first."""
    names = sorted({k for p in parts for k in list(p._fields)})
    dev = parts[0].data.device
    sizes = [len(p) for p in parts]
    m = sum(sizes)
    if not names or m == 0:
        return [torch.zeros(s, dtype=torch.int64, device=dev) for s in sizes]
    present, values = [], []
    for k in names:
        cols = [p.field(k) if p.field(k) is not None else Column.from_values([None]).null_like(len(p))
                for p in parts]
        both = cols[0]
        for c in cols[1:]:
            both = both.concat(c)
        values.append(_element_ranks(both))
        present.append(torch.cat([_present(p, k) for p in parts]))
    pres = torch.stack(present, 1)  # (m, keys)
    vals = torch.stack(values, 1)
    with host_sync("expr"):
        # tpulint: allow[pad-invariant] reason=the (row, key) pairs of present map keys are the values ranked: an exact compaction
        row, key = torch.nonzero(pres, as_tuple=True)  # row-major: key order per row
    with host_sync("expr"):
        _, er = torch.unique(torch.stack([key, vals[row, key]], 1), dim=0, return_inverse=True)
    r = _seq_rank(pres.sum(1), row, er + 1)
    out, lo = [], 0
    for s in sizes:
        out.append(r[lo:lo + s])
        lo += s
    return out


# -- three-valued equality ------------------------------------------------------


def _bool(data, valid) -> Column:
    return Column(BOOL, data, valid)


def _scalar_equal(l: Column, r: Column) -> Column:
    """``=`` of two scalar columns: numbers across INTEGER and FLOAT
    exactly, strings on one vocab, durations by their components; any
    other pair of kinds is false."""
    valid = l.valid_mask() & r.valid_mask()
    n = len(l)
    dev = valid.device
    if {l.kind, r.kind} <= {I64, F64}:
        la, lb = _number_lanes(l)
        ra, rb = _number_lanes(r)
        eq = (la == ra) & (lb == rb)
        for c in (l, r):
            if c.kind == F64:
                eq = eq & ~torch.isnan(c.data)
        return _bool(eq, valid)
    if l.kind != r.kind:
        return _bool(torch.zeros(n, dtype=torch.bool, device=dev), valid)
    if l.kind == STR:
        l, r = _unify_vocab(l, r)
    if l.kind == DUR:
        return _bool(torch.all(l.data == r.data, dim=1), valid)
    return _bool(l.data == r.data, valid)


def equal(l: Column, r: Column) -> Column:
    """Three-valued ``=`` of two columns of one length, of any kinds, as
    the oracle's ``cypher_equals``."""
    n = len(l)
    dev = l.data.device
    if OBJ in (l.kind, r.kind):
        raise _unsupported("equality on object values")
    valid = l.valid_mask() & r.valid_mask()
    falses = torch.zeros(n, dtype=torch.bool, device=dev)
    if MIX in (l.kind, r.kind):
        from .column import as_mix

        L, R = as_mix(l), as_mix(r)
        (lt, lr), (rt, rr) = mix_parts(L), mix_parts(R)
        data, known = falses.clone(), falses.clone()
        for i, p in enumerate(L.parts):
            for j, q in enumerate(R.parts):
                with host_sync("expr"):
                    # tpulint: allow[pad-invariant] reason=exact compaction of one kind pair's rows for equality: value columns carry no pad lanes
                    sel = torch.nonzero(valid & (lt == i) & (rt == j)).squeeze(1)
                if int(sel.shape[0]) == 0:
                    continue
                e = equal(p.take(lr[sel]), q.take(rr[sel]))
                data[sel] = e.data & e.valid_mask()
                known[sel] = e.valid_mask()
        return _bool(data, known)
    lel = l.kind == STRUCT and l.tag in (NODE, REL, PATH)
    rel = r.kind == STRUCT and r.tag in (NODE, REL, PATH)
    if lel or rel:
        if not (lel and rel) or l.tag != r.tag:
            return _bool(falses, valid)
        if l.tag == PATH:
            nodes = equal(l.field("nodes"), r.field("nodes"))
            rels = equal(l.field("relationships"), r.field("relationships"))
            return _bool(nodes.data & rels.data, valid)
        return _bool(l.field("id").data == r.field("id").data, valid)
    if l.kind == LST or r.kind == LST:
        if l.kind != r.kind:
            return _bool(falses, valid)
        return _list_equal(l, r, valid)
    if l.kind == STRUCT or r.kind == STRUCT:
        if l.kind != r.kind:
            return _bool(falses, valid)
        return _map_equal(l, r, valid)
    return _scalar_equal(l, r)


def _list_equal(l: Column, r: Column, valid) -> Column:
    """Lists: a different length is false; else element by element, false
    if any element is unequal, else null if any is unknown, else true."""
    from .lists import segment_lanes, segment_sum

    la, lb = l.lengths(), r.lengths()
    same = valid & (la == lb)
    data = same.clone()
    known = valid.clone()
    with host_sync("expr"):
        # tpulint: allow[pad-invariant] reason=exact compaction of the non-empty equal-length list rows compared element by element
        rows = torch.nonzero(same & (la > 0)).squeeze(1)
    if int(rows.shape[0]):
        parent, pos_l = segment_lanes(l.starts(), rows, la[rows], len(l.child))
        pos_r = r.starts()[rows][parent] + (pos_l - l.starts()[rows][parent])
        e = equal(l.child.take(pos_l), r.child.take(pos_r))
        ek = e.valid_mask()
        m = int(rows.shape[0])
        unequal = segment_sum(ek & ~e.data, parent, m) > 0
        unknown = segment_sum(~ek, parent, m) > 0
        data[rows] = ~unequal & ~unknown
        known[rows] = unequal | ~unknown
    return _bool(data & known, known)


def _map_equal(l: Column, r: Column, valid) -> Column:
    """Maps: different key sets are unequal; else the values key by key,
    three-valued as lists are."""
    names = sorted(set(l._fields) | set(r._fields))
    n = len(l)
    dev = valid.device
    unequal = torch.zeros(n, dtype=torch.bool, device=dev)
    unknown = torch.zeros(n, dtype=torch.bool, device=dev)
    fault_point("expr")  # the per-key presence reads below
    for k in names:
        pl, pr = _present(l, k), _present(r, k)
        unequal |= pl != pr
        both = pl & pr
        any_both = torch.any(both & valid)
        with host_sync("expr"):
            skip = not bool(any_both)
        if skip:
            continue
        e = equal(l.field(k), r.field(k))
        ek = e.valid_mask()
        unequal |= both & ek & ~e.data
        unknown |= both & ~ek
    known = valid & (unequal | ~unknown)
    return _bool(valid & ~unequal & ~unknown, known)
