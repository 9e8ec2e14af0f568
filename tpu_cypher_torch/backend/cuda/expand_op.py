"""Fused CSR expand operators: the CUDA backend's physical Expand.

The port of the slices' part of ``tpu_cypher/backend/tpu/expand_op.py``:
``_FusedExpandBase`` (``_with_pair``, the materializing path's
uniqueness masks, the outer-join gathers), ``CsrExpandOp`` (its
materialize half, its count chain and its DISTINCT-endpoints count),
``CsrExpandIntoOp`` (the closing probe: its fused close count over a
whole chain and its materialize path), ``CsrOptionalExpandOp`` (OPTIONAL
MATCH of one hop as one left-outer expand), ``CsrVarExpandOp`` (the
fused bounded var-length expand), the chain walk they share
(``_fused_chain_walk``) and the planner hooks ``plan_expand_fastpath``,
``plan_expand_into_fastpath``, ``plan_optional_expand_fastpath``,
``plan_var_expand_fastpath`` and ``plan_filter_fastpath`` (the
relationship-uniqueness redundancy proof, and in-op enforcement for
``CsrExpandOp`` chains, ``CsrExpandIntoOp`` closes, ``CsrVarExpandOp``
forbid pairs and ``wcoj.MultiwayIntersectOp``).

The reference plans every ``Expand`` as relationship-scan + 2 hash joins;
when the backend is CSR-capable the physical planner swaps in these
operators: one lane-by-row merge over the device-resident CSR per hop
(``GraphIndex``); the classic join cascade stays attached for its header
only, and is never executed. Semantics are bag-identical to the classic
cascade by construction (one output row per (input row, matching edge);
the far-end node join becomes a compact-id row-map gather; undirected
expands are a primary half plus the opposite half with self-loops excluded
and Start/End swapped; var-length walks kill a path that would reuse an
edge).

Kernel tiers on this path (``hopper/``): every materialize half, every
hop of the chain walk (``_walk_lanes``) and the optional expand's matched
lanes (``_optional_lanes``) go through ``expand_rows`` — at the bucketed
size when the lattice is on, at the exact total otherwise (the
reference's unbucketed path and its walk run the jnp cascade; the kernel
equals it on every live lane) — every closing probe through
``intersect`` (the reference's two searchsorted calls: the same
function), and a single unrestricted hop's count(*) through
``frontier_deg_sum``. The DISTINCT-endpoints count's final hop is the
packed-key sort and the closing probe the sorted-key range count on
every device (the reference's host bitmap variants are not ported).

The dense count tier, the counterpart of the reference's MXU tier,
answers two shapes of a 2-hop chain with no uniqueness pair as blocked
matrix products (``jit_ops.mxu_close_count`` / ``mxu_distinct_pairs``
over ``GraphIndex.dense_adj``; ``torch.mm`` with a float32 result on the
card's tensor cores): the DISTINCT-endpoints count over both endpoints
(``CsrExpandOp.distinct_endpoints_count``) and the directed close count
(``CsrExpandIntoOp._chain_close_count``). ``TPU_CYPHER_MXU_DENSE``
routes it as in the reference: ``auto`` (the default) on where the
session's device is CUDA and off on the CPU, ``1``/``force`` on
everywhere, ``0`` off. Past ``dense_adj``'s node cap, or with a
multiplicity past bf16's exact range, the dense form declines; the TILED
tier (``mxu_*_tiled`` over ``GraphIndex.dense_tiles``, no full matrix)
then answers only on explicit request (``1``/``force``), and otherwise
the walk does. A count whose cells could pass float32's exact integers
(``rowsum1 * entry2 (* entry_c) > 2**24``) keeps the walk.
``MXU_TIER_COUNTS`` counts which tier answered. The reference's native
C++ count tiers (``native/``) run only where its device is the CPU; the
port keeps them out of the operators, so its CPU path stays the card's
path, and ``NATIVE_TIER_COUNTS`` stays at zero (ROADMAP.md section 3).

Where the reference answers from the classic child after a fused
operator raises, the port has no such shadow: its planner hooks decline
what the operators do not answer (an empty graph), and an operator
returns before a gate call that would be empty. ``CsrVarExpandOp`` emits a
var-length relationship list a query reads as an ``LST`` column built
from the walk's own edge rows (the reference answers it from the classic
cascade).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...ir import expr as E
from ...obs import trace as _obs_trace
from ...obs.metrics import REGISTRY as _OBS_REGISTRY
from ...obs.metrics import CounterView
from ...parallel.mesh import current_mesh
from ...relational.header import RecordHeader
from ...relational.ops import RelationalOperator
from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from . import bucketing
from . import device as _device
from . import jit_ops as J
from .column import I64, NODE, OBJ, REL, Column, TpuBackendError, struct_column
from .column import mask_to_idx_bucketed as _mask_to_idx_bucketed
from .graph_index import CANON_NODE, CANON_REL, GraphIndex, GraphIndexError, rekey_element_expr
from .table import ensure_flat


def _mxu_dense_mode() -> bool:
    """Route 2-hop counts through the dense count tier (blocked products,
    ``jit_ops.mxu_close_count`` / ``mxu_distinct_pairs``)? ``auto`` (the
    default) is on where the session's device is CUDA, where the tensor
    cores are, and off on the CPU, the counterpart of the reference's
    ``jax.default_backend() != "cpu"``. ``TPU_CYPHER_MXU_DENSE=1|force``
    turns it on anywhere (the CPU differential tests), ``0`` (or ``off``)
    turns it off."""
    from ...utils.config import MXU_DENSE

    mode = MXU_DENSE.get().strip().lower()
    if mode in ("0", "off"):
        return False
    if mode in ("1", "force"):
        return True
    return _device.get().type == "cuda"


def _mxu_tiled_enabled() -> bool:
    """The TILED tier (no full dense matrix; ``jit_ops.mxu_*_tiled``)
    runs only on explicit request (``TPU_CYPHER_MXU_DENSE=1|force``), never
    on ``auto``: a dense product is Theta(N^3) operations, so past
    ``dense_adj``'s cap the walk wins by orders of magnitude (SF10's
    100,096 padded nodes are 2.0e15 operations). The tier runs
    dense-eligible counts at any node count up to
    ``TPU_CYPHER_MXU_TILED_MAX`` with the dense tier's exact results."""
    from ...utils.config import MXU_DENSE

    return MXU_DENSE.get().strip().lower() in ("1", "force")


# which dense tier answered each dense-eligible count
MXU_TIER_COUNTS = CounterView(
    _OBS_REGISTRY.counter(
        "tpu_cypher_mxu_tier_total",
        "dense-eligible counts answered per MXU tier",
        labels=("tier",),
    ),
    "tier",
    ("dense", "tiled"),
)

# the reference's native C++ count tiers; the port's operators never call
# them (the module note), so the series stays at zero
NATIVE_TIER_COUNTS = CounterView(
    _OBS_REGISTRY.counter(
        "tpu_cypher_native_tier_total",
        "counts answered per native C++ stamping/DFS kernel",
        labels=("tier",),
    ),
    "tier",
    ("two_hop", "close", "varlen"),
)


def _pad_mask(mask, npad: int):
    """Optional bool[num_nodes] label mask -> bf16 0/1[(npad,)] or None."""
    if mask is None:
        return None
    return torch.nn.functional.pad(mask.to(torch.bfloat16), (0, npad - mask.shape[0]))


def _mxu_tiled_common(gi: GraphIndex, ctx, hops):
    """Shared preamble of the tiled tier: gate, hop tile providers,
    float32-exactness product term, label masks. None when the tier does
    not apply."""
    from ...optimizer.cost import mxu_tiled_node_cap

    if not _mxu_tiled_enabled() or gi.num_nodes > mxu_tiled_node_cap():
        return None
    base, final_hop = hops[1], hops[0]
    t1 = gi.dense_tiles(base.types_key, base.backwards, ctx)
    t2 = gi.dense_tiles(final_hop.types_key, final_hop.backwards, ctx)
    if t1 is None or t2 is None:
        return None
    npad = t1.npad
    m_b = _pad_mask(gi.label_mask(base.far_labels, ctx), npad)
    m_c = _pad_mask(gi.label_mask(final_hop.far_labels, ctx), npad)
    return t1, t2, t1.max_row_sum * max(t2.max_entry, 1), m_b, m_c


def _mxu_frontier(gi: GraphIndex, ctx, id_col: Column):
    """(compact positions, present) of the chain's base column for the
    dense tiers; a host-object id column has no compact form."""
    if id_col.kind == OBJ:
        raise GraphIndexError("host-object id column")
    return gi.compact_of(id_col, ctx)


def _owner_name(e: E.Expr) -> Optional[str]:
    if isinstance(e, E.Var):
        return e.name
    inner = getattr(e, "expr", None)
    if isinstance(inner, E.Var):
        return inner.name
    return None


def _empty_i64() -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int64, device=_device.get())


def _walk_lanes(rp, ci, eo, pos, deg, size: int, nvalid, with_orig: bool):
    """One walk hop's lane -> (row, edge) merge, the reference's
    ``_expand_rows(rp[pos], deg, total)``, through the ``expand_rows`` gate:
    the ``jit_ops`` walk functions' ``lanes`` list ``[row, nbr, orig,
    live]``. ``orig`` is empty without ``with_orig``; ``live`` is None
    unless ``nvalid`` (bucketed walks: lanes past it are dead). The caller
    returns before an empty merge: the gate takes no empty frontier."""
    from .hopper import expand_materialize_counted

    row, nbr, orig, live = expand_materialize_counted(
        rp, ci, eo, pos, deg, size if nvalid is None else nvalid,
        size=size, with_orig=with_orig,
    )
    return [row, nbr, orig, None if nvalid is None else live]


def _optional_lanes(rp, ci, eo, pos, deg, counts, total: int, matched_total: int):
    """The optional expand's lane merge, laid out as
    ``jit_ops.optional_expand_materialize`` lays it out: the matched lanes
    (``matched_total`` of them) through the ``expand_rows`` gate over
    ``deg``, then placed beside each unmatched row's one lane in the
    ``counts`` scan (``jit_ops.optional_place``). An unmatched row's lane
    never reaches the gate, where it would read past ``ci`` for the last
    node or an empty type set; its ``nbr`` and ``orig`` are 0 (masked
    null downstream). Returns (row, nbr, orig, matched)."""
    from .hopper import expand_materialize_counted

    if total == 0:  # before the gate: it takes no empty frontier
        z = _empty_i64()
        return z, z, z, torch.zeros(0, dtype=torch.bool, device=z.device)
    lanes = None
    if matched_total:
        lanes = expand_materialize_counted(
            rp, ci, eo, pos, deg, matched_total, size=matched_total
        )[:3]
    return J.optional_place(deg, counts, total, lanes)


def _fused_chain_walk(
    gi: GraphIndex, ctx, hops, id_col: Column, final,
    carry_rels=frozenset(), mask_pairs=None, final_orig: bool = False,
):
    """Walk a stacked expand chain carrying only (base endpoint key, current
    position, liveness) per partial path: the spine of the fused
    DISTINCT-endpoints count and of the relationship-unique chain count.
    Middle hops run ``distinct_hop_materialize``; at the outermost hop
    (``hops[0]``) ``final(lanes, akey, mask, prevs, mask_idx)`` fuses the
    terminal computation (``lanes`` carries ``orig`` when ``mask_idx``
    does, or ``final_orig`` asks for it). Returns final's int, or 0 when
    any hop empties.

    Relationship uniqueness (openCypher isomorphism, the per-pair
    ``id(r_i) <> id(r_j)`` filters) is enforced inside the walk:
    ``carry_rels`` names hops whose edge scan rows ride along per partial
    path, and ``mask_pairs[late_rel]`` lists the carried rels that hop's
    edge must differ from (violating paths die, as in ``varlen_hop``).
    ``final`` receives the carried arrays (``prevs``, sorted by rel name:
    every rel of ``carry_rels`` but the final hop's) and its own
    ``mask_idx``."""
    if id_col.kind == OBJ:
        raise GraphIndexError("host-object id column")
    gi.node_ids(ctx)
    if gi.num_nodes == 0:
        return 0
    pos, present = gi.compact_of(id_col, ctx)
    akey = pos  # base endpoint key = its compact position
    mask_pairs = mask_pairs or {}
    carried: Dict[str, Any] = {}
    last = hops[0]
    bucketed = bucketing.enabled()
    fault_point("expand")  # the hop totals read below
    for hop in reversed(hops):
        rp, ci, eo = gi.csr(hop.types_key, hop.backwards, ctx)
        mask = gi.label_mask(hop.far_labels, ctx)
        deg, t_dev = J.expand_degrees_total(rp, pos, present)
        with host_sync("expand"):
            total = int(t_dev)
        if total == 0:  # before the gate: it takes no empty frontier
            return 0
        # bucketed: the materialize size rounds up to the lattice and the
        # true count rides beside it (pad lanes come out dead)
        size = bucketing.round_size(total)
        nvalid = total if bucketed else None
        order = tuple(sorted(carried))
        prevs = tuple(carried[r] for r in order)
        midx = tuple(order.index(r) for r in mask_pairs.get(hop.rel_fld, ()))
        if hop is last:
            return final(
                _walk_lanes(rp, ci, eo, pos, deg, size, nvalid,
                            bool(midx) or final_orig),
                akey, mask, prevs, midx,
            )
        if order or hop.rel_fld in carry_rels:
            akey, pos, orig, prevs_out, present = J.unique_hop_materialize(
                _walk_lanes(rp, ci, eo, pos, deg, size, nvalid, True),
                akey, mask, prevs, mask_idx=midx,
            )
            carried = dict(zip(order, prevs_out))
            if hop.rel_fld in carry_rels:
                carried[hop.rel_fld] = orig
        else:
            akey, pos, present = J.distinct_hop_materialize(
                _walk_lanes(rp, ci, eo, pos, deg, size, nvalid, False), akey, mask
            )
    raise AssertionError("unreachable: loop always hits hops[0]")


def _chain_enforcement_spec(hops, pairs, close_rel=None, close_types=None):
    """Compile a set of rel-uniqueness pairs into walk enforcement:
    ``(carry_rels, mask_pairs, close_partners)``, or None when any pair
    cannot be enforced in the fused walk (undirected hops, duplicate rel
    bindings, rels outside the subtree, or DIFFERENT type sets — carried
    edge scan rows are only comparable within one canonical rel scan).

    ``close_partners`` lists chain rels that must differ from the closing
    relationship ``close_rel`` (``into_close_count_unique`` subtracts them
    from the probe range); chain-chain pairs become a mask at the
    later-executed hop."""
    if any(h.undirected for h in hops):
        return None
    exec_rels = [h.rel_fld for h in reversed(hops)]  # execution order
    if len(set(exec_rels)) != len(exec_rels):
        return None
    types_of = {h.rel_fld: h.types_key for h in hops}
    if close_rel is not None:
        if close_rel in types_of:
            return None
        types_of[close_rel] = close_types
    pos_of = {r: i for i, r in enumerate(exec_rels)}
    carry = set()
    mask_pairs: Dict[str, Tuple[str, ...]] = {}
    close_partners: List[str] = []
    for ra, rb in pairs:
        if ra == rb or ra not in types_of or rb not in types_of:
            return None
        if types_of[ra] != types_of[rb]:
            return None
        if close_rel is not None and close_rel in (ra, rb):
            other = rb if ra == close_rel else ra
            if other not in close_partners:
                close_partners.append(other)
            if other != exec_rels[-1]:
                carry.add(other)
            continue
        early, late = (ra, rb) if pos_of[ra] < pos_of[rb] else (rb, ra)
        if early not in mask_pairs.get(late, ()):
            mask_pairs[late] = mask_pairs.get(late, ()) + (early,)
        carry.add(early)
    return frozenset(carry), mask_pairs, tuple(close_partners)


def _collected_pairs(hops, extra=()):
    """Deduplicated uniqueness pairs attached anywhere on a fused subtree."""
    seen = []
    for op in list(hops) + list(extra):
        for p in getattr(op, "enforced_pairs", ()):
            if p not in seen:
                seen.append(p)
    return tuple(seen)


class _FusedExpandBase(RelationalOperator):
    """Shared machinery: header delegation + column assembly. The classic
    cascade stays attached as ``children[1]``: it defines the header, and
    column pruning and CSE walk it as the reference does."""

    def __init__(
        self, in_plan: RelationalOperator, classic: RelationalOperator, graph_obj
    ):
        super().__init__(in_plan, classic)
        self._graph_obj = graph_obj

    def _compute_header(self) -> RecordHeader:
        full = self.children[1].header
        req = getattr(self, "required_exprs", None)
        if req is None:
            return full
        # column pruning (relational/prune.py): emit only mentioned exprs
        m = {e: full.column(e) for e in full.expressions if e in req}
        return RecordHeader(m, full.paths)

    @property
    def graph(self):
        return self._graph_obj

    def _with_pair(self, pair, predicate) -> RelationalOperator:
        """Clone with one relationship-uniqueness pair enforced INSIDE the
        operator (``plan_filter_fastpath`` drops the filter). The classic
        child gets the dropped predicate as a real FilterOp, so its header
        stays the generic plan's."""
        from ...relational.ops import FilterOp

        kw = self._ctor_kwargs()
        kw["enforced_pairs"] = self.enforced_pairs + (tuple(sorted(pair)),)
        return type(self)(
            self.children[0],
            FilterOp(self.children[1], predicate),
            self._graph_obj,
            **kw,
        )

    def _enforce_pair_ids(self, gi: GraphIndex, ctx, row, orig):
        """Row-keep mask for the materializing path: for each enforced
        pair, compare element ids — this op's own relationship reads the
        canonical rel-scan id column at ``orig``; any other rel reads its
        input-table id column at ``row`` (element ids are global, so the
        comparison holds across type sets)."""
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        rel_cols, rel_header = gi.rel_scan(self.types_key, ctx)
        canon_id = rel_header.id_expr(rel_header.var(CANON_REL))
        own_ids = None

        def ids_of(r):
            nonlocal own_ids
            if r == self.rel_fld:
                if own_ids is None:
                    own_ids = rel_cols[rel_header.column(canon_id)].data[orig]
                return own_ids
            h = in_op.header
            try:
                col = in_t._cols[h.column(h.id_expr(h.var(r)))]
            except (KeyError, ValueError) as exc:
                raise GraphIndexError(f"uniqueness rel {r!r} unmapped") from exc
            if col.kind == OBJ:
                raise GraphIndexError("host-object id column")
            return col.data[row]

        keep = None
        for ra, rb in self.enforced_pairs:
            k = ids_of(ra) != ids_of(rb)
            keep = k if keep is None else keep & k
        return keep

    def _apply_enforced_pairs(self, gi, ctx, row, orig, extras, n_out):
        """Materializing-path enforcement: mask rows violating any enforced
        pair and compact (``extras``: whatever tensors ride along — far
        rows, swapped flags). Under bucketing the tensors may carry pad
        lanes past ``n_out`` (masked dead) and the compaction itself is
        bucket-sized."""
        if not self.enforced_pairs or not n_out:
            return row, orig, extras, n_out
        # the enforcement compact syncs a count on both branches: the same
        # site as every other mask compaction
        fault_point("compact")
        keep = self._enforce_pair_ids(gi, ctx, row, orig)
        if bucketing.enabled():
            if int(row.shape[0]) != n_out:
                keep = keep & J.row_tail_mask(row, n_out)
            idx, n2 = _mask_to_idx_bucketed(keep)
            taken = J.tree_take((row, orig) + tuple(extras), idx)
            return taken[0], taken[1], tuple(taken[2:]), n2
        kept = J.mask_sum(keep)
        with host_sync("compact"):
            n2 = int(kept)
        if n2 != n_out:
            # tpulint: allow[pad-invariant] reason=bucketing-off branch only (the enabled branch above routes through _mask_to_idx_bucketed); exact size is the contract here
            idx = J.mask_nonzero(keep, size=n2)
            taken = J.tree_take((row, orig) + tuple(extras), idx)
            row, orig, extras = taken[0], taken[1], tuple(taken[2:])
            n_out = n2
        return row, orig, extras, n_out

    def _compute_table(self):
        # the reference answers from the classic child when the fused path
        # raises; the port never answers in the fused operator's place, so
        # the error reaches the caller
        return self._fused_table()

    # -- column assembly ---------------------------------------------------

    def _gather_plan(
        self,
        plan: Dict[str, Tuple[Column, str]],
        idx_by_tag: Dict[str, Any],
        null_mask_by_tag: Optional[Dict[str, Any]] = None,
        count: Optional[int] = None,
    ) -> Dict[str, Column]:
        """Execute a tagged gather plan: one batched gather per index
        source for the device columns, host gathers for OBJ columns. A tag
        with an entry in ``null_mask_by_tag`` gathers outer-join style:
        rows where the mask is False come out null; an empty source column
        (a zero-row scan) takes ``Column.take_or_null``, which emits
        all-null rows instead of gathering from an empty axis. ``count``:
        the bucketed true row count — index tensors longer than it carry
        pad lanes, and device rows gathered there come out invalid."""
        masks = null_mask_by_tag or {}
        out: Dict[str, Column] = {}
        for tag, idx in idx_by_tag.items():
            group = {c: s for c, (s, t) in plan.items() if t == tag}
            if not group:
                continue
            mask = masks.get(tag)
            size = int(idx.shape[0])
            counted = count is not None and mask is None and size != count
            dev = {
                c: (s.data, s.valid, s.int_flag)
                for c, s in group.items()
                if s.flat and not (mask is not None and len(s) == 0)
            }
            if dev:
                if counted:
                    taken = J.cols_take_counted(dev, idx, count)
                elif mask is None:
                    taken = J.cols_take(dev, idx)
                else:
                    taken = J.cols_take_or_null(dev, idx, mask)
                for c, (d, v, i) in taken.items():
                    s = group[c]
                    if counted:
                        out[c] = Column(
                            s.kind, d, v, s.vocab, int_flag=i,
                            pad=size - count,
                            pad_synth=s.valid is None or s.pad_synth,
                        )
                    else:
                        out[c] = Column(s.kind, d, v, s.vocab, int_flag=i)
            for c, s in group.items():
                if c in out:
                    continue
                if mask is not None:
                    out[c] = s.take_or_null(idx, mask)
                else:
                    out[c] = s.take(idx[:count] if counted else idx)
        return out

    def _assemble(
        self, gi: GraphIndex, row, orig, swapped, far_rows,
        far_labels: Tuple[str, ...], rel_var: str, far_var: Optional[str],
        n_out: int,
    ):
        """Gather every output column for the fused result. ``row``: input
        row per output row; ``orig``: canonical rel-scan row; ``swapped``:
        bool tensor (or None) — report Start/End swapped for those rows;
        ``far_rows``: row in the far-end canonical node scan."""
        from .table import CudaTable

        ctx = self.context
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        rel_cols, rel_header = gi.rel_scan(self.types_key, ctx)
        if far_var is not None:
            node_cols, node_header, _ = gi.node_scan(far_labels, ctx)
        header = self.header
        canon_rel = E.Var(CANON_REL)
        canon_node = E.Var(CANON_NODE)
        plan: Dict[str, Tuple[Column, str]] = {}
        swap_plan: Dict[str, Tuple[Column, Column]] = {}
        for e in header.expressions:
            col = header.column(e)
            if col in plan or col in swap_plan:
                continue
            if e in in_op.header:
                plan[col] = (in_t._cols[in_op.header.column(e)], "row")
                continue
            owner = _owner_name(e)
            if owner == rel_var:
                key = rekey_element_expr(e, canon_rel)
                if swapped is not None and isinstance(e, (E.StartNode, E.EndNode)):
                    flipped = (
                        E.EndNode(canon_rel)
                        if isinstance(e, E.StartNode)
                        else E.StartNode(canon_rel)
                    )
                    swap_plan[col] = (
                        rel_cols[rel_header.column(key)],
                        rel_cols[rel_header.column(flipped)],
                    )
                    continue
                if key is None or key not in rel_header:
                    raise GraphIndexError(f"unmapped rel expr {e!r}")
                plan[col] = (rel_cols[rel_header.column(key)], "orig")
                continue
            if far_var is not None and owner == far_var:
                key = rekey_element_expr(e, canon_node)
                if key is None or key not in node_header:
                    raise GraphIndexError(f"unmapped node expr {e!r}")
                plan[col] = (node_cols[node_header.column(key)], "far")
                continue
            raise GraphIndexError(f"unmapped expr {e!r}")
        count = n_out if bucketing.enabled() else None
        out = self._gather_plan(
            plan, {"row": row, "orig": orig, "far": far_rows}, count=count
        )
        for c, (a, b) in swap_plan.items():
            if a.kind == OBJ or b.kind == OBJ:
                raise GraphIndexError("host-object endpoint column")
            data, valid = J.gather_swapped(
                a.data, b.data, a.valid, b.valid, orig, swapped
            )
            size = int(data.shape[0])
            if count is not None and size != count:
                live = J.row_tail_mask(data, count)
                valid = live if valid is None else valid & live
                out[c] = Column(
                    a.kind, data, valid, a.vocab, pad=size - count,
                    pad_synth=a.valid is None and b.valid is None,
                )
            else:
                out[c] = Column(a.kind, data, valid, a.vocab)
        return CudaTable(out, n_out)


class CsrExpandOp(_FusedExpandBase):
    """Fused (frontier)-[rel]->(far) expansion over the graph CSR.

    Frontier element ids map to compact ids (one searchsorted), per-row
    degrees come from ``row_ptr``, and the output is materialized by the
    ``expand_rows`` kernel gate — O(output) work, no per-hop sorting."""

    def __init__(
        self,
        in_plan: RelationalOperator,
        classic: RelationalOperator,
        graph_obj,
        *,
        frontier_fld: str,
        rel_fld: str,
        far_fld: str,
        types_key: Tuple[str, ...],
        undirected: bool,
        backwards: bool,
        far_labels: Tuple[str, ...],
        enforced_pairs: Tuple[Tuple[str, str], ...] = (),
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.frontier_fld = frontier_fld
        self.rel_fld = rel_fld
        self.far_fld = far_fld
        self.types_key = types_key
        self.undirected = undirected
        self.backwards = backwards
        self.far_labels = far_labels
        self.enforced_pairs = enforced_pairs

    def _ctor_kwargs(self) -> Dict[str, Any]:
        return dict(
            frontier_fld=self.frontier_fld,
            rel_fld=self.rel_fld,
            far_fld=self.far_fld,
            types_key=self.types_key,
            undirected=self.undirected,
            backwards=self.backwards,
            far_labels=self.far_labels,
        )

    def _show_inner(self) -> str:
        arrow = "-" if self.undirected else ("<-" if self.backwards else "->")
        t = "|".join(self.types_key) or "*"
        uniq = (
            " uniq" + ",".join(f"({a}<>{b})" for a, b in self.enforced_pairs)
            if self.enforced_pairs
            else ""
        )
        return f"({self.frontier_fld}){arrow}[{self.rel_fld}:{t}]({self.far_fld}){uniq}"

    def _expand_half(self, gi: GraphIndex, pos, present, reverse: bool, drop_loops: bool):
        """One CSR expand half. Returns ``(row, nbr, orig, count)`` where
        ``count`` is the TRUE emission count; under bucketing the tensors
        are tail-padded past it (pad lanes sanitized to row 0)."""
        ctx = self.context
        rp, ci, eo = gi.csr(self.types_key, reverse, ctx)
        fault_point("expand")  # the emission total read below
        deg, t_dev = J.expand_degrees_total(rp, pos, present)
        with host_sync("expand"):
            total = int(t_dev)
        # pre-flight: (row, nbr, orig) int64 lanes + every gathered output
        # column (8B data + 1B mask), padded on the bucket lattice
        bucketing.admit(
            total, 24 + 9 * max(len(self.header.expressions), 1), "expand"
        )
        if total == 0:
            z = _empty_i64()
            return z, z, z, 0
        bucketed = bucketing.enabled()
        # identity when the lattice is off; either way the true/padded
        # lane counts land on the trace span and the registry counters
        size = bucketing.round_size(total)
        # kernel tier: the Hopper row-search materialize (hopper/expand.py)
        from .hopper import expand_materialize_counted

        row, nbr, orig, live = expand_materialize_counted(
            rp, ci, eo, pos, deg, total, size=size
        )
        if drop_loops:
            keep = J.drop_loops_mask(nbr, pos, row) & live
            if bucketed:
                idx, total = _mask_to_idx_bucketed(keep)
            else:
                idx, total = J.mask_to_idx(keep, site="expand")
            row, nbr, orig = J.tree_take((row, nbr, orig), idx)
        return row, nbr, orig, total

    def _chain_hops(self) -> List["CsrExpandOp"]:
        """The input chain of directly-stacked CsrExpandOps over the same
        graph (deepest last), each expanding FROM the previous far node."""
        from ...relational.ops import CacheOp

        hops: List[CsrExpandOp] = [self]
        node = self
        while True:
            child = node.children[0]
            while isinstance(child, CacheOp):  # cache wraps are identity
                child = child.children[0]
            if (
                isinstance(child, CsrExpandOp)
                and child._graph_obj is self._graph_obj
                and node.frontier_fld == child.far_fld
            ):
                hops.append(child)
                node = child
                continue
            return hops

    def _count_via_chain(self, gi: GraphIndex, ctx) -> int:
        """Whole-chain count without materializing any row set: a single
        unrestricted hop is the ``frontier_deg_sum`` kernel; longer or
        label-filtered chains are the SpMV chain (``path_count_chain``);
        a chain with enforced uniqueness pairs is the edge-carrying walk
        (``chain_count_final_unique``)."""
        hops = self._chain_hops()
        base = hops[-1]
        in_op = base.children[0]
        in_t = ensure_flat(in_op.table)
        frontier_var = in_op.header.var(base.frontier_fld)
        id_col = in_t._cols[in_op.header.column(in_op.header.id_expr(frontier_var))]
        gi.node_ids(ctx)  # build the compact id space (validates the graph)
        if gi.num_nodes == 0:
            return 0
        if id_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        # the fused count is an expand-class dispatch: its count syncs sit
        # behind the expand fault site
        fault_point("expand")
        pairs = _collected_pairs(hops)
        if pairs:
            # the SpMV carries per-node multiplicities only (no edge
            # identity), so unique chains count through the walk
            spec = _chain_enforcement_spec(hops, pairs)
            if spec is None:
                raise GraphIndexError("unenforceable uniqueness pairs")
            carry, mask_pairs, _ = spec

            def final(lanes, akey, mask, prevs, midx):
                count = J.chain_count_final_unique(lanes, mask, prevs, mask_idx=midx)
                with host_sync("expand_count"):
                    return int(count)

            return _fused_chain_walk(
                gi, ctx, hops, id_col, final, carry, mask_pairs
            )
        if len(hops) == 1 and not self.undirected and not self.far_labels:
            # single unrestricted hop: O(frontier) degree sum
            from .hopper import csr_frontier_degree_sum

            pos, present = gi.compact_of(id_col, ctx)
            rp, _, _ = gi.csr(self.types_key, self.backwards, ctx)
            count = csr_frontier_degree_sum(rp, pos, present)
            with host_sync("expand_count"):
                return int(count)
        mesh = current_mesh()
        if mesh is not None and mesh.size > 1:
            # the mesh form: each hop's SpMV runs per shard over contiguous
            # slices of col_idx and the partial sums combine
            chain = J.path_count_chain_on_mesh(mesh)
            _obs_trace.note("expand_shards", mesh.size)

            def orient(types_key, rev):
                return gi.csr_shards(types_key, rev, ctx, mesh)
        else:
            chain = J.path_count_chain

            def orient(types_key, rev):
                return gi.csr(types_key, rev, ctx)[:2]
        hop_data = []
        for hop in reversed(hops):  # deepest (first executed) hop first
            mask = gi.label_mask(hop.far_labels, ctx)
            if hop.undirected:
                rp_a, ci_a = orient(hop.types_key, hop.backwards)
                rp_b, ci_b = orient(hop.types_key, not hop.backwards)
                loop_cnt = gi.loop_count(hop.types_key, ctx)
                hop_data.append((rp_a, ci_a, rp_b, ci_b, loop_cnt, mask))
            else:
                rp, ci = orient(hop.types_key, hop.backwards)
                hop_data.append((rp, ci, None, None, None, mask))
        dev_ids, _ = gi.node_ids(ctx)
        return int(
            chain(
                dev_ids, id_col.data, id_col.valid, tuple(hop_data),
                num_nodes=gi.num_nodes,
            )
        )

    def distinct_endpoints_count(self, fields) -> Optional[int]:
        """count(DISTINCT endpoints) over a fused expand chain without
        materializing any row set: per hop one size sync and one (base key,
        position) materialize; the final hop fuses into a packed-key count
        (``jit_ops.distinct_pairs_count_final``, a sort). Returns None when the pattern
        doesn't fit (fields beyond the chain endpoints, undirected hops,
        paths, pairs the walk cannot enforce, a graph the index declines):
        the caller then takes the materialized distinct. A device fault is
        not one of those and reaches the caller. The relational pushdown
        hook is ``AggregateOp._compute_table``."""
        try:
            hops = self._chain_hops()
            base = hops[-1]
            want = set(fields)
            if not want or not want <= {base.frontier_fld, self.far_fld}:
                return None
            if base.frontier_fld == self.far_fld:
                return None  # ambiguous binding; keep the generic path
            if any(h.undirected for h in hops):
                return None
            # named paths make the var's identity more than its id column
            if any(self.header.has_path(f) for f in want):
                return None
            use_a = base.frontier_fld in want
            use_c = self.far_fld in want
            gi = GraphIndex.of(self.graph)
            ctx = self.context
            in_op = base.children[0]
            in_t = ensure_flat(in_op.table)
            frontier_var = in_op.header.var(base.frontier_fld)
            id_col = in_t._cols[
                in_op.header.column(in_op.header.id_expr(frontier_var))
            ]
            gi.node_ids(ctx)
            if use_a and use_c and gi.num_nodes >= (1 << 30):
                return None  # pos*V+pos pair key must stay below the sentinel
            # eligible from here on: the walk syncs, so the expand fault
            # site covers it
            fault_point("expand")
            pairs = _collected_pairs(hops)
            carry, mask_pairs = frozenset(), {}
            if pairs:
                spec = _chain_enforcement_spec(hops, pairs)
                if spec is None:
                    return None  # the materialized path enforces by row masks
                carry, mask_pairs, _ = spec
            elif (
                len(hops) == 2 and use_a and use_c and current_mesh() is None
                and _mxu_dense_mode()
            ):
                # the dense tier: the nonzero count of the boolean product,
                # one chain of matrix products instead of the walk's lanes
                got = self._mxu_distinct_pairs(gi, ctx, hops, id_col)
                if got is not None:
                    return got

            def final(lanes, akey, mask, prevs, midx):
                kw = dict(use_a=use_a, use_c=use_c, num_nodes=gi.num_nodes)
                if midx:
                    count = J.distinct_pairs_count_final_unique(
                        lanes, akey, mask, prevs, mask_idx=midx, **kw
                    )
                else:
                    count = J.distinct_pairs_count_final(lanes, akey, mask, **kw)
                with host_sync("expand_count"):
                    return int(count)

            return _fused_chain_walk(
                gi, ctx, hops, id_col, final, carry, mask_pairs
            )
        except (GraphIndexError, TpuBackendError):
            return None

    def _mxu_distinct_pairs(self, gi, ctx, hops, id_col):
        """count(DISTINCT a, c) as the nonzero count of the blocked bf16
        boolean product (``jit_ops.mxu_distinct_pairs``); the tiled tier
        past the dense cap; None when neither applies."""
        base, final_hop = hops[1], hops[0]
        got1 = gi.dense_adj(base.types_key, base.backwards, ctx)
        got2 = gi.dense_adj(final_hop.types_key, final_hop.backwards, ctx)
        if got1 is None or got2 is None:
            return self._mxu_distinct_pairs_tiled(gi, ctx, hops, id_col)
        a1, _, rowsum1 = got1
        a2, entry2, _ = got2
        if rowsum1 * entry2 > (1 << 24):
            return None  # the > 0.5 test needs each float32 cell exact
        pos, present = _mxu_frontier(gi, ctx, id_col)
        npad = int(a1.shape[0])
        pres = J.frontier_multiplicity(pos, present, n=npad) > 0
        m_b = _pad_mask(gi.label_mask(base.far_labels, ctx), npad)
        m_c = _pad_mask(gi.label_mask(final_hop.far_labels, ctx), npad)
        fault_point("expand")  # the dense-tier count sync below
        MXU_TIER_COUNTS.inc("dense")
        count = J.mxu_distinct_pairs(a1, a2, pres, m_b, m_c, block=J.MM_ROWS)
        with host_sync("expand_count"):
            return int(count)

    def _mxu_distinct_pairs_tiled(self, gi, ctx, hops, id_col):
        """count(DISTINCT a, c) on the TILED tier: row blocks densified
        from the edge lists, no (Npad, Npad) matrix."""
        got = _mxu_tiled_common(gi, ctx, hops)
        if got is None:
            return None
        t1, t2, cell_bound, m_b, m_c = got
        if cell_bound > (1 << 24):
            return None
        pos, present = _mxu_frontier(gi, ctx, id_col)
        pres = J.frontier_multiplicity(pos, present, n=t1.npad) > 0
        fault_point("expand")  # the tiled-tier count syncs below
        MXU_TIER_COUNTS.inc("tiled")
        return J.mxu_distinct_pairs_tiled(t1, t2, pres, m_b, m_c)

    def _factorized_expand(self, gi: GraphIndex, ctx, in_op, in_t, pos, present):
        """The expand's output as a ``FactorizedTable``: the input rows are
        the lanes, each lane's suffix run is its CSR adjacency slice, and
        relationship and far-node columns decode through the ``(eo,)`` and
        ``(ci, row_map)`` gather-map chains only when rows are read.
        Eligible for directed expands with no far labels and no
        uniqueness pair, over an input with no bucket pads, when
        ``optimizer.cost.prefer_factorized`` routes the flat estimate here;
        None keeps the flat materialize."""
        from ...optimizer.cost import factorized_routing_enabled, prefer_factorized
        from .factorized import FactorizedTable, RunLevel, note_factorized
        from .table import CudaTable

        if (
            self.undirected
            or self.far_labels
            or self.enforced_pairs
            or gi.num_nodes == 0
            # the pre-gate keeps the default configuration free: no run
            # bounds and no total read unless routing is live
            or not factorized_routing_enabled()
            or in_t._depad() is not in_t
        ):
            return None
        rp, ci, eo = gi.csr(self.types_key, self.backwards, ctx)
        if int(ci.shape[0]) == 0:
            return None
        fault_point("expand")  # the run-total read below
        lo, cnt, t_dev = J.csr_run_bounds(rp, pos, present, in_t.size)
        with host_sync("expand"):
            total = int(t_dev)
        if not prefer_factorized(total, 24 + 9 * max(len(self.header.expressions), 1)):
            return None
        rel_cols, rel_header = gi.rel_scan(self.types_key, ctx)
        node_cols, node_header, row_map = gi.node_scan((), ctx)
        canon_rel = E.Var(CANON_REL)
        canon_node = E.Var(CANON_NODE)
        pfx_cols: Dict[str, Column] = {}
        lvl_cols: Dict[str, Tuple[Column, Tuple[Any, ...]]] = {}
        for e in self.header.expressions:
            col = self.header.column(e)
            if col in pfx_cols or col in lvl_cols:
                continue
            if e in in_op.header:
                pfx_cols[col] = in_t._cols[in_op.header.column(e)]
                continue
            owner = _owner_name(e)
            if owner == self.rel_fld:
                key, cols, hdr, maps = rekey_element_expr(e, canon_rel), rel_cols, rel_header, (eo,)
            elif owner == self.far_fld:
                key, cols, hdr, maps = (
                    rekey_element_expr(e, canon_node), node_cols, node_header, (ci, row_map)
                )
            else:
                raise GraphIndexError(f"unmapped expr {e!r}")
            if key is None or key not in hdr:
                raise GraphIndexError(f"unmapped expr {e!r}")
            src = cols[hdr.column(key)]
            if src.kind == OBJ or len(src) == 0:
                return None  # a host column cannot ride the decode
            lvl_cols[col] = (src, maps)
        # the compressed form pays admission for its two run-bound arrays
        # at the lane count, never the flat product
        bucketing.admit(in_t.size, 16, "factorized")
        out = FactorizedTable(
            CudaTable(pfx_cols, in_t.size), (RunLevel(lo, cnt, lvl_cols),), nrows=total
        )
        note_factorized(total, int(pos.shape[0]), in_t.size)
        return out

    def _fused_table(self):
        from .table import CudaTable

        fault_point("expand")
        gi = GraphIndex.of(self.graph)
        ctx = self.context
        if not self.header.expressions:
            # pure-multiplicity consumer (a pruned count(*) plan): no rows
            # are materialized at all
            return CudaTable({}, self._count_via_chain(gi, ctx))
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        frontier_var = in_op.header.var(self.frontier_fld)
        id_col = in_t._cols[in_op.header.column(in_op.header.id_expr(frontier_var))]
        if id_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        pos, present = gi.compact_of(id_col, ctx)
        bucketed = bucketing.enabled()
        fact = self._factorized_expand(gi, ctx, in_op, in_t, pos, present)
        if fact is not None:
            return fact
        row, nbr, orig, n_live = self._expand_half(
            gi, pos, present, reverse=self.backwards, drop_loops=False
        )
        swapped = None
        if self.undirected:
            row2, nbr2, orig2, n2 = self._expand_half(
                gi, pos, present, reverse=not self.backwards, drop_loops=True
            )
            if bucketed:
                live = J.concat_pair(
                    J.row_tail_mask(row, n_live), J.row_tail_mask(row2, n2)
                )
            row, nbr, orig, swapped = J.concat_expand_halves(
                row, nbr, orig, row2, nbr2, orig2
            )
            n_live += n2
            if bucketed and int(row.shape[0]) != n_live:
                # the halves' tail pads land mid-array after the concat:
                # compact back to the tail-pad form
                idx = J.mask_nonzero(live, size=bucketing.round_size(n_live))
                row, nbr, orig, swapped = J.tree_take(
                    (row, nbr, orig, swapped), idx
                )
        # far-end label filter + node-table row lookup in one gather
        _, _, row_map = gi.node_scan(self.far_labels, ctx)
        if gi.num_nodes and not self.far_labels:
            # unrestricted far end: every neighbour is in the scan
            far_rows, _ = J.far_lookup(row_map, nbr)
            n_out = n_live if bucketed else int(row.shape[0])
        elif gi.num_nodes:
            far_rows, keep = J.far_lookup(row_map, nbr)
            if bucketed and int(row.shape[0]) != n_live:
                # pad lanes duplicate a real neighbour and would pass the
                # label probe — they are not rows
                keep = keep & J.row_tail_mask(keep, n_live)
            if bucketed:
                idx, n_out = _mask_to_idx_bucketed(keep)
                changed = n_out != n_live or int(idx.shape[0]) != int(row.shape[0])
            else:
                idx, n_out = J.mask_to_idx(keep, site="expand")
                changed = n_out != int(row.shape[0])
            if changed:
                if swapped is not None:
                    row, orig, far_rows, swapped = J.tree_take(
                        (row, orig, far_rows, swapped), idx
                    )
                else:
                    row, orig, far_rows = J.tree_take((row, orig, far_rows), idx)
        else:
            far_rows = row = orig = _empty_i64()
            n_out = 0
            if swapped is not None:
                swapped = torch.zeros(0, dtype=torch.bool, device=_device.get())
        extras = (far_rows,) if swapped is None else (far_rows, swapped)
        row, orig, extras, n_out = self._apply_enforced_pairs(
            gi, ctx, row, orig, extras, n_out
        )
        far_rows = extras[0]
        if swapped is not None:
            swapped = extras[1]
        return self._assemble(
            gi, row, orig, swapped, far_rows, self.far_labels,
            self.rel_fld, self.far_fld, n_out,
        )


class CsrExpandIntoOp(_FusedExpandBase):
    """Fused ExpandInto: both endpoints bound; the closing relationships are
    found by a range probe over the sorted ``src*N + dst`` edge keys, on
    the ``intersect`` gate."""

    def __init__(
        self,
        in_plan: RelationalOperator,
        classic: RelationalOperator,
        graph_obj,
        *,
        source_fld: str,
        rel_fld: str,
        target_fld: str,
        types_key: Tuple[str, ...],
        undirected: bool,
        enforced_pairs: Tuple[Tuple[str, str], ...] = (),
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.source_fld = source_fld
        self.rel_fld = rel_fld
        self.target_fld = target_fld
        self.types_key = types_key
        self.undirected = undirected
        self.enforced_pairs = enforced_pairs

    def _ctor_kwargs(self) -> Dict[str, Any]:
        return dict(
            source_fld=self.source_fld,
            rel_fld=self.rel_fld,
            target_fld=self.target_fld,
            types_key=self.types_key,
            undirected=self.undirected,
        )

    def _show_inner(self) -> str:
        arrow = "-" if self.undirected else "->"
        t = "|".join(self.types_key) or "*"
        uniq = (
            " uniq" + ",".join(f"({a}<>{b})" for a, b in self.enforced_pairs)
            if self.enforced_pairs
            else ""
        )
        return (
            f"({self.source_fld})-[{self.rel_fld}:{t}]{arrow}"
            f"({self.target_fld}) into{uniq}"
        )

    def _probe(self, gi: GraphIndex, keys, s_pos, t_pos, ok, drop_loops: bool):
        """Closing-edge probe on the ``intersect`` gate, then the
        materialize, sized exactly in every bucketing mode (as
        ``wcoj.MultiwayIntersectOp``'s). Returns ``(row, orig)``."""
        from .hopper import intersect_range_count

        if int(keys.shape[0]) == 0 or int(s_pos.shape[0]) == 0:
            # nothing to probe: the gate takes no empty key or query list
            z = _empty_i64()
            return z, z
        _, _, eo = gi.csr(self.types_key, False, self.context)
        q, q_ok = J.into_probe(s_pos, t_pos, ok, gi.num_nodes, drop_loops=drop_loops)
        lo, counts, total_dev = intersect_range_count(keys, q, q_ok)
        del q, q_ok
        # tpulint: allow[pad-invariant] reason=the close's rows are sized exactly in every bucket mode (bucketing.exact_size, as the WCOJ materialize): the lanes are the answer's rows and their pairs stamp the span
        row, orig, _ = J.into_materialize_counted(
            eo, lo, counts, total_dev, size=bucketing.exact_size(total_dev)
        )
        return row, orig

    def _chain_close_count(self) -> Optional[int]:
        """count(*) over ExpandInto(fused expand chain) without materializing
        the chain's row set: walk the chain with (base key, position) state
        (as ``distinct_endpoints_count`` does), then fuse the closing-edge
        probe into the final hop (``jit_ops.into_close_queries``, the
        ``intersect`` gate). The classic plan materializes the whole k-hop
        table first: at SF10 the 2-hop set alone is about 2*10^8 rows.
        None = the shape doesn't fit (a non-chain input, undirected chain
        hops, endpoint vars not the chain's ends, pairs the walk cannot
        enforce): the caller materializes. A device fault is not one of
        those and reaches the caller."""
        from ...relational.ops import CacheOp
        from .hopper import intersect_range_count

        in_op = self.children[0]
        while isinstance(in_op, CacheOp):
            in_op = in_op.children[0]
        if (
            not isinstance(in_op, CsrExpandOp)
            or in_op._graph_obj is not self._graph_obj
        ):
            return None
        try:
            hops = in_op._chain_hops()
            base = hops[-1]
            ends = {base.frontier_fld, in_op.far_fld}
            if (
                {self.source_fld, self.target_fld} != ends
                or self.source_fld == self.target_fld
                or base.frontier_fld == in_op.far_fld
            ):
                return None
            if any(h.undirected for h in hops):
                return None
            gi = GraphIndex.of(self.graph)
            ctx = self.context
            base_in = base.children[0]
            frontier_var = base_in.header.var(base.frontier_fld)
            id_col = ensure_flat(base_in.table)._cols[
                base_in.header.column(base_in.header.id_expr(frontier_var))
            ]
            # eligible from here on: the walk and the probe sync
            fault_point("expand")
            src_is_base = self.source_fld == base.frontier_fld
            pairs = _collected_pairs(hops, (self,))
            if (
                not pairs and len(hops) == 2 and not self.undirected
                and current_mesh() is None and _mxu_dense_mode()
            ):
                got = self._mxu_close_count(gi, ctx, hops, id_col, src_is_base)
                if got is not None:
                    return got
            keys = gi.edge_keys(self.types_key, ctx)
            if int(keys.shape[0]) == 0:
                return 0  # no closing edge; the gate takes no empty key list
            n = gi.num_nodes
            if pairs:
                if self.undirected:
                    return None  # dual-orientation probe: materialize
                spec = _chain_enforcement_spec(
                    hops, pairs, close_rel=self.rel_fld, close_types=self.types_key
                )
                if spec is None:
                    return None  # the materialized path enforces by row masks
                carry, mask_pairs, close_partners = spec
                kbo = gi.edge_keys_by_orig(self.types_key, ctx)
                exec_last = hops[0].rel_fld
                sub_cur = exec_last in close_partners
                # the walk hands the final hop its carried edges sorted by
                # rel name, and carries every rel of ``carry``
                order = tuple(sorted(carry))
                sub_idx = tuple(
                    order.index(r) for r in sorted(close_partners) if r != exec_last
                )

                def final_u(lanes, akey, mask, prevs, midx):
                    probe, ok, orig, prevs_r = J.into_close_unique_queries(
                        lanes, akey, mask, prevs, src_is_base=src_is_base,
                        num_nodes=n, mask_idx=midx,
                    )
                    _, counts, _ = intersect_range_count(keys, probe, ok)
                    count = J.into_close_count_unique(
                        counts, probe, ok, orig, prevs_r, kbo,
                        sub_idx=sub_idx, sub_cur=sub_cur,
                    )
                    with host_sync("expand_count"):
                        return int(count)

                return _fused_chain_walk(
                    gi, ctx, hops, id_col, final_u, carry, mask_pairs,
                    final_orig=True,
                )

            def final(lanes, akey, mask, prevs, midx):
                queries = J.into_close_queries(
                    lanes, akey, mask, src_is_base=src_is_base, num_nodes=n,
                    undirected=self.undirected,
                )
                total = 0
                while queries:  # each probe freed before the next is counted
                    q, ok = queries.pop(0)
                    count = intersect_range_count(keys, q, ok)[2]
                    with host_sync("expand_count"):
                        total += int(count)
                    del q, ok, count
                return total

            return _fused_chain_walk(gi, ctx, hops, id_col, final)
        except (GraphIndexError, TpuBackendError):
            return None

    def _mxu_close_count(self, gi, ctx, hops, id_col, src_is_base):
        """Triangle/cycle close count as blocked matrix products:
        tri = sum_a mult[a] * sum_c (A1 @ A2)[a, c] * C[a, c]. The closing
        adjacency C is oriented FROM the walk's base endpoint (probe (a, c)
        reads the forward matrix, probe (c, a) the reverse). The tiled tier
        past the dense cap; None when neither applies (a multiplicity past
        bf16's exact range, cells past float32's exact integers)."""
        base, final_hop = hops[1], hops[0]
        got1 = gi.dense_adj(base.types_key, base.backwards, ctx)
        got2 = gi.dense_adj(final_hop.types_key, final_hop.backwards, ctx)
        gotc = gi.dense_adj(self.types_key, not src_is_base, ctx)
        if got1 is None or got2 is None or gotc is None:
            return self._mxu_close_count_tiled(gi, ctx, hops, id_col, src_is_base)
        a1, _, rowsum1 = got1
        a2, entry2, _ = got2
        cm, entry_c, _ = gotc
        if rowsum1 * entry2 * max(entry_c, 1) > (1 << 24):
            # a 2-path cell, or its product with the closing multiplicity,
            # could pass float32's exact integers: keep the walk
            return None
        pos, present = _mxu_frontier(gi, ctx, id_col)
        npad = int(a1.shape[0])
        mult = J.frontier_multiplicity(pos, present, n=npad)
        m_b = _pad_mask(gi.label_mask(base.far_labels, ctx), npad)
        m_c = _pad_mask(gi.label_mask(final_hop.far_labels, ctx), npad)
        fault_point("expand")  # the dense-tier count sync below
        MXU_TIER_COUNTS.inc("dense")
        count = J.mxu_close_count(a1, a2, cm, mult, m_b, m_c, block=J.MM_ROWS)
        with host_sync("expand_count"):
            return int(count)

    def _mxu_close_count_tiled(self, gi, ctx, hops, id_col, src_is_base):
        """Triangle/cycle close count on the TILED tier (see
        ``CsrExpandOp._mxu_distinct_pairs_tiled``)."""
        got = _mxu_tiled_common(gi, ctx, hops)
        if got is None:
            return None
        t1, t2, cell_bound, m_b, m_c = got
        tc = gi.dense_tiles(self.types_key, not src_is_base, ctx)
        if tc is None or cell_bound * max(tc.max_entry, 1) > (1 << 24):
            return None
        pos, present = _mxu_frontier(gi, ctx, id_col)
        mult = J.frontier_multiplicity(pos, present, n=t1.npad)
        fault_point("expand")  # the tiled-tier count syncs below
        MXU_TIER_COUNTS.inc("tiled")
        return J.mxu_close_count_tiled(t1, t2, tc, mult, m_b, m_c)

    def _fused_table(self):
        from .table import CudaTable

        if not self.header.expressions:
            # pure-multiplicity consumer (a pruned count(*) plan): the
            # whole-chain fused close count first
            n = self._chain_close_count()
            if n is not None:
                return CudaTable({}, n)
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        gi = GraphIndex.of(self.graph)
        ctx = self.context
        h = in_op.header
        s_col = in_t._cols[h.column(h.id_expr(h.var(self.source_fld)))]
        t_col = in_t._cols[h.column(h.id_expr(h.var(self.target_fld)))]
        if s_col.kind == OBJ or t_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        s_pos, s_ok = gi.compact_of(s_col, ctx)
        t_pos, t_ok = gi.compact_of(t_col, ctx)
        ok = s_ok & t_ok
        keys = gi.edge_keys(self.types_key, ctx)
        row, orig = self._probe(gi, keys, s_pos, t_pos, ok, drop_loops=False)
        swapped = None
        if self.undirected:
            row2, orig2 = self._probe(gi, keys, t_pos, s_pos, ok, drop_loops=True)
            row, orig, swapped = J.concat_into_halves(row, orig, row2, orig2)
        n_out = int(row.shape[0])
        extras = () if swapped is None else (swapped,)
        row, orig, extras, n_out = self._apply_enforced_pairs(
            gi, ctx, row, orig, extras, n_out
        )
        if swapped is not None:
            swapped = extras[0]
        return self._assemble(
            gi, row, orig, swapped, None, (), self.rel_fld, None, n_out
        )


class CsrOptionalExpandOp(_FusedExpandBase):
    """Fused OPTIONAL MATCH (frontier)-[rel]->(far): the reference plans
    Optional as a left outer join of the optional subtree
    (``RelationalPlanner.scala:298``); here matched frontier rows emit
    their expansions and unmatched rows emit ONE null-padded row, in one
    lane merge (``_optional_lanes``). Unlabeled directed single-hop
    patterns only (labels, undirected steps and WHERE keep the classic
    outer join)."""

    def __init__(
        self,
        in_plan: RelationalOperator,
        classic: RelationalOperator,
        graph_obj,
        *,
        frontier_fld: str,
        rel_fld: str,
        far_fld: str,
        types_key: Tuple[str, ...],
        backwards: bool,
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.frontier_fld = frontier_fld
        self.rel_fld = rel_fld
        self.far_fld = far_fld
        self.types_key = types_key
        self.backwards = backwards

    def _show_inner(self) -> str:
        arrow = "<-" if self.backwards else "->"
        t = "|".join(self.types_key) or "*"
        return f"optional ({self.frontier_fld}){arrow}[{self.rel_fld}:{t}]({self.far_fld})"

    def _fused_table(self):
        from .table import CudaTable

        gi = GraphIndex.of(self.graph)
        ctx = self.context
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        frontier_var = in_op.header.var(self.frontier_fld)
        id_col = in_t._cols[in_op.header.column(in_op.header.id_expr(frontier_var))]
        if id_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        # the planner hook declined an empty graph: the compact id space
        # has a node
        pos, present = gi.compact_of(id_col, ctx)
        rp, ci, eo = gi.csr(self.types_key, self.backwards, ctx)
        # bucket pad rows are not input rows: they must emit NOTHING (an
        # unmatched real row emits one null row; a pad row none)
        nrows = in_t.size if int(pos.shape[0]) != in_t.size else None
        deg, counts, t_dev = J.optional_expand_degrees(rp, pos, present, nrows=nrows)
        fault_point("expand")  # the lane totals read below
        with host_sync("expand"):
            total, matched_total = torch.stack((t_dev, torch.sum(deg))).tolist()
        bucketing.exact_size(total)  # the lanes on the trace span and counters
        row, nbr, orig, matched = _optional_lanes(
            rp, ci, eo, pos, deg, counts, total, matched_total
        )
        _, _, row_map = gi.node_scan((), ctx)
        far_rows, _ = J.far_lookup(row_map, nbr)
        # assembly: input pass-throughs by row; rel/far columns null-masked
        # where unmatched
        rel_cols, rel_header = gi.rel_scan(self.types_key, ctx)
        node_cols, node_header, _ = gi.node_scan((), ctx)
        canon_rel = E.Var(CANON_REL)
        canon_node = E.Var(CANON_NODE)
        plan: Dict[str, Tuple[Column, str]] = {}
        for e in self.header.expressions:
            col = self.header.column(e)
            if col in plan:
                continue
            if e in in_op.header:
                plan[col] = (in_t._cols[in_op.header.column(e)], "row")
                continue
            owner = _owner_name(e)
            if owner == self.rel_fld:
                key = rekey_element_expr(e, canon_rel)
                if key is None or key not in rel_header:
                    raise GraphIndexError(f"unmapped rel expr {e!r}")
                plan[col] = (rel_cols[rel_header.column(key)], "orig")
                continue
            if owner == self.far_fld:
                key = rekey_element_expr(e, canon_node)
                if key is None or key not in node_header:
                    raise GraphIndexError(f"unmapped node expr {e!r}")
                plan[col] = (node_cols[node_header.column(key)], "far")
                continue
            raise GraphIndexError(f"unmapped optional-expand expr {e!r}")
        out = self._gather_plan(
            plan,
            {"row": row, "orig": orig, "far": far_rows},
            null_mask_by_tag={"orig": matched, "far": matched},
        )
        return CudaTable(out, total)


class CsrVarExpandOp(_FusedExpandBase):
    """Fused bounded var-length expand: the frontier-loop replacement for
    the unrolled join cascade (reference ``VarLengthExpandPlanner.scala:45-330``).
    Each hop is one ``expand_rows`` materialize carrying (origin row,
    current node, walked edge scan rows); edge reuse kills a path through
    a mask (no compaction mid-chain); every length in [lower, upper] emits
    its surviving rows, which are compacted per level and concatenated once
    at the end.

    The fused path assembles input pass-through columns, target-node
    columns and, when the query reads it, the relationship list: per
    emitted path the walked edge scan rows of its levels, in path order,
    as an ``LST`` over a ``relationship`` STRUCT gathered from the
    canonical relationship scan (the reference answers a relationship list
    from its classic cascade). Under a named path it also emits the path's
    intermediate nodes (the planner's companion column): from the start
    node, each relationship's end that is not the previous node, so an
    undirected walk comes out in path order, as an ``LST`` over a ``node``
    STRUCT gathered from the canonical node scan."""

    def __init__(
        self,
        in_plan: RelationalOperator,
        classic: RelationalOperator,
        graph_obj,
        *,
        source_fld: str,
        rel_fld: str,
        target_fld: str,
        types_key: Tuple[str, ...],
        lower: int,
        upper: Optional[int],
        far_labels: Tuple[str, ...],
        undirected: bool = False,
        enforced_pairs: Tuple[Tuple[str, str], ...] = (),
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.source_fld = source_fld
        self.rel_fld = rel_fld
        self.target_fld = target_fld
        self.types_key = types_key
        self.lower = lower
        self.upper = upper
        self.far_labels = far_labels
        self.undirected = undirected
        # (rel_fld, fixed_rel) pairs: the walk must avoid the fixed rel's
        # edge — ``none(x IN rel_fld WHERE id(x) = id(fixed))`` enforced as
        # an initial forbidden entry of the walked-edge masks
        self.enforced_pairs = enforced_pairs

    def _ctor_kwargs(self) -> Dict[str, Any]:
        return dict(
            source_fld=self.source_fld,
            rel_fld=self.rel_fld,
            target_fld=self.target_fld,
            types_key=self.types_key,
            lower=self.lower,
            upper=self.upper,
            far_labels=self.far_labels,
            undirected=self.undirected,
            enforced_pairs=self.enforced_pairs,
        )

    def _show_inner(self) -> str:
        t = "|".join(self.types_key) or "*"
        arrow = "-" if self.undirected else "->"
        uniq = (
            " uniq" + ",".join(f"({a}<>{b})" for a, b in self.enforced_pairs)
            if self.enforced_pairs
            else ""
        )
        upper = "" if self.upper is None else self.upper
        return (
            f"({self.source_fld})-[{self.rel_fld}:{t}*{self.lower}.."
            f"{upper}]{arrow}({self.target_fld}){uniq}"
        )

    @property
    def _companion(self) -> str:
        from ...relational.header import path_nodes_companion

        return path_nodes_companion(self.rel_fld)

    def _forbid_arrays(self, gi: GraphIndex, ctx):
        """Per-input-row forbidden canonical scan rows (one int64 tensor per
        enforced pair, -1 = unconstrained): fixed-rel global ids from the
        input table, bridged into this walk's scan-row space. Seeding the
        walk's ``prev_edges`` with them makes the walked-edge masks enforce
        the fixed-versus-var-length isomorphism."""
        if not self.enforced_pairs:
            return ()
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        h = in_op.header
        sorted_ids, perm = gi.rel_row_index(self.types_key, ctx)
        out = []
        for ra, rb in self.enforced_pairs:
            other = rb if ra == self.rel_fld else ra
            if other == self.rel_fld:
                raise GraphIndexError("forbid pair does not name a fixed rel")
            try:
                col = in_t._cols[h.column(h.id_expr(h.var(other)))]
            except (KeyError, ValueError) as exc:
                raise GraphIndexError(
                    f"uniqueness rel {other!r} unmapped"
                ) from exc
            if col.kind == OBJ:
                raise GraphIndexError("host id column in forbid pair")
            out.append(J.rel_rows_of_ids(sorted_ids, perm, col.data, col.valid))
        return tuple(out)

    def _resolved_upper(self, ci) -> int:
        """Unbounded '*' resolves to the matching-edge count: relationship
        isomorphism bounds any walk by the number of edges, and the walk
        exits at the empty frontier long before that in practice."""
        if self.upper is not None:
            return self.upper
        return max(int(ci.shape[0]), self.lower, 1)

    def _fused_table(self):
        from .table import CudaTable

        fault_point("var_expand")
        in_op = self.children[0]
        header = self.header
        rel_list = any(_owner_name(e) in (self.rel_fld, self._companion)
                       for e in header.expressions)
        count_only = not header.expressions
        gi = GraphIndex.of(self.graph)
        ctx = self.context
        in_t = ensure_flat(in_op.table)
        frontier_var = in_op.header.var(self.source_fld)
        id_col = in_t._cols[in_op.header.column(in_op.header.id_expr(frontier_var))]
        if id_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        gi.node_ids(ctx)
        if gi.num_nodes == 0:
            return CudaTable({}, 0) if count_only else self._assemble_levels(gi, [])
        pos, present = gi.compact_of(id_col, ctx)
        if self.undirected:
            # both-orientation CSR: one walk replaces the classic planner's
            # per-step orientation cascade; the shared edge_orig makes the
            # walked-edge masks direction-agnostic
            rp, ci, eo = gi.csr_undirected(self.types_key, ctx)
        else:
            rp, ci, eo = gi.csr(self.types_key, False, ctx)
        _, _, row_map = gi.node_scan(self.far_labels, ctx)
        row0 = None
        # forbidden edges seed the walked-edge masks: the walk's own
        # ``orig != prev`` checks then enforce fixed-vs-var-length
        # relationship isomorphism
        prev_edges: Tuple[Any, ...] = self._forbid_arrays(gi, ctx)
        nforbid = len(prev_edges)
        total_count = 0
        levels: List[Tuple[Any, Any]] = []
        if self.lower == 0:
            # length 0: the target is the source node (it must carry the
            # far labels) — the identity frontier before the walk's levels
            row00, far, keep, k_dev = J.varlen_zero(pos, present, row_map)
            if count_only:
                with host_sync("var_expand_emit"):
                    total_count += int(k_dev)
            else:
                with host_sync("var_expand_emit"):
                    k = int(k_dev)
                if k:
                    # tpulint: allow[pad-invariant] reason=exact emission gather: pad lanes would enter the levels' concat as live rows; the walk's hop is the bucketed materialize (round_size below)
                    idx = J.mask_nonzero(keep, size=k)
                    # zero-length walks carry empty relationship lists
                    walked = (_empty_i64().reshape(k, 0),) if rel_list else ()
                    levels.append(J.tree_take((row00, far), idx) + walked)
        bucketed = bucketing.enabled()
        for level in range(1, self._resolved_upper(ci) + 1):
            fault_point("var_expand")
            deg, t_dev = J.expand_degrees_total(rp, pos, present)
            with host_sync("var_expand"):
                total = int(t_dev)
            if total == 0:  # before the gate: it takes no empty frontier
                break
            # pre-flight: each hop lane carries (row0, nbr, orig) plus one
            # walked-edge lane per uniqueness mask, padded on the lattice
            bucketing.admit(
                total, 8 * (3 + len(prev_edges) + 1), "var_expand"
            )
            row0, nbr, orig, prev_edges, iso = J.varlen_hop(
                _walk_lanes(
                    rp, ci, eo, pos, deg, bucketing.round_size(total),
                    total if bucketed else None, True,
                ),
                row0, prev_edges,
            )
            if level >= self.lower:
                far, keep, k_dev = J.varlen_emit(nbr, iso, row_map)
                if count_only:
                    with host_sync("var_expand_emit"):
                        total_count += int(k_dev)
                else:
                    with host_sync("var_expand_emit"):
                        k = int(k_dev)
                    if k:
                        # exact emission gather: pad lanes would enter the
                        # levels' concat as live rows
                        # tpulint: allow[pad-invariant] reason=exact emission gather: pad lanes would enter the levels' concat as live rows; the hop above is the bucketed materialize
                        idx = J.mask_nonzero(keep, size=k)
                        walked = (
                            (torch.stack(prev_edges[nforbid:], 1)[idx],) if rel_list else ()
                        )
                        levels.append(J.tree_take((row0, far), idx) + walked)
            pos, present = nbr, iso
        if count_only:
            return CudaTable({}, total_count)
        return self._assemble_levels(gi, levels)

    def _assemble_levels(self, gi: GraphIndex, levels):
        """Concat per-level (origin row, far row) frames and gather output
        columns: input pass-throughs by origin row, target-var columns from
        the far-label canonical node scan."""
        from .table import CudaTable

        ctx = self.context
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        header = self.header
        if not levels:
            row0 = far = _empty_i64()
        elif len(levels) == 1:
            row0, far = levels[0][:2]
        else:
            row0, far = J.concat_rows(tuple(lv[:2] for lv in levels))
        n_out = int(row0.shape[0])
        rel_col = nodes_col = None
        node_cols, node_header, _ = gi.node_scan(self.far_labels, ctx)
        canon_node = E.Var(CANON_NODE)
        plan: Dict[str, Tuple[Column, str]] = {}
        for e in header.expressions:
            col = header.column(e)
            if col in plan:
                continue
            if e in in_op.header:
                plan[col] = (in_t._cols[in_op.header.column(e)], "row")
                continue
            if _owner_name(e) == self.target_fld:
                key = rekey_element_expr(e, canon_node)
                if key is None or key not in node_header:
                    raise GraphIndexError(f"unmapped var-expand target expr {e!r}")
                plan[col] = (node_cols[node_header.column(key)], "far")
                continue
            if e == E.Var(self.rel_fld):
                rel_col = col
                continue
            if e == E.Var(self._companion):
                nodes_col = col
                continue
            raise GraphIndexError(f"unmapped var-expand expr {e!r}")
        out = self._gather_plan(plan, {"row": row0, "far": far})
        ends = None
        if nodes_col is not None or (rel_col is not None and self.undirected):
            ends = self._walk_ends(gi, in_t, levels)
        if rel_col is not None:
            out[rel_col] = self._rel_list(
                gi, [lv[2] for lv in levels],
                [f for _, f in ends] if self.undirected else None)
        if nodes_col is not None:
            out[nodes_col] = self._path_nodes(gi, [ids for ids, _ in ends])
        return CudaTable(out, n_out)

    def _walk_ends(self, gi: GraphIndex, in_t, levels):
        """Per level, two (paths, level) tensors: the node each walked
        relationship leads to (from the source node, the endpoint that is
        not the previous node), and whether it was walked from its start
        node."""
        ctx = self.context
        h = self.children[0].header
        src_ids = in_t._cols[h.column(h.id_expr(h.var(self.source_fld)))].data
        rel_cols, rel_header = gi.rel_scan(self.types_key, ctx)
        owned = rel_header.expressions_for(E.Var(CANON_REL))
        start, end = (rel_cols[rel_header.column(next(e for e in owned if isinstance(e, c)))].data
                      for c in (E.StartNode, E.EndNode))
        out = []
        for lv in levels:
            walked = lv[2]
            prev = src_ids[lv[0]]
            ids, fwd = [], []
            for j in range(int(walked.shape[1])):
                a, b = start[walked[:, j]], end[walked[:, j]]
                fwd.append(a == prev)
                prev = torch.where(fwd[-1], b, a)
                ids.append(prev)
            out.append((torch.stack(ids, 1) if ids else walked,
                        torch.stack(fwd, 1) if fwd else walked.to(torch.bool)))
        return out

    def _path_nodes(self, gi: GraphIndex, ends) -> Column:
        """The intermediate nodes of each emitted path (``level - 1`` per
        path, ``_walk_ends``), as a list over a ``node`` STRUCT read
        through the canonical node scan's rows."""
        from .lists import list_column

        ctx = self.context
        blocks = [e[:, :-1].reshape(-1) for e in ends]
        lens = [torch.full((int(e.shape[0]),), max(int(e.shape[1]) - 1, 0), dtype=torch.int64,
                           device=e.device) for e in ends]
        ids = torch.cat(blocks) if blocks else _empty_i64()
        node_cols, node_header, row_map = gi.node_scan((), ctx)
        pos, _ = gi.compact_of(Column(I64, ids, None), ctx)
        canon = E.Var(CANON_NODE)
        fields = [("id", node_header.id_expr(canon))]
        fields += [("label:" + f.label, f) for f in node_header.labels_for(canon)]
        fields += [("prop:" + f.key, f) for f in node_header.properties_for(canon)]
        child = struct_column(
            {n: node_cols[node_header.column(e)] for n, e in fields},
            int(ids.shape[0]), None, NODE, device=ids.device, rows=row_map[pos],
        )
        return list_column(torch.cat(lens) if lens else _empty_i64(), child)

    def _rel_list(self, gi: GraphIndex, walked, forward=None) -> Column:
        """The relationship list per emitted path: each level's block holds
        ``level`` walked edge scan rows per row, in path order; the child is
        a ``relationship`` STRUCT over the canonical relationship scan's
        columns read through those rows, gathered only where a field is
        read (``size(rs)`` reads the lengths alone). An undirected walk
        passes ``forward`` (per level, whether each relationship was walked
        from its start): a relationship walked backwards has its start and
        end swapped, as the classic cascade's both-orientation scan
        (``SwapStartEndOp``) gives it, so its fields are gathered here."""
        from .lists import list_column

        rel_cols, rel_header = gi.rel_scan(self.types_key, self.context)
        canon = E.Var(CANON_REL)
        owned = rel_header.expressions_for(canon)
        exprs = [("id", rel_header.id_expr(canon))]
        exprs += [(n, next(e for e in owned if isinstance(e, c)))
                  for n, c in (("start", E.StartNode), ("end", E.EndNode))]
        exprs += [("type:" + f.rel_type, f) for f in rel_header.types_for(canon)]
        exprs += [("prop:" + p.key, p) for p in rel_header.properties_for(canon)]
        rows = torch.cat([w.reshape(-1) for w in walked]) if walked else _empty_i64()
        lens = torch.cat([
            torch.full((int(w.shape[0]),), int(w.shape[1]), dtype=torch.int64, device=w.device)
            for w in walked
        ]) if walked else _empty_i64()
        child = struct_column(
            {n: rel_cols[rel_header.column(e)] for n, e in exprs},
            int(rows.shape[0]), None, REL, device=rows.device, rows=rows,
        )
        if forward is not None:
            fwd = torch.cat([f.reshape(-1) for f in forward]) if forward else rows.to(torch.bool)
            fields = dict(child.fields)
            s, e = fields["start"], fields["end"]
            fields["start"] = Column(s.kind, torch.where(fwd, s.data, e.data), s.valid)
            fields["end"] = Column(e.kind, torch.where(fwd, e.data, s.data), e.valid)
            child = struct_column(fields, int(rows.shape[0]), None, REL, device=rows.device)
        return list_column(lens, child)


def plan_expand_fastpath(planner, op, lhs, rhs, classic) -> Optional[RelationalOperator]:
    """Swap the classic Expand cascade for ``CsrExpandOp`` when statically
    safe; return None to keep the classic plan."""
    from ...logical import ops as L

    if op.direction not in (">", "-"):
        return None
    lhs_vars = {v.name for v in lhs.header.vars}
    if op.rel in lhs_vars:
        return None  # re-bound rel var: keep the generic join semantics
    backwards = op.source not in lhs_vars
    frontier = op.target if backwards else op.source
    far = op.source if backwards else op.target
    if frontier not in lhs_vars or far in lhs_vars:
        return None
    if {v.name for v in rhs.header.vars} != {far}:
        return None
    if not isinstance(op.rhs, L.NodeScan):
        return None  # far side must be a plain node scan (label filter only)
    m = op.rhs.node_type.material
    far_labels = tuple(sorted(getattr(m, "labels", ()) or ()))
    types = getattr(op.rel_type.material, "types", frozenset()) or frozenset()
    return CsrExpandOp(
        lhs,
        classic,
        rhs.graph,
        frontier_fld=frontier,
        rel_fld=op.rel,
        far_fld=far,
        types_key=GraphIndex.types_key(types),
        undirected=op.direction == "-",
        backwards=backwards,
        far_labels=far_labels,
    )


def plan_expand_into_fastpath(planner, op, in_plan, classic) -> Optional[RelationalOperator]:
    """Swap the classic ExpandInto join for ``CsrExpandIntoOp`` when both
    endpoints are bound; None keeps the classic plan. Declines a graph
    with no node (the classic join answers it: the reference answers it
    from its classic child) and one whose ``src*N + dst`` keys could pass
    int64."""
    if op.direction not in (">", "-"):
        return None
    in_vars = {v.name for v in in_plan.header.vars}
    if op.rel in in_vars or op.source not in in_vars or op.target not in in_vars:
        return None
    if not _node_space_fits(in_plan.graph, in_plan.context):
        return None
    types = getattr(op.rel_type.material, "types", frozenset()) or frozenset()
    return CsrExpandIntoOp(
        in_plan,
        classic,
        in_plan.graph,
        source_fld=op.source,
        rel_fld=op.rel,
        target_fld=op.target,
        types_key=GraphIndex.types_key(types),
        undirected=op.direction == "-",
    )


def plan_optional_expand_fastpath(planner, op, lhs, rhs_planned, classic) -> Optional[RelationalOperator]:
    """Swap Optional(single unlabeled directed Expand) for the fused
    left-outer expand; None keeps the classic outer join. The optional
    subtree must be exactly Expand(NodeScan, NodeScan) — any Filter (WHERE
    inside OPTIONAL), labels, or undirected step keeps the general plan,
    and so does a graph with no node (the reference answers it from its
    classic child)."""
    from ...logical import ops as L

    e = op.rhs
    if not isinstance(e, L.Expand) or e.direction != ">":
        return None
    if not isinstance(e.lhs, L.NodeScan) or not isinstance(e.rhs, L.NodeScan):
        return None
    lhs_vars = {v.name for v in lhs.header.vars}
    bound = {e.source, e.rel, e.target} & lhs_vars
    if e.rel in bound:
        return None
    if bound == {e.source}:
        frontier, far, backwards = e.source, e.target, False
    elif bound == {e.target}:
        frontier, far, backwards = e.target, e.source, True
    else:
        return None
    # the logical planner always puts the BOUND side at Expand.lhs and the
    # newly scanned far side at Expand.rhs, regardless of direction
    frontier_scan, far_scan = e.lhs, e.rhs
    # far-side labels change which rows match (keep the classic join);
    # frontier labels are fine only when the bound variable's TYPE already
    # guarantees them (the planner stamps the binding's labels onto the
    # optional scan — semantically redundant there)
    if getattr(far_scan.node_type.material, "labels", None):
        return None
    scan_labels = frozenset(
        getattr(frontier_scan.node_type.material, "labels", None) or ()
    )
    if scan_labels:
        try:
            bt = lhs.header.var(frontier).cypher_type.material
            bound_labels = frozenset(getattr(bt, "labels", None) or ())
        except Exception:  # fault-ok: plan-time header probe (no device
            # work); None keeps the classic plan
            return None
        if not scan_labels <= bound_labels:
            return None
    graph_obj = getattr(rhs_planned, "graph", None)
    if graph_obj is None or not _node_space_fits(graph_obj, lhs.context):
        return None
    types = getattr(e.rel_type.material, "types", frozenset()) or frozenset()
    return CsrOptionalExpandOp(
        lhs,
        classic,
        graph_obj,
        frontier_fld=frontier,
        rel_fld=e.rel,
        far_fld=far,
        types_key=GraphIndex.types_key(types),
        backwards=backwards,
    )


def _node_space_fits(graph_obj, ctx) -> bool:
    """The graph has a node and fewer than 2**30, so a ``src*N + dst``
    key fits int64 (as ``wcoj.plan_multiway_intersect_fastpath`` checks)."""
    try:
        gi = GraphIndex.of(graph_obj)
        gi.node_ids(ctx)
        return 0 < gi.num_nodes < (1 << 30)
    except (GraphIndexError, TpuBackendError):
        return False


def plan_var_expand_fastpath(planner, op, lhs, rhs, classic) -> Optional[RelationalOperator]:
    """Swap the unrolled var-length join cascade for ``CsrVarExpandOp`` when
    statically safe; None keeps the classic plan. Directed and undirected
    steps and zero-length lower bounds all fuse (undirected walks ride the
    both-orientation CSR), a named path's intermediate nodes too; pre-bound
    endpoints keep the general machinery."""
    from ...logical import ops as L

    if op.direction not in (">", "-"):
        return None
    lhs_vars = {v.name for v in lhs.header.vars}
    if op.rel in lhs_vars or op.source not in lhs_vars or op.target in lhs_vars:
        return None
    if {v.name for v in rhs.header.vars} != {op.target}:
        return None
    if not isinstance(op.rhs, L.NodeScan):
        return None
    m = op.rhs.node_type.material
    far_labels = tuple(sorted(getattr(m, "labels", ()) or ()))
    types = getattr(op.rel_type.material, "types", frozenset()) or frozenset()
    return CsrVarExpandOp(
        lhs,
        classic,
        rhs.graph,
        source_fld=op.source,
        rel_fld=op.rel,
        target_fld=op.target,
        types_key=GraphIndex.types_key(types),
        lower=op.lower,
        upper=op.upper,
        far_labels=far_labels,
        undirected=op.direction == "-",
    )


def _rel_neq_pair(pred) -> Optional[Tuple[str, str]]:
    """Recognize a relationship-uniqueness predicate id(a) <> id(b) over two
    relationship variables (the shape ``ir.builder`` emits)."""
    from ...api import types as T

    if not isinstance(pred, E.Neq):
        return None
    l, r = pred.lhs, pred.rhs
    if not (isinstance(l, E.Id) and isinstance(r, E.Id)):
        return None
    lv, rv = l.expr, r.expr
    if not (isinstance(lv, E.Var) and isinstance(rv, E.Var)):
        return None
    for v in (lv, rv):
        t = getattr(v, "cypher_type", None)
        if t is None or not isinstance(t.material, T.CTRelationshipType):
            return None
    return lv.name, rv.name


def _rel_list_none_pair(pred) -> Optional[Tuple[str, str]]:
    """Recognize the fixed-vs-var-length isomorphism predicate
    ``none(x IN rs WHERE id(x) = id(r))`` (the shape ``ir.builder`` emits
    for a var-length rel list ``rs`` vs a fixed rel ``r``); returns
    (list_var, fixed_var) or None."""
    from ...api import types as T

    if not isinstance(pred, E.Quantified) or pred.kind != "none":
        return None
    lst = pred.list_expr
    if not isinstance(lst, E.Var):
        return None
    lt = getattr(lst, "cypher_type", None)
    if lt is None or not isinstance(lt.material, T.CTListType):
        return None
    if not isinstance(lt.material.inner.material, T.CTRelationshipType):
        return None
    eq = pred.predicate
    if not isinstance(eq, E.Equals):
        return None
    l, r = eq.lhs, eq.rhs
    if not (isinstance(l, E.Id) and isinstance(r, E.Id)):
        return None
    lv, rv = l.expr, r.expr
    if not (isinstance(lv, E.Var) and isinstance(rv, E.Var)):
        return None
    names = {lv.name, rv.name}
    if pred.var.name not in names or len(names) != 2:
        return None
    (other,) = names - {pred.var.name}
    for v in (lv, rv):
        t = getattr(v, "cypher_type", None)
        if t is None or not isinstance(t.material, T.CTRelationshipType):
            return None
    return lst.name, other


def _graph_loop_free(graph_obj, types_key, ctx) -> bool:
    """True when no relationship of the type set is a self-loop (host-cached
    on the GraphIndex)."""
    gi = GraphIndex.of(graph_obj)
    cache = getattr(gi, "_loop_free", None)
    if cache is None:
        cache = gi._loop_free = {}
    got = cache.get(types_key)
    if got is None:
        try:
            s, d, _ = gi._edge_endpoints(types_key, ctx)
        except (GraphIndexError, TpuBackendError):
            cache[types_key] = False
            return False
        got = cache[types_key] = not bool((s == d).any())
    return got


def _chain_rel_ends(hops) -> Optional[Dict[str, Tuple[str, str, Tuple[str, ...]]]]:
    """Per-rel GRAPH-direction endpoints ``rel -> (src_fld, dst_fld,
    types_key)`` for a directed chain; None when any hop is undirected or a
    rel field repeats."""
    out: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {}
    for h in hops:
        if h.undirected or h.rel_fld in out:
            return None
        out[h.rel_fld] = (
            (h.far_fld, h.frontier_fld, h.types_key)
            if h.backwards
            else (h.frontier_fld, h.far_fld, h.types_key)
        )
    return out


def _rel_uniqueness_redundant(rel_ends, ra, rb, graph_obj, ctx) -> bool:
    """Sound redundancy proof for ``id(ra) <> id(rb)``: if the two
    relationships were the same edge, their sources and targets would
    coincide; propagating those equalities (union-find over endpoint
    fields), any relationship whose endpoints land in one class is forced
    to be a self-loop of its type set — impossible when that type set is
    loop-free, so the filter can never remove a row."""
    ea, eb = rel_ends.get(ra), rel_ends.get(rb)
    if ea is None or eb is None:
        return False
    parent: Dict[str, str] = {}

    def find(x: str) -> str:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    parent[find(ea[0])] = find(eb[0])
    parent[find(ea[1])] = find(eb[1])
    for s, d, tk in rel_ends.values():
        if find(s) == find(d) and _graph_loop_free(graph_obj, tk, ctx):
            return True
    return False


def _undirected_close_filter(node, rel_ends, pair, child):
    """A uniqueness pair over an undirected ``CsrExpandIntoOp``: the close
    binds its edge in either orientation, so the pair drops only when the
    redundancy proof holds for both; the operator enforces no pair of an
    undirected close, so otherwise the FilterOp stays. The reference keeps
    every such FilterOp, and its count then materializes the chain and
    both probe halves; on a loop-free type set the port drops them and
    counts both orientations in the walk (``into_close_queries``)."""
    key = tuple(sorted(pair))
    if not set(key) <= set(rel_ends):
        return None
    flipped = dict(rel_ends)
    flipped[node.rel_fld] = (node.target_fld, node.source_fld, node.types_key)
    if all(
        _rel_uniqueness_redundant(ends, key[0], key[1], node._graph_obj, node.context)
        for ends in (rel_ends, flipped)
    ):
        return child
    return None


def plan_filter_fastpath(planner, op, child) -> Optional[RelationalOperator]:
    """Resolve a relationship-uniqueness filter over a fused subtree, so
    count(*) and DISTINCT chains keep their whole-plan fusion (the openCypher
    isomorphism predicates ``ir.builder`` adds would otherwise force the
    chain to materialize just to compare edge ids):

    1. PROOF: ``_rel_uniqueness_redundant`` — equality would force a
       self-loop of a loop-free type set: drop the filter outright (the
       SpMV count stays available);
    2. ENFORCEMENT: drop the filter and clone the subtree's top operator
       with the pair in ``enforced_pairs``. A ``CsrExpandOp`` chain needs
       the same type set on both rels (its walks carry edge scan rows; its
       materializing path compares element ids); ``MultiwayIntersectOp``
       compares global element ids; a ``CsrVarExpandOp`` takes a
       ``none(x IN rs WHERE id(x) = id(r))`` pair as a forbidden edge;
    3. otherwise keep the generic FilterOp plan.

    A ``CsrExpandIntoOp`` over a fused chain adds its closing relationship
    to the chain's endpoint map, so a chain-versus-close pair is proven or,
    for a directed close, enforced the same way
    (``into_close_count_unique``); an undirected close takes the proof in
    both orientations (``_undirected_close_filter``)."""
    from ...relational.ops import CacheOp
    from .wcoj import MultiwayIntersectOp

    pair = _rel_neq_pair(op.predicate)
    list_pair = _rel_list_none_pair(op.predicate) if pair is None else None
    if pair is None and list_pair is None:
        return None
    wraps = 0
    node = child
    while isinstance(node, CacheOp):
        node = node.children[0]
        wraps += 1

    def rewrap(n: RelationalOperator) -> RelationalOperator:
        for _ in range(wraps):
            n = CacheOp(n)
        return n

    if list_pair is not None:
        # fixed-vs-var-length isomorphism: push the fixed rel into the fused
        # walk as a forbidden edge (a seeded walked-edge mask)
        rs, r = list_pair
        if not isinstance(node, CsrVarExpandOp) or node.rel_fld != rs:
            return None
        in_vars = {v.name for v in node.children[0].header.vars}
        if r not in in_vars or r == node.rel_fld:
            return None
        key = tuple(sorted((rs, r)))
        if key in node.enforced_pairs:
            return child  # duplicate predicate: already enforced below
        return rewrap(node._with_pair(key, op.predicate))

    if isinstance(node, MultiwayIntersectOp):
        # the multiway op compares GLOBAL element ids, so it needs no
        # same-type-set restriction
        rel_ends = node._rel_ends()
    elif isinstance(node, CsrExpandIntoOp):
        in_op = node.children[0]
        while isinstance(in_op, CacheOp):
            in_op = in_op.children[0]
        if not (
            isinstance(in_op, CsrExpandOp) and in_op._graph_obj is node._graph_obj
        ):
            return None
        rel_ends = _chain_rel_ends(in_op._chain_hops())
        if rel_ends is None or node.rel_fld in rel_ends:
            return None
        rel_ends[node.rel_fld] = (node.source_fld, node.target_fld, node.types_key)
        if node.undirected:
            return _undirected_close_filter(node, rel_ends, pair, child)
    elif isinstance(node, CsrExpandOp):
        rel_ends = _chain_rel_ends(node._chain_hops())
    else:
        return None
    if rel_ends is None:
        return None
    key = tuple(sorted(pair))
    if not set(key) <= set(rel_ends):
        return None
    if key in node.enforced_pairs:
        return child  # duplicate predicate: already enforced below
    if _rel_uniqueness_redundant(
        rel_ends, key[0], key[1], node._graph_obj, node.context
    ):
        return child
    if isinstance(node, MultiwayIntersectOp) or (
        rel_ends[key[0]][2] == rel_ends[key[1]][2]
    ):
        # carried edge scan rows are only comparable within one canonical
        # rel scan, so chain enforcement needs identical type sets
        return rewrap(node._with_pair(key, op.predicate))
    return None
