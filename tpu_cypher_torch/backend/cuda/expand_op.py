"""Fused CSR expand operator: the CUDA backend's physical Expand.

The port of the slices' part of ``tpu_cypher/backend/tpu/expand_op.py``:
``_FusedExpandBase`` (with ``_with_pair``), ``CsrExpandOp`` (its
materialize half and its count chain) and the planner hooks
``plan_expand_fastpath`` and ``plan_filter_fastpath`` (the
relationship-uniqueness redundancy proof, and in-op enforcement for
``wcoj.MultiwayIntersectOp``).

The reference plans every ``Expand`` as relationship-scan + 2 hash joins;
when the backend is CSR-capable the physical planner swaps in
``CsrExpandOp``: one repeat+gather over the device-resident CSR per hop
(``GraphIndex``); the classic join cascade stays attached for its header
only, and is never executed in this slice. Semantics are
bag-identical to the classic cascade by construction (one output row per
(input row, matching edge); the far-end node join becomes a compact-id
row-map gather; undirected expands are a primary half plus the opposite
half with self-loops excluded and Start/End swapped).

Kernel tiers on this path (``hopper/``): every materialize half goes
through ``expand_rows`` — at the bucketed size when the lattice is on, at
the exact total otherwise (the reference's unbucketed path calls the jnp
cascade directly; the kernel equals it on every live lane) — and a
single unrestricted hop's count(*) through ``frontier_deg_sum``.

Later slices port ``CsrExpandIntoOp``, ``CsrOptionalExpandOp``,
``CsrVarExpandOp``, the DISTINCT-endpoint counts, the MXU/native tiers and
in-op uniqueness enforcement over ``CsrExpandOp`` chains (ROADMAP.md
queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...ir import expr as E
from ...relational.header import RecordHeader
from ...relational.ops import RelationalOperator
from ...runtime.faults import fault_point
from . import bucketing
from . import device as _device
from . import jit_ops as J
from .column import OBJ, Column, TpuBackendError
from .column import mask_to_idx_bucketed as _mask_to_idx_bucketed
from .graph_index import CANON_NODE, CANON_REL, GraphIndex, GraphIndexError, rekey_element_expr

def _owner_name(e: E.Expr) -> Optional[str]:
    if isinstance(e, E.Var):
        return e.name
    inner = getattr(e, "expr", None)
    if isinstance(inner, E.Var):
        return inner.name
    return None


def _empty_i64() -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int64, device=_device.get())


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

    def _compute_table(self):
        # the reference answers from the classic child when the fused path
        # raises; the port's Table SPI cannot run that child yet (``join``
        # is the next slice), so the error reaches the caller
        return self._fused_table()

    # -- column assembly ---------------------------------------------------

    def _gather_plan(
        self,
        plan: Dict[str, Tuple[Column, str]],
        idx_by_tag: Dict[str, Any],
        count: Optional[int] = None,
    ) -> Dict[str, Column]:
        """Execute a tagged gather plan: one batched gather per index
        source for the device columns, host gathers for OBJ columns.
        ``count``: the bucketed true row count — index tensors longer than
        it carry pad lanes, and device rows gathered there come out
        invalid."""
        out: Dict[str, Column] = {}
        for tag, idx in idx_by_tag.items():
            group = {c: s for c, (s, t) in plan.items() if t == tag}
            if not group:
                continue
            size = int(idx.shape[0])
            counted = count is not None and size != count
            dev = {
                c: (s.data, s.valid, s.int_flag)
                for c, s in group.items()
                if s.kind != OBJ
            }
            if dev:
                taken = (
                    J.cols_take_counted(dev, idx, count)
                    if counted
                    else J.cols_take(dev, idx)
                )
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
                if c not in out:
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
        in_t = in_op.table
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
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.frontier_fld = frontier_fld
        self.rel_fld = rel_fld
        self.far_fld = far_fld
        self.types_key = types_key
        self.undirected = undirected
        self.backwards = backwards
        self.far_labels = far_labels
        # in-op relationship-uniqueness enforcement is a later slice; the
        # relational pruner reads the (always empty) pair list
        self.enforced_pairs: Tuple[Tuple[str, str], ...] = ()

    def _show_inner(self) -> str:
        arrow = "-" if self.undirected else ("<-" if self.backwards else "->")
        t = "|".join(self.types_key) or "*"
        return f"({self.frontier_fld}){arrow}[{self.rel_fld}:{t}]({self.far_fld})"

    def _expand_half(self, gi: GraphIndex, pos, present, reverse: bool, drop_loops: bool):
        """One CSR expand half. Returns ``(row, nbr, orig, count)`` where
        ``count`` is the TRUE emission count; under bucketing the tensors
        are tail-padded past it (pad lanes sanitized to row 0)."""
        ctx = self.context
        rp, ci, eo = gi.csr(self.types_key, reverse, ctx)
        deg, t_dev = J.expand_degrees_total(rp, pos, present)
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
                idx, total = J.mask_to_idx(keep)
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
        label-filtered chains are the SpMV chain (``path_count_chain``)."""
        hops = self._chain_hops()
        base = hops[-1]
        in_op = base.children[0]
        in_t = in_op.table
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
        if len(hops) == 1 and not self.undirected and not self.far_labels:
            # single unrestricted hop: O(frontier) degree sum
            from .hopper import csr_frontier_degree_sum

            pos, present = gi.compact_of(id_col, ctx)
            rp, _, _ = gi.csr(self.types_key, self.backwards, ctx)
            return int(csr_frontier_degree_sum(rp, pos, present))
        hop_data = []
        for hop in reversed(hops):  # deepest (first executed) hop first
            mask = gi.label_mask(hop.far_labels, ctx)
            if hop.undirected:
                rp_a, ci_a, _ = gi.csr(hop.types_key, hop.backwards, ctx)
                rp_b, ci_b, _ = gi.csr(hop.types_key, not hop.backwards, ctx)
                loop_cnt = gi.loop_count(hop.types_key, ctx)
                hop_data.append((rp_a, ci_a, rp_b, ci_b, loop_cnt, mask))
            else:
                rp, ci, _ = gi.csr(hop.types_key, hop.backwards, ctx)
                hop_data.append((rp, ci, None, None, None, mask))
        dev_ids, _ = gi.node_ids(ctx)
        return int(
            J.path_count_chain(
                dev_ids, id_col.data, id_col.valid, tuple(hop_data),
                num_nodes=gi.num_nodes,
            )
        )

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
        in_t = in_op.table
        frontier_var = in_op.header.var(self.frontier_fld)
        id_col = in_t._cols[in_op.header.column(in_op.header.id_expr(frontier_var))]
        if id_col.kind == OBJ:
            raise GraphIndexError("host-object id column")
        pos, present = gi.compact_of(id_col, ctx)
        bucketed = bucketing.enabled()
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
                idx, n_out = J.mask_to_idx(keep)
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
        return self._assemble(
            gi, row, orig, swapped, far_rows, self.far_labels,
            self.rel_fld, self.far_fld, n_out,
        )


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


def plan_filter_fastpath(planner, op, child) -> Optional[RelationalOperator]:
    """Resolve a relationship-uniqueness filter over a fused subtree, so a
    count(*) keeps its whole-plan fusion:

    1. PROOF: ``_rel_uniqueness_redundant`` — equality would force a
       self-loop of a loop-free type set: drop the filter outright;
    2. ENFORCEMENT (``MultiwayIntersectOp`` only): drop the filter and
       clone the op with the pair in ``enforced_pairs``; its materializing
       path compares global element ids;
    3. otherwise keep the generic FilterOp plan (in-op enforcement over a
       ``CsrExpandOp`` chain is a later slice)."""
    from ...relational.ops import CacheOp
    from .wcoj import MultiwayIntersectOp

    pair = _rel_neq_pair(op.predicate)
    if pair is None:
        return None
    wraps = 0
    node = child
    while isinstance(node, CacheOp):
        node = node.children[0]
        wraps += 1
    if isinstance(node, MultiwayIntersectOp):
        # the multiway op enforces pairs by comparing GLOBAL element ids
        # (canonical rel scans / input id columns), so it needs no
        # same-type-set restriction
        rel_ends = node._rel_ends()
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
        out: RelationalOperator = node._with_pair(key, op.predicate)
        for _ in range(wraps):
            out = CacheOp(out)
        return out
    if not isinstance(node, CsrExpandOp):
        return None
    rel_ends = _chain_rel_ends(node._chain_hops())
    if rel_ends is None:
        return None
    key = tuple(sorted(pair))
    if not set(key) <= set(rel_ends):
        return None
    if _rel_uniqueness_redundant(
        rel_ends, key[0], key[1], node._graph_obj, node.context
    ):
        return child
    return None
