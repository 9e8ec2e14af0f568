"""Worst-case-optimal multiway join: leapfrog intersection on sorted CSR.

The port of ``tpu_cypher/backend/tpu/wcoj.py``. Closing a cycle over a
k-hop chain with binary joins first materializes the whole k-hop row set
(at SF10 the triangle's 2-hop intermediate alone is ~2*10^8 rows). The
multiway intersection bounds the work by the smallest adjacency list
instead: the candidate ``c`` must lie in the intersection of K adjacency
lists, each anchored at a variable already bound per input row —

* the PIVOT list: the peeled top expand ``(b)-[r]->(c)`` — candidates are
  ``N(b)`` with pivot-edge multiplicity;
* one CLOSE list per cycle-closing relationship ``(a)-[q]->(c)`` (or
  ``(c)-[q]->(a)``): membership and multiplicity by range counts over the
  sorted ``anchor*N + candidate`` edge keys (``GraphIndex.edge_keys``).

Each input row iterates its MINIMUM-degree list and range-counts the
others, so the expanded lanes total sum(min_k deg_k). The lanes come from
the ``expand_rows`` kernel and the range counts from the ``intersect``
kernel (``hopper/``). A materialize keeps one run level per close
(``factorized.py``): the output stays a ``FactorizedTable`` where
``optimizer.cost.prefer_factorized`` routes it (tier ``factorized``),
else it is decoded at the output extent (tier ``materialize``). Bag
semantics match the classic cascade by construction: one output row per
(input row, pivot edge, close-edge combination), candidate label masks
applied once. Relationship uniqueness rides ``enforced_pairs``: provably
redundant pairs are dropped by ``plan_filter_fastpath``; the rest are
enforced on the materializing path by comparing global element ids.

Differences by design from the reference (ROADMAP.md queue 3):

* the sharded range-count tier (``_mesh_range_counter``) reads the
  sorted ``edge_keys`` in contiguous, possibly uneven slices with no
  sentinel pad keys (``GraphIndex.edge_key_shards``), where the
  reference needs a shard-divisible key list;
* one materialize for one close or several: a flat output decodes the
  runs at the output extent on the ``expand_rows`` gate
  (``factorized.decode_lanes``). The reference repeats a single close's
  lanes by their counts (``into_materialize_counted``) and, under
  ``TPU_CYPHER_FACTORIZE=off``, declines a multi-close materialize to its
  classic shadow cascade;
* a pure count of one close is handed back to the binary plan, as in the
  reference, only where the dense count tier is live
  (``expand_op._mxu_dense_mode``: on the card under ``auto``) and the
  graph is within its 16,384-node cap: the dense products count the
  blowup without building it (tier ``handback``). The reference also
  hands back on the CPU, to its native stamping kernels, which the
  port's operators do not call. The binary plan it hands back to is the
  fused ``CsrExpandIntoOp`` attached as ``children[1]`` where the hook
  routes (the reference's ``shadow_plan``); ``relational/prune.py``
  gives it this operator's columns;
* ``auto`` routes as the reference does: only where the binary plan's
  blowup estimate (``_est_binary_blowup``: edges times the pivot
  orientation's max degree) passes ``optimizer.cost.prefer_wcoj``, so
  small graphs keep the binary plan, ``CsrExpandIntoOp``'s fused close
  count. ``force`` routes every structural fit;
* no bucket lattice: the lanes are sized exactly whatever
  ``TPU_CYPHER_BUCKET`` says (eager PyTorch compiles no program per
  shape for the lattice to save);
* no shadow: ``_compute_table`` catches nothing, so a ``GraphIndexError``
  reaches the caller. A shape the planner hook declines (``off`` mode, an
  undirected close) goes to ``expand_op.CsrExpandIntoOp``, the
  reference's binary plan; an empty graph, which that hook declines too,
  keeps the classic ``JoinOp`` plan, which answers through
  ``CudaTable.join``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ...ir import expr as E
from ...obs import trace as _obs_trace
from ...obs.metrics import REGISTRY as _OBS_REGISTRY
from ...obs.metrics import CounterView
from ...relational.ops import RelationalOperator
from ...obs.trace import sync as host_sync
from ...runtime.faults import fault_point
from ...utils import config as _config
from . import bucketing
from . import jit_ops as J
from .column import OBJ, Column, TpuBackendError
from .expand_op import (
    CsrExpandIntoOp,
    CsrExpandOp,
    _chain_rel_ends,
    _empty_i64,
    _FusedExpandBase,
    _owner_name,
)
from .table import CudaTable, ensure_flat
from .graph_index import (
    CANON_NODE,
    CANON_REL,
    GraphIndex,
    GraphIndexError,
    rekey_element_expr,
)

# which tier answered each multiway-intersect execution
WCOJ_TIER_COUNTS = CounterView(
    _OBS_REGISTRY.counter(
        "tpu_cypher_wcoj_tier_total",
        "multiway-intersect executions per resolved tier",
        labels=("tier",),
    ),
    "tier",
    ("count", "materialize", "factorized", "handback"),
)


class PivotSpec(NamedTuple):
    """The peeled top expand supplying candidate+multiplicity by CSR row."""

    frontier_fld: str
    rel_fld: str
    far_fld: str  # the candidate variable
    types_key: Tuple[str, ...]
    backwards: bool
    far_labels: Tuple[str, ...]


class CloseSpec(NamedTuple):
    """One cycle-closing relationship tested by sorted-key range count.
    ``rev=True`` means the closing edge runs candidate -> anchor (the
    membership probe uses the reverse-orientation edge keys)."""

    anchor_fld: str
    rel_fld: str
    types_key: Tuple[str, ...]
    rev: bool


class _ListSpec(NamedTuple):
    """One intersection list, fully resolved against the GraphIndex."""

    rp: Any
    ci: Any
    eo: Any
    keys: Any
    pos: Any
    ok: Any
    rel_fld: str
    types_key: Tuple[str, ...]
    rev: bool


_MESH_WCOJ_TOTAL = _OBS_REGISTRY.counter(
    "tpu_cypher_mesh_wcoj_total",
    "WCOJ count executions whose range probes ran on the sharded "
    "(per-shard intersect + combine) tier",
)


def _mesh_range_counter(gi: GraphIndex, ctx, lists):
    """The sharded range count for the WCOJ count tier, or None: with a
    mesh of more than one shard active, ``TPU_CYPHER_MESH_WCOJ`` at
    ``auto`` and every list's sorted ``edge_keys`` non-empty. Each shard
    counts its contiguous slice of the keys on the ``intersect`` gate
    (``GraphIndex.edge_key_shards``) and the per-query counts sum (see
    ``parallel.mesh.sharded_range_count``). Returns (count, each list's
    key slices, shard count)."""
    from ...parallel import mesh as PM

    mesh = PM.current_mesh()
    if mesh is None or mesh.size <= 1:
        return None
    if _config.MESH_WCOJ.get().strip().lower() != "auto":
        return None
    if any(int(lst.keys.shape[0]) == 0 for lst in lists):
        return None
    shards = [gi.edge_key_shards(lst.types_key, ctx, lst.rev, mesh) for lst in lists]
    return PM.sharded_range_count(mesh), shards, mesh.size


def _argmin_arm(degs: List[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Per-row index of the minimum-degree list (ties -> first, i.e. the
    pivot); rows with an absent anchor have degree 0 everywhere and never
    expand."""
    d = torch.stack(degs)
    big = torch.full((), 1 << 62, dtype=torch.int64, device=d.device)
    return torch.argmin(torch.where(valid[None, :], d, big), dim=0)


def _arm_degrees(deg, arm, a: int, valid):
    """Degrees restricted to rows whose minimum list is ``a``, and their
    total."""
    deg_a = torch.where((arm == a) & valid, deg, torch.zeros_like(deg))
    return deg_a, torch.sum(deg_a)


def _probe_queries(a_pos, a_ok, row, cand, live, n: int):
    """Sorted-key probes ``anchor*N + candidate`` for one searched list.
    Pad lanes (``live`` False, row/cand sanitized to 0) come out invalid, so
    their range counts are zeroed inside the range-count contract."""
    q = a_pos[row] * n + cand
    return q, a_ok[row] & live


def _apply_label_mask(m, mask, cand):
    return m * mask[cand].to(torch.int64)


def _zero_counts(m, keep):
    """Range counts with the lanes ``keep`` rejects zeroed: a uniqueness
    pair read at the lane domain folds into the run multiplicities."""
    return torch.where(keep, m, torch.zeros_like(m))


class MultiwayIntersectOp(_FusedExpandBase):
    """Relational operator: candidate = intersection of K adjacency lists.

    ``children = (in_plan, classic)`` like every fused op: ``in_plan`` is
    the PIVOT's input (it binds the pivot frontier and every close anchor),
    ``classic`` the ExpandInto join cascade with identical header."""

    def __init__(
        self,
        in_plan: RelationalOperator,
        classic: RelationalOperator,
        graph_obj,
        *,
        pivot: PivotSpec,
        closes: Tuple[CloseSpec, ...],
        enforced_pairs: Tuple[Tuple[str, str], ...] = (),
    ):
        super().__init__(in_plan, classic, graph_obj)
        self.pivot = pivot
        self.closes = closes
        self.enforced_pairs = enforced_pairs

    @property
    def candidate_fld(self) -> str:
        return self.pivot.far_fld

    def _ctor_kwargs(self) -> Dict[str, Any]:
        return dict(pivot=self.pivot, closes=self.closes)

    def _show_inner(self) -> str:
        p = self.pivot
        arrow = "<-" if p.backwards else "->"
        t = "|".join(p.types_key) or "*"
        parts = [f"({p.frontier_fld}){arrow}[{p.rel_fld}:{t}]({p.far_fld})"]
        for c in self.closes:
            ct = "|".join(c.types_key) or "*"
            ca = "<-" if c.rev else "->"
            parts.append(f"({c.anchor_fld}){ca}[{c.rel_fld}:{ct}](.)")
        uniq = (
            " uniq" + ",".join(f"({a}<>{b})" for a, b in self.enforced_pairs)
            if self.enforced_pairs
            else ""
        )
        return "wcoj " + " x ".join(parts) + uniq

    # -- uniqueness-proof support -----------------------------------------

    def _rel_ends(self) -> Optional[Dict[str, Tuple[str, str, Tuple[str, ...]]]]:
        """Per-rel GRAPH-direction endpoints over this op's whole fused
        subtree (input chain + pivot + closes) for the redundancy proof in
        ``plan_filter_fastpath``; None when orientation-ambiguous or a rel
        repeats. An unrecognized input contributes nothing — pairs naming
        its rels simply stay unproven."""
        from ...relational.ops import CacheOp

        in_op = self.children[0]
        while isinstance(in_op, CacheOp):
            in_op = in_op.children[0]
        if (
            isinstance(in_op, MultiwayIntersectOp)
            and in_op._graph_obj is self._graph_obj
        ):
            out = in_op._rel_ends()
        elif isinstance(in_op, CsrExpandOp) and in_op._graph_obj is self._graph_obj:
            out = _chain_rel_ends(in_op._chain_hops())
        else:
            out = {}
        if out is None:
            return None
        p = self.pivot
        ends = [
            (
                p.rel_fld,
                (p.far_fld, p.frontier_fld, p.types_key)
                if p.backwards
                else (p.frontier_fld, p.far_fld, p.types_key),
            )
        ]
        for c in self.closes:
            ends.append(
                (
                    c.rel_fld,
                    (p.far_fld, c.anchor_fld, c.types_key)
                    if c.rev
                    else (c.anchor_fld, p.far_fld, c.types_key),
                )
            )
        for r, v in ends:
            if r in out:
                return None
            out[r] = v
        return out

    # -- execution ---------------------------------------------------------

    def _anchor_flds(self) -> Tuple[str, ...]:
        return (self.pivot.frontier_fld,) + tuple(c.anchor_fld for c in self.closes)

    def _id_positions(self, gi: GraphIndex, ctx):
        """Compact positions + presence per anchor variable; ``valid`` is
        the all-anchors-present row mask (an absent anchor matches no edge,
        exactly the classic join's null semantics)."""
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        h = in_op.header
        out = []
        valid = None
        for f in self._anchor_flds():
            try:
                col = in_t._cols[h.column(h.id_expr(h.var(f)))]
            except (KeyError, ValueError) as exc:
                raise GraphIndexError(f"intersect anchor {f!r} unmapped") from exc
            pos, ok = gi.compact_of(col, ctx)
            out.append((pos, ok))
            valid = ok if valid is None else valid & ok
        return out, valid

    def _lists(self, gi: GraphIndex, ctx, positions) -> List[_ListSpec]:
        """The unified intersection lists: [0] = pivot, [1:] = closes. Each
        list's CSR orientation puts its ANCHOR on the row axis, and its edge
        keys sort by (anchor*N + candidate) in the same order — the one
        orientation serves both iteration and range counting."""
        p = self.pivot
        specs = [(p.types_key, p.backwards, p.rel_fld)] + [
            (c.types_key, c.rev, c.rel_fld) for c in self.closes
        ]
        out = []
        for (types_key, rev, rel_fld), (pos, ok) in zip(specs, positions):
            rp, ci, eo = gi.csr(types_key, rev, ctx)
            keys = gi.edge_keys(types_key, ctx, reverse=rev)
            out.append(_ListSpec(rp, ci, eo, keys, pos, ok, rel_fld, types_key, rev))
        return out

    def _count(self, gi: GraphIndex, ctx, lists, valid) -> int:
        """Pure count tier — the WCOJ hot path. Per arm: expand the rows
        whose minimum-degree list is that arm, range-count every other
        list, multiply, sum. No output materialize, no acyclic
        intermediate; expanded lanes total sum(min_k deg_k)."""
        from .hopper import expand_materialize_counted, intersect_range_count

        fault_point("expand")  # the per-arm count-tier syncs below

        mask = gi.label_mask(self.pivot.far_labels, ctx)
        degs = [J.expand_degrees_total(lst.rp, lst.pos, valid)[0] for lst in lists]
        arm = _argmin_arm(degs, valid)
        n = gi.num_nodes
        mesh_tier = _mesh_range_counter(gi, ctx, lists)
        if mesh_tier is not None:
            mesh_count, key_shards, nsh = mesh_tier
            _MESH_WCOJ_TOTAL.inc()
            _obs_trace.note("wcoj_shards", nsh)
        total = 0
        for a, lst in enumerate(lists):
            deg_a, t_dev = _arm_degrees(degs[a], arm, a, valid)
            with host_sync("expand"):
                n_a = int(t_dev)
            if n_a == 0:
                continue
            # lanes: row + cand (16B) and live (1B), no orig, plus one 8B
            # count per probe
            bucketing.admit(n_a, 17 + 8 * (len(lists) - 1), "intersect")
            # tpulint: allow[pad-invariant] reason=WCOJ lanes are sized exactly in every bucket mode (bucketing.exact_size): each lane is a probe the range count answers, and a pad lane would be one more probe
            row, cand, _, live = expand_materialize_counted(
                lst.rp, lst.ci, lst.eo, lst.pos, deg_a, n_a,
                size=bucketing.exact_size(n_a), with_orig=False,
            )
            m = None
            for b, other in enumerate(lists):
                if b == a:
                    continue
                q, qok = _probe_queries(other.pos, other.ok, row, cand, live, n)
                if mesh_tier is not None:
                    cnt = mesh_count(key_shards[b], q, qok)
                else:
                    _, cnt, _ = intersect_range_count(other.keys, q, qok)
                m = cnt if m is None else m * cnt
            if mask is not None:
                m = _apply_label_mask(m, mask, cand)
            m_total = torch.sum(m)
            with host_sync("expand_count"):
                total += int(m_total)
        return total

    def _materialize(self, gi: GraphIndex, ctx, lists, valid):
        """Materializing tier (row-producing headers and/or uniqueness
        enforcement), for one close or several, through the run-compressed
        form: iterate the pivot, range-count each close, and keep one
        suffix level per close, the lane weights the products of the
        lanes' range counts. The output stays a ``FactorizedTable`` where
        ``optimizer.cost.prefer_factorized`` routes it; else the decode
        walks the runs at the output extent (``factorized.decode_lanes``,
        on the ``expand_rows`` gate), so a close-edge orig is
        ``eo[lo + k]`` and the flat product of several closes never exists
        on the device."""
        from ...optimizer.cost import prefer_factorized
        from .factorized import decode_lanes
        from .hopper import expand_materialize_counted, intersect_range_count

        fault_point("expand")  # the lane and output totals read below
        pivot, closes = lists[0], lists[1:]
        n = gi.num_nodes
        mask = gi.label_mask(self.pivot.far_labels, ctx)
        nexprs = max(len(self.header.expressions), 1)
        deg, t_dev = J.expand_degrees_total(pivot.rp, pivot.pos, valid)
        with host_sync("expand"):
            total = int(t_dev)
        bucketing.admit(total, 24 + 16 * len(closes), "intersect")
        if total == 0:  # nothing to probe: no gate call
            return self._materialize_empty(gi, ctx)
        # tpulint: allow[pad-invariant] reason=WCOJ lanes are sized exactly in every bucket mode (bucketing.exact_size): the materialize's lanes are its output rows
        row, cand, orig_p, live = expand_materialize_counted(
            pivot.rp, pivot.ci, pivot.eo, pivot.pos, deg, total,
            size=bucketing.exact_size(total),
        )
        los, cnts = [], []
        for j, close in enumerate(closes):
            # the probes die with the call: lane state is the memory here
            lo_j, m_j, _ = intersect_range_count(
                close.keys, *_probe_queries(close.pos, close.ok, row, cand, live, n)
            )
            if j == 0 and mask is not None:
                m_j = _apply_label_mask(m_j, mask, cand)
            los.append(lo_j)
            cnts.append(m_j)
        pair_flds = {r for pr in self.enforced_pairs for r in pr}
        pairs_on_close = bool(pair_flds & {c.rel_fld for c in self.closes})
        if self.enforced_pairs and not pairs_on_close:
            fault_point("compact")
            cnts[0] = _zero_counts(cnts[0], self._wcoj_pair_keep(gi, ctx, row, orig_p, {}))
        w, W, tot = J.runs_weights(tuple(cnts), total)
        with host_sync("expand_runs"):
            n_out = int(tot)
        if (
            self.header.expressions
            and not pairs_on_close
            and prefer_factorized(n_out, 32 + 9 * nexprs)
        ):
            fact = self._factorized_assemble(
                gi, ctx, closes, row, cand, orig_p, total, tuple(los), tuple(cnts), n_out
            )
            if fact is not None:
                return fact
        if not self.header.expressions and not (self.enforced_pairs and pairs_on_close):
            return CudaTable({}, n_out)  # the weights are the count
        # flat through the runs: positions decoded at the output extent
        bucketing.admit(n_out, 32 + 9 * nexprs, "intersect")
        if n_out == 0:
            return self._materialize_empty(gi, ctx)
        i, inner = decode_lanes(W, w, 0, n_out)
        pos = J.run_positions(i, inner, tuple(los), tuple(cnts))
        in_row, cand2, orig_p2 = J.tree_take((row, cand, orig_p), i)
        orig_cs = {c.rel_fld: lst.eo[p_j] for c, lst, p_j in zip(self.closes, closes, pos)}
        if self.enforced_pairs and pairs_on_close:
            fault_point("compact")
            keep = self._wcoj_pair_keep(gi, ctx, in_row, orig_p2, orig_cs)
            kept = J.mask_sum(keep)
            with host_sync("compact"):
                n2 = int(kept)
            if n2 != n_out:
                # tpulint: allow[pad-invariant] reason=exact compact of the uniqueness-filtered close rows: callers take every returned row as live
                idx = J.mask_nonzero(keep, size=n2)
                in_row, cand2, orig_p2 = J.tree_take((in_row, cand2, orig_p2), idx)
                orig_cs = {r: o[idx] for r, o in orig_cs.items()}
                n_out = n2
        if not self.header.expressions:
            return CudaTable({}, n_out)
        _, _, row_map = gi.node_scan(self.pivot.far_labels, ctx)
        far_rows, _ = J.far_lookup(row_map, cand2)
        return self._assemble_multi(gi, ctx, in_row, orig_p2, orig_cs, far_rows, n_out)

    def _materialize_empty(self, gi: GraphIndex, ctx):
        """The materialize's output with no row."""
        if not self.header.expressions:
            return CudaTable({}, 0)
        z = _empty_i64()
        return self._assemble_multi(
            gi, ctx, z, z, {c.rel_fld: z for c in self.closes}, z, 0
        )

    def _factorized_assemble(
        self, gi: GraphIndex, ctx, closes, row, cand, orig_p, total, los, cnts, n_out: int
    ):
        """The materialize's output in factorized form: the prefix is the
        pivot expansion's lane table (input columns at ``row``, the pivot
        rel at ``orig_p``, candidate node columns at its node-scan row),
        one suffix level per close, whose columns decode through the
        ``eo[pos]`` gather-map chain when rows are read. Admission pays for
        lanes, never the flat product. None when a close rel's column
        cannot ride the decode (a host column or an empty rel scan): the
        caller keeps the flat path."""
        from .factorized import FactorizedTable, RunLevel, note_factorized
        p = self.pivot
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        relp_cols, relp_header = gi.rel_scan(p.types_key, ctx)
        node_cols, node_header, row_map = gi.node_scan(p.far_labels, ctx)
        canon_rel = E.Var(CANON_REL)
        canon_node = E.Var(CANON_NODE)
        close_index = {c.rel_fld: j for j, c in enumerate(self.closes)}
        plan: Dict[str, Tuple[Column, str]] = {}
        level_plans: Tuple[Dict[str, Column], ...] = tuple({} for _ in closes)
        for e in self.header.expressions:
            col = self.header.column(e)
            if col in plan or any(col in lp for lp in level_plans):
                continue
            if e in in_op.header:
                plan[col] = (in_t._cols[in_op.header.column(e)], "row")
                continue
            owner = _owner_name(e)
            if owner == p.rel_fld or owner in close_index:
                key = rekey_element_expr(e, canon_rel)
                if owner == p.rel_fld:
                    cc, hh = relp_cols, relp_header
                else:
                    cc, hh = gi.rel_scan(self.closes[close_index[owner]].types_key, ctx)
                if key is None or key not in hh:
                    raise GraphIndexError(f"unmapped rel expr {e!r}")
                src = cc[hh.column(key)]
                if owner == p.rel_fld:
                    plan[col] = (src, "origp")
                    continue
                if src.kind == OBJ or len(src) == 0:
                    return None
                level_plans[close_index[owner]][col] = src
                continue
            if owner == p.far_fld:
                key = rekey_element_expr(e, canon_node)
                if key is None or key not in node_header:
                    raise GraphIndexError(f"unmapped node expr {e!r}")
                plan[col] = (node_cols[node_header.column(key)], "far")
                continue
            raise GraphIndexError(f"unmapped expr {e!r}")
        # a candidate without the far labels has weight 0; its lane reads
        # node-scan row 0 and is never decoded
        far_rows = torch.clamp(J.far_lookup(row_map, cand)[0], min=0)
        bucketing.admit(total, 9 * max(len(plan), 1), "factorized")
        pfx_cols = self._gather_plan(plan, {"row": row, "origp": orig_p, "far": far_rows})
        levels = [
            RunLevel(lo_j, m_j, {c: (src, (lst.eo,)) for c, src in lp.items()})
            for lo_j, m_j, lst, lp in zip(los, cnts, closes, level_plans)
        ]
        out = FactorizedTable(CudaTable(pfx_cols, total), levels, nrows=n_out)
        note_factorized(n_out, int(row.shape[0]), total)
        return out

    def _wcoj_pair_keep(self, gi: GraphIndex, ctx, row, orig_p, orig_cs):
        """Row-keep mask for enforced uniqueness pairs: the pivot rel reads
        its canonical rel-scan id at ``orig_p``, a close rel its scan at
        ``orig_cs[rel]``, any other rel its input-table id column at
        ``row`` — element ids are global, so cross-type comparisons stay
        sound."""
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        p = self.pivot
        close_types = {c.rel_fld: c.types_key for c in self.closes}
        cache: Dict[str, Any] = {}

        def ids_of(r):
            if r in cache:
                return cache[r]
            if r == p.rel_fld or r in orig_cs:
                types_key = p.types_key if r == p.rel_fld else close_types[r]
                orig = orig_p if r == p.rel_fld else orig_cs[r]
                cols, hh = gi.rel_scan(types_key, ctx)
                cid = hh.id_expr(hh.var(CANON_REL))
                out = cols[hh.column(cid)].data[orig]
            else:
                h = in_op.header
                try:
                    col = in_t._cols[h.column(h.id_expr(h.var(r)))]
                except (KeyError, ValueError) as exc:
                    raise GraphIndexError(f"uniqueness rel {r!r} unmapped") from exc
                out = col.data[row]
            cache[r] = out
            return out

        keep = None
        for ra, rb in self.enforced_pairs:
            k = ids_of(ra) != ids_of(rb)
            keep = k if keep is None else keep & k
        return keep

    def _assemble_multi(self, gi: GraphIndex, ctx, row, orig_p, orig_cs,
                        far_rows, n_out: int):
        """Column assembly with one rel source per fused rel: input
        pass-through at ``row``, pivot rel at ``orig_p``, close rel ``r`` at
        ``orig_cs[r]``, candidate node columns at ``far_rows``."""
        in_op = self.children[0]
        in_t = ensure_flat(in_op.table)
        p = self.pivot
        relp_cols, relp_header = gi.rel_scan(p.types_key, ctx)
        close_scans = {
            c.rel_fld: gi.rel_scan(c.types_key, ctx)
            for c in self.closes
            if c.rel_fld in orig_cs
        }
        node_cols, node_header, _ = gi.node_scan(p.far_labels, ctx)
        canon_rel = E.Var(CANON_REL)
        canon_node = E.Var(CANON_NODE)
        tags = {r: f"origc{j}" for j, r in enumerate(orig_cs)}
        plan: Dict[str, Tuple[Column, str]] = {}
        for e in self.header.expressions:
            col = self.header.column(e)
            if col in plan:
                continue
            if e in in_op.header:
                plan[col] = (in_t._cols[in_op.header.column(e)], "row")
                continue
            owner = _owner_name(e)
            if owner == p.rel_fld or owner in close_scans:
                key = rekey_element_expr(e, canon_rel)
                if owner == p.rel_fld:
                    cc, hh, tag = relp_cols, relp_header, "origp"
                else:
                    cc, hh = close_scans[owner]
                    tag = tags[owner]
                if key is None or key not in hh:
                    raise GraphIndexError(f"unmapped rel expr {e!r}")
                plan[col] = (cc[hh.column(key)], tag)
                continue
            if owner == p.far_fld:
                key = rekey_element_expr(e, canon_node)
                if key is None or key not in node_header:
                    raise GraphIndexError(f"unmapped node expr {e!r}")
                plan[col] = (node_cols[node_header.column(key)], "far")
                continue
            raise GraphIndexError(f"unmapped expr {e!r}")
        idx_by_tag = {"row": row, "origp": orig_p, "far": far_rows}
        for r, tag in tags.items():
            idx_by_tag[tag] = orig_cs[r]
        return CudaTable(self._gather_plan(plan, idx_by_tag), n_out)

    def _fused_table(self):
        fault_point("expand")
        gi = GraphIndex.of(self.graph)
        ctx = self.context
        gi.node_ids(ctx)
        if gi.num_nodes == 0:
            raise GraphIndexError("empty node space")
        if gi.num_nodes >= (1 << 30):
            raise GraphIndexError("intersect keys need pos*N+cand in int64")
        if (
            not self.header.expressions
            and not self.enforced_pairs
            and len(self.closes) == 1
            and isinstance(self.children[1], CsrExpandIntoOp)
            and _config.WCOJ_MODE.get().strip().lower() != "force"
            and _fused_binary_count_available(gi)
        ):
            # WCOJ's edge is avoiding the materialized intermediate; the
            # dense count tier never builds it either, and its products
            # beat the lanes' probes. ``force`` keeps the WCOJ count, and
            # a multi-close count stays here (the binary tiers count one
            # close)
            WCOJ_TIER_COUNTS.inc("handback")
            _obs_trace.note("wcoj_tier", "handback")
            return self.children[1].table
        positions, valid = self._id_positions(gi, ctx)
        lists = self._lists(gi, ctx, positions)
        if not self.header.expressions and not self.enforced_pairs:
            WCOJ_TIER_COUNTS.inc("count")
            _obs_trace.note("wcoj_tier", "count")
            return CudaTable({}, self._count(gi, ctx, lists, valid))
        from .factorized import FactorizedTable

        out = self._materialize(gi, ctx, lists, valid)
        tier = "factorized" if isinstance(out, FactorizedTable) else "materialize"
        WCOJ_TIER_COUNTS.inc(tier)
        _obs_trace.note("wcoj_tier", tier)
        return out


# ---------------------------------------------------------------------------
# Planner hook (installed via CudaTable.plan_multiway_intersect_fastpath)
# ---------------------------------------------------------------------------


def _fused_binary_count_available(gi: GraphIndex) -> bool:
    """Will the binary plan count a single cycle close on the dense tier,
    without materializing the intermediate? Where that tier is live and
    the graph is within the dense form's default cap (16,384 nodes, the
    reference's constant)."""
    from .expand_op import _mxu_dense_mode

    return _mxu_dense_mode() and 0 < gi.num_nodes <= 16384


def _est_binary_blowup(gi: GraphIndex, ctx, types_key, rev: bool) -> int:
    """Upper bound on the binary plan's intermediate when it closes a cycle
    over the pivot: edges(pivot types) * max degree(pivot orientation),
    since each frontier row can expand by up to the max degree before the
    close filters. Both factors are host-cached on the graph index."""
    max_deg, edges = gi.csr_degree_stats(types_key, rev, ctx)
    return edges * max(max_deg, 1)


def plan_multiway_intersect_fastpath(
    planner, op, in_plan, classic
) -> Optional[RelationalOperator]:
    """Route a cycle-closing ExpandInto to ``MultiwayIntersectOp``.

    The planner only calls this when its cycle detection fired; this hook
    adds the backend half of the rule: structural fit (a directed fused
    expand to peel as the pivot, or an existing multiway op to extend with
    one more close) plus, in ``auto`` mode, the blowup estimate against
    the cost model's threshold: small graphs keep the binary plan.
    ``TPU_CYPHER_WCOJ=force`` routes every structural fit, ``off``
    disables routing. A declined shape keeps ``classic``."""
    from ...relational.ops import CacheOp
    from ...utils.config import WCOJ_MODE

    mode = WCOJ_MODE.get().strip().lower()
    if mode not in ("auto", "force"):
        return None
    if op.direction != ">":
        return None
    in_vars = {v.name for v in in_plan.header.vars}
    if op.rel in in_vars or op.source not in in_vars or op.target not in in_vars:
        return None
    if op.source == op.target:
        return None
    node = in_plan
    while isinstance(node, CacheOp):
        node = node.children[0]
    types = getattr(op.rel_type.material, "types", frozenset()) or frozenset()
    types_key = GraphIndex.types_key(types)

    if isinstance(node, MultiwayIntersectOp):
        # extend: one more close constraint on the same candidate
        # (4-cliques and denser); eligibility was decided when the base op
        # routed
        cand = node.candidate_fld
        if cand not in (op.source, op.target):
            return None
        anchor = op.target if cand == op.source else op.source
        rel_names = {node.pivot.rel_fld} | {c.rel_fld for c in node.closes}
        if op.rel in rel_names or anchor == cand:
            return None
        if anchor not in {v.name for v in node.children[0].header.vars}:
            return None
        close = CloseSpec(anchor, op.rel, types_key, rev=cand == op.source)
        return MultiwayIntersectOp(
            node.children[0],
            classic,
            node._graph_obj,
            pivot=node.pivot,
            closes=node.closes + (close,),
            enforced_pairs=node.enforced_pairs,
        )

    if not isinstance(node, CsrExpandOp) or node.undirected:
        return None
    cand = node.far_fld
    if cand not in (op.source, op.target):
        return None
    anchor = op.target if cand == op.source else op.source
    if anchor == cand or op.rel == node.rel_fld:
        return None
    if anchor not in {v.name for v in node.children[0].header.vars}:
        return None
    graph_obj = node._graph_obj
    try:
        gi = GraphIndex.of(graph_obj)
        ctx = in_plan.context
        gi.node_ids(ctx)
        if gi.num_nodes == 0 or gi.num_nodes >= (1 << 30):
            return None
        if mode == "auto":
            from ...optimizer.cost import prefer_wcoj

            est = _est_binary_blowup(gi, ctx, node.types_key, node.backwards)
            if not prefer_wcoj(est, graph_obj, ctx):
                return None
    except (GraphIndexError, TpuBackendError):
        return None
    pivot = PivotSpec(
        node.frontier_fld,
        node.rel_fld,
        node.far_fld,
        node.types_key,
        node.backwards,
        node.far_labels,
    )
    close = CloseSpec(anchor, op.rel, types_key, rev=cand == op.source)
    # the binary plan a pure count is handed back to: the fused close
    # count, which ``off`` would plan (the reference's ``shadow_plan``)
    from .expand_op import plan_expand_into_fastpath

    binary = plan_expand_into_fastpath(planner, op, in_plan, classic)
    return MultiwayIntersectOp(
        node.children[0],
        classic if binary is None else binary,
        graph_obj,
        pivot=pivot,
        closes=(close,),
        enforced_pairs=node.enforced_pairs,
    )
