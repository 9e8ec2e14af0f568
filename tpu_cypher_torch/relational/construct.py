"""CONSTRUCT planning: build a new property graph from query bindings.

Re-design of the reference's ``ConstructGraphPlanner``
(``okapi-relational/.../impl/planning/ConstructGraphPlanner.scala:52-514``):

* CLONE keeps element identity (ids pass through unchanged); the reference
  retags cloned ids with a per-source-graph byte prefix (``computePrefixes
  :87``) because its ids are varint byte arrays — our ids are fixed-width
  int64 with the graph tag in the high bits (``Expr.PrefixId``), so clones
  simply keep their already-tagged ids.
* NEW elements get generated ids (``generateId :273`` — partitioned
  monotonic ids): here ``(row_index * n_new + j) | (NEW_ELEMENT_TAG << 54)``
  computed via the backend's ``with_row_index`` — a dense, device-friendly
  id assignment with no host round-trip.
* The result is a ``ScanGraph`` over per-element tables extracted from the
  binding table (``extractScanGraph :291-360``); ``CONSTRUCT ON g1, g2``
  overlays the constructed scans on the base graphs WITHOUT retagging so new
  relationships can attach to base-graph nodes.
"""

from __future__ import annotations

from typing import Dict, List, Optional as Opt, Tuple

from ..api import types as T
from ..api.mapping import NodeMapping, RelationshipMapping
from ..ir import expr as E
from .graphs import ElementTable, EmptyGraph, OverlayGraph, ScanGraph
from .header import RecordHeader, _sanitize
from .ops import RelationalError, TableOp

# Reserved graph tag for CONSTRUCT-created elements; member graphs of a
# UnionGraph are tagged 1..510, so new elements never collide with clones.
NEW_ELEMENT_TAG = 511

# Distinct CONSTRUCT invocations get disjoint id ranges: bits 40..53 hold a
# per-process construct sequence number, bits 0..39 the per-row element index
# (the analog of the reference's partitioned monotonic id generation,
# ``ConstructGraphPlanner.generateId :273``).
_CONSTRUCT_SEQ = __import__("itertools").count()
_SEQ_SHIFT = 40
_SEQ_LIMIT = 1 << 14


def plan_construct(planner, op):
    blk = op.construct
    ctx = planner.ctx
    in_plan = planner.process(op.in_op)
    header = in_plan.header
    table = in_plan.table
    params = ctx.parameters

    env = {v.name for v in header.vars}

    new_nodes: Dict[str, T.CypherType] = {
        n: t for n, t in blk.new_pattern.node_types.items() if n not in env
    }
    new_rels: Dict[str, T.CypherType] = dict(blk.new_pattern.rel_types)

    # explicit CLONE items plus builder-derived implicit clones (bound vars
    # referenced in NEW patterns — ir/builder._convert_construct)
    clones: Dict[str, str] = {new: src for new, src in blk.clones}

    # COPY OF (reference: ConstructedElement.baseElement,
    # ``ConstructGraphPlanner.computeNodeProjections :199-218`` /
    # ``computeRelationshipProjections :243-258``): the new element gets a
    # GENERATED id but inherits the base element's label/type and property
    # columns from the binding table; explicit labels/type and SET items
    # layer on top. A base may be a binding var or a CLONE alias.
    base_entities: Dict[str, str] = dict(blk.new_pattern.base_entities)
    for name, base in base_entities.items():
        if base not in env and base not in clones:
            raise RelationalError(
                f"COPY OF references unbound variable {base!r}"
            )
        if name in env:
            raise RelationalError(
                f"COPY OF target {name!r} is already bound; use CLONE to "
                "keep element identity"
            )

    for conn in blk.new_pattern.topology.values():
        for endpoint in (conn.source, conn.target):
            if endpoint not in new_nodes and endpoint not in clones:
                raise RelationalError(
                    f"CONSTRUCT references unbound variable {endpoint!r}"
                )

    # SET/property-map items grouped per constructed element (last one wins)
    prop_exprs: Dict[Tuple[str, str], E.Expr] = {}
    for owner, key, expr in tuple(blk.new_properties) + tuple(blk.sets):
        prop_exprs[(owner, key)] = expr
    extra_labels: Dict[str, set] = {}
    for owner, labels in blk.set_labels:
        extra_labels.setdefault(owner, set()).update(labels)

    # extend the header with clone/copy aliases so SET exprs naming the
    # alias resolve to the source binding's columns
    hdr = header
    for new, src in clones.items():
        if new != src and src in env:
            sv = hdr.var(src)
            hdr = hdr.with_alias(E.Var(new).with_type(sv.typ), sv)
    for name, base in base_entities.items():
        bv = hdr.var(base)
        hdr = hdr.with_alias(E.Var(name).with_type(bv.typ), bv)

    # ------------------------------------------------------------------
    # 1. compute all derived columns over the binding table in one pass
    # ------------------------------------------------------------------
    new_names = list(new_nodes) + list(new_rels)
    work = table
    id_cols: Dict[str, str] = {}
    items: List[Tuple[E.Expr, str]] = []
    if new_names:
        row_col = "__construct_row"
        work = work.with_row_index(row_col)
        row_var = E.Var(row_col).with_type(T.CTInteger)
        hdr = hdr.with_expr(row_var, row_col)
        n_new = len(new_names)
        seq = next(_CONSTRUCT_SEQ) % _SEQ_LIMIT
        seq_base = seq << _SEQ_SHIFT
        for j, name in enumerate(new_names):
            raw = E.Add(
                E.Multiply(row_var, E.Lit(n_new).with_type(T.CTInteger)).with_type(
                    T.CTInteger
                ),
                E.Lit(seq_base + j).with_type(T.CTInteger),
            ).with_type(T.CTInteger)
            col = f"__construct_{_sanitize(name)}_id"
            items.append(
                (E.PrefixId(raw, NEW_ELEMENT_TAG).with_type(T.CTInteger), col)
            )
            id_cols[name] = col

    prop_cols: Dict[Tuple[str, str], str] = {}
    for (owner, key), expr in prop_exprs.items():
        col = f"__construct_{_sanitize(owner)}_prop_{_sanitize(key)}"
        items.append((expr, col))
        prop_cols[(owner, key)] = col

    if items:
        work = work.with_columns(items, hdr, params)

    # ------------------------------------------------------------------
    # 2. per-element tables
    # ------------------------------------------------------------------
    tables: List[ElementTable] = []

    def props_for(owner: str, base: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        out = dict(base)
        for (o, key), col in prop_cols.items():
            if o == owner:
                out[key] = col
        return tuple(sorted(out.items()))

    for name, ct in new_nodes.items():
        labels = set(ct.material.labels) | extra_labels.get(name, set())
        if name in base_entities:
            # COPY OF: new generated id, base labels + properties inherited
            # (reference ConstructGraphPlanner.computeNodeProjections :199-218)
            base = base_entities[name]
            if not isinstance(hdr.var(base).typ.material, T.CTNodeType):
                raise RelationalError(f"COPY OF base {base!r} is not a node")
            tables.append(
                _clone_node_table(
                    work, hdr, name, base, labels, props_for, params,
                    id_col=id_cols[name],
                )
            )
            continue
        prop_map = props_for(name, {})
        cols = [id_cols[name]] + [c for _, c in prop_map]
        mapping = NodeMapping(
            id_key=id_cols[name],
            implied_labels=frozenset(labels),
            property_mapping=prop_map,
        )
        tables.append(ElementTable(mapping, work.select(cols)))

    # one table group per CLONE var: two clone vars may bind the SAME element
    # (same id), and clones keep identity — the overlay assembly below dedups
    # per id across groups (reference extractScanGraph distinct=true scans)
    clone_groups: List[List[ElementTable]] = []
    for new, src in clones.items():
        v = hdr.var(src)
        m = v.typ.material
        if isinstance(m, T.CTNodeType):
            clone_groups.append(
                [
                    _clone_node_table(
                        work, hdr, new, src, extra_labels.get(new, set()),
                        props_for, params,
                    )
                ]
            )
        elif isinstance(m, T.CTRelationshipType):
            clone_groups.append(
                _clone_rel_tables(work, hdr, new, src, props_for, params)
            )
        else:
            raise RelationalError(f"Cannot CLONE non-element variable {src!r}")

    for name, ct in new_rels.items():
        conn = blk.new_pattern.topology.get(name)
        if conn is None:
            raise RelationalError(f"New relationship {name!r} has no topology")
        m = ct.material
        types = sorted(m.types)

        def endpoint_col(ep: str) -> str:
            if ep in id_cols:
                return id_cols[ep]
            v = hdr.var(ep)
            return hdr.column(hdr.id_expr(v))

        def endpoint_guard(t, ep: str):
            # a rel must not dangle: rows whose endpoint element was not
            # constructed (null base under OPTIONAL MATCH) emit no rel row
            if ep in base_entities:
                return _non_null_base(t, hdr, hdr.var(base_entities[ep]), params)
            if ep in new_nodes:
                return t  # generated id, never null
            return _non_null_base(t, hdr, hdr.var(ep), params)

        src_col = endpoint_col(conn.source)
        dst_col = endpoint_col(conn.target)
        rel_work = endpoint_guard(endpoint_guard(work, conn.source), conn.target)

        if name in base_entities:
            # COPY OF: new generated id, endpoints from the NEW pattern's
            # topology, properties (and, absent an explicit type, the rel
            # type) from the base relationship's binding columns (reference
            # computeRelationshipProjections :243-258)
            base = base_entities[name]
            if not isinstance(hdr.var(base).typ.material, T.CTRelationshipType):
                raise RelationalError(
                    f"COPY OF base {base!r} is not a relationship"
                )
            tables.extend(
                _clone_rel_tables(
                    rel_work, hdr, name, base, props_for, params,
                    id_col=id_cols[name], src_col=src_col, dst_col=dst_col,
                    explicit_types=types,
                )
            )
            continue

        if len(types) != 1:
            raise RelationalError(
                f"New relationship {name!r} must have exactly one type, got {types}"
            )
        prop_map = props_for(name, {})
        mapping = RelationshipMapping(
            id_key=id_cols[name],
            source_key=src_col,
            target_key=dst_col,
            rel_type=types[0],
            property_mapping=prop_map,
        )
        cols = list(
            dict.fromkeys([id_cols[name], src_col, dst_col] + [c for _, c in prop_map])
        )
        tables.append(ElementTable(mapping, rel_work.select(cols)))

    # ------------------------------------------------------------------
    # 3. assemble the result graph
    # ------------------------------------------------------------------
    parts: List = []
    if tables:
        parts.append(ScanGraph(tables))
    parts.extend(ScanGraph(g) for g in clone_groups)
    if not parts:
        constructed = EmptyGraph()
    elif len(parts) == 1:
        constructed = parts[0]
    else:
        constructed = OverlayGraph(parts)
    members = [ctx.resolve_graph(q) for q in blk.on_graphs]
    # constructed first: OverlayGraph dedups per element id keeping the FIRST
    # occurrence, so a CLONE ... SET row supersedes the base graph's row
    graph = OverlayGraph([constructed] + members) if members else constructed
    planner.constructed_graphs[op.new_graph_name] = graph
    return TableOp(graph, ctx, RecordHeader(), ctx.table_cls.unit())


def _non_null_base(work, hdr: RecordHeader, v: E.Var, params):
    """Rows whose base element is null (OPTIONAL MATCH) construct nothing."""
    pred = E.IsNotNull(hdr.id_expr(v)).with_type(T.CTBoolean)
    return work.filter(pred, hdr, params)


def _clone_node_table(
    work,
    hdr: RecordHeader,
    new: str,
    src: str,
    implied_labels,
    props_for,
    params,
    id_col: Opt[str] = None,
) -> ElementTable:
    """Node table for CLONE (``id_col=None``: base identity kept, rows
    deduplicated) or COPY OF (``id_col`` = generated per-row id, one new
    element per binding row). Base labels ride along as optional label
    columns; ``implied_labels`` (explicit pattern + SET labels) apply to
    every row."""
    v = hdr.var(src)
    work = _non_null_base(work, hdr, v, params)
    key = id_col or hdr.column(hdr.id_expr(v))
    implied = frozenset(implied_labels)
    opt_labels: List[Tuple[str, str]] = [
        (e.label, hdr.column(e))
        for e in hdr.labels_for(v)
        if e.label not in implied
    ]
    prop_map = props_for(new, {e.key: hdr.column(e) for e in hdr.properties_for(v)})
    cols = list(
        dict.fromkeys(
            [key] + [c for _, c in opt_labels] + [c for _, c in prop_map]
        )
    )
    mapping = NodeMapping(
        id_key=key,
        implied_labels=implied,
        optional_labels=tuple(opt_labels),
        property_mapping=prop_map,
    )
    t = work.select(cols)
    return ElementTable(mapping, t.distinct() if id_col is None else t)


def _clone_rel_tables(
    work,
    hdr: RecordHeader,
    new: str,
    src: str,
    props_for,
    params,
    id_col: Opt[str] = None,
    src_col: Opt[str] = None,
    dst_col: Opt[str] = None,
    explicit_types: Tuple[str, ...] = (),
) -> List[ElementTable]:
    """Relationship tables for CLONE (``id_col=None``: base identity +
    endpoints kept, rows deduplicated) or COPY OF (generated id, endpoints
    from the NEW pattern's topology). The rel type is ``explicit_types[0]``
    when exactly one was written; otherwise it is resolved from the base
    binding's type columns, one table per possible type."""
    v = hdr.var(src)
    work = _non_null_base(work, hdr, v, params)
    key = id_col or hdr.column(hdr.id_expr(v))
    if src_col is None or dst_col is None:
        start_e = next(e for e in hdr.expressions_for(v) if isinstance(e, E.StartNode))
        end_e = next(e for e in hdr.expressions_for(v) if isinstance(e, E.EndNode))
        src_col, dst_col = hdr.column(start_e), hdr.column(end_e)
    prop_map = props_for(new, {e.key: hdr.column(e) for e in hdr.properties_for(v)})
    cols = list(
        dict.fromkeys([key, src_col, dst_col] + [c for _, c in prop_map])
    )
    if len(explicit_types) > 1:
        raise RelationalError(
            f"New relationship {new!r} must have exactly one type, "
            f"got {sorted(explicit_types)}"
        )
    if len(explicit_types) == 1:
        variants: List[Tuple[Opt[E.Expr], str]] = [(None, explicit_types[0])]
    else:
        type_exprs = hdr.types_for(v)
        if type_exprs:
            variants = [(e, e.rel_type) for e in type_exprs]
        else:
            base_types = sorted(v.typ.material.types)
            if len(base_types) != 1:
                raise RelationalError(
                    f"Cannot determine type of cloned rel {src!r}"
                )
            variants = [(None, base_types[0])]
    out: List[ElementTable] = []
    for te, rel_type in variants:
        t = work
        if te is not None and len(variants) > 1:
            t = t.filter(te, hdr, params)
        mapping = RelationshipMapping(
            id_key=key,
            source_key=src_col,
            target_key=dst_col,
            rel_type=rel_type,
            property_mapping=prop_map,
        )
        sel = t.select(cols)
        out.append(ElementTable(mapping, sel.distinct() if id_col is None else sel))
    return out
