"""RecordHeader: the bridge between expressions and physical columns.

Re-design of the reference's ``RecordHeader``
(``okapi-relational/.../impl/table/RecordHeader.scala:68-455``): an immutable
``Map[Expr -> column name]`` tracking, per element variable, its ``Id``,
``HasLabel``/``HasType``, ``StartNode``/``EndNode`` and ``Property`` columns;
aliases share columns (``withAlias``); conflict-free deterministic column
naming with character sanitization.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from ..api import types as T
from ..api.schema import PropertyGraphSchema
from ..api.types import CypherType
from ..ir import expr as E

_SAFE = re.compile(r"[^A-Za-z0-9_]")


def _sanitize(s: str) -> str:
    return _SAFE.sub("_", s)


def default_column_name(expr: E.Expr) -> str:
    if isinstance(expr, E.Var):
        return _sanitize(expr.name)
    if isinstance(expr, E.Id):
        return _sanitize(f"{_owner_name(expr)}__id")
    if isinstance(expr, E.StartNode):
        return _sanitize(f"{_owner_name(expr)}__source")
    if isinstance(expr, E.EndNode):
        return _sanitize(f"{_owner_name(expr)}__target")
    if isinstance(expr, E.HasLabel):
        return _sanitize(f"{_owner_name(expr)}__label_{expr.label}")
    if isinstance(expr, E.HasType):
        return _sanitize(f"{_owner_name(expr)}__type_{expr.rel_type}")
    if isinstance(expr, E.Property):
        return _sanitize(f"{_owner_name(expr)}__prop_{expr.key}")
    return _sanitize(expr.pretty_expr())


def _owner_name(expr: E.Expr) -> str:
    inner = expr.expr
    if isinstance(inner, E.Var):
        return inner.name
    return inner.pretty_expr()


def path_nodes_companion(rel_field: str) -> str:
    """Hidden column name carrying the full intermediate node elements of a
    var-length path segment (see planner ``capture_path_nodes``)."""
    return f"__pathnodes_{rel_field}"


def owner_of(expr: E.Expr) -> Optional[E.Var]:
    """The element variable an expression column belongs to (if any)."""
    if isinstance(expr, E.Var):
        return expr
    if isinstance(expr, (E.Id, E.StartNode, E.EndNode, E.HasLabel, E.HasType, E.Property)):
        inner = expr.expr
        if isinstance(inner, E.Var):
            return inner
    return None


class RecordHeader:
    """Immutable expr -> column mapping.

    Named paths (``MATCH p = (...)``) are tracked in a side table
    ``_paths: path var name -> ordered member field names`` — a path binding
    owns no physical column of its own; it is reassembled at materialization
    time from the columns of its member element variables. (The reference
    blacklists all named-path TCK scenarios — this is a capability the
    reference does NOT have.)"""

    __slots__ = ("_map", "_paths")

    def __init__(
        self,
        mapping: Optional[Dict[E.Expr, str]] = None,
        paths: Optional[Dict[str, Tuple[str, ...]]] = None,
    ):
        self._map: Dict[E.Expr, str] = dict(mapping or {})
        self._paths: Dict[str, Tuple[str, ...]] = dict(paths or {})

    # -- queries -----------------------------------------------------------

    @property
    def expressions(self) -> List[E.Expr]:
        return list(self._map.keys())

    @property
    def columns(self) -> List[str]:
        """Distinct physical columns in deterministic (insertion) order."""
        seen: Set[str] = set()
        out: List[str] = []
        for c in self._map.values():
            if c not in seen:
                seen.add(c)
                out.append(c)
        return out

    def __contains__(self, expr: E.Expr) -> bool:
        return expr in self._map

    def column(self, expr: E.Expr) -> str:
        try:
            return self._map[expr]
        except KeyError:
            raise KeyError(
                f"Expression {expr.pretty_expr()} not in header {self!r}"
            ) from None

    def get(self, expr: E.Expr) -> Optional[str]:
        return self._map.get(expr)

    def exprs_for_column(self, col: str) -> List[E.Expr]:
        return [e for e, c in self._map.items() if c == col]

    @property
    def vars(self) -> List[E.Var]:
        """All element/value variables present (incl. path bindings)."""
        seen: Dict[str, E.Var] = {}
        for e in self._map:
            v = owner_of(e)
            if v is not None and v.name not in seen:
                seen[v.name] = v
        for p in self._paths:
            if p not in seen:
                seen[p] = E.Var(p).with_type(T.CTPath)
        return list(seen.values())

    def var(self, name: str) -> E.Var:
        for v in self.vars:
            if v.name == name:
                return v
        raise KeyError(f"No variable {name!r} in header")

    def expressions_for(self, var: E.Var) -> List[E.Expr]:
        """All expressions owned by ``var`` (incl. the var itself). For a path
        binding: all expressions of all member element variables."""
        if var.name in self._paths:
            out: List[E.Expr] = []
            for f in self._paths[var.name]:
                out.extend(e for e in self._map if _owned_by(e, f))
                comp = path_nodes_companion(f)
                out.extend(e for e in self._map if _owned_by(e, comp))
            return out
        return [e for e in self._map if _owned_by(e, var.name)]

    @property
    def paths(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self._paths)

    def has_path(self, name: str) -> bool:
        return name in self._paths

    def path_entities(self, name: str) -> Tuple[str, ...]:
        return self._paths[name]

    def with_path(self, name: str, entities: Tuple[str, ...]) -> "RecordHeader":
        p = dict(self._paths)
        p[name] = tuple(entities)
        return RecordHeader(self._map, p)

    def id_expr(self, var: E.Var) -> E.Expr:
        for e in self._map:
            if isinstance(e, E.Id) and _owned_by(e, var.name):
                return e
        # scalar vars are their own column
        if var in self._map:
            return var
        raise KeyError(f"No id column for {var.name!r}")

    def labels_for(self, var: E.Var) -> List[E.HasLabel]:
        return sorted(
            (e for e in self._map if isinstance(e, E.HasLabel) and _owned_by(e, var.name)),
            key=lambda e: e.label,
        )

    def types_for(self, var: E.Var) -> List[E.HasType]:
        return sorted(
            (e for e in self._map if isinstance(e, E.HasType) and _owned_by(e, var.name)),
            key=lambda e: e.rel_type,
        )

    def properties_for(self, var: E.Var) -> List[E.Property]:
        return sorted(
            (e for e in self._map if isinstance(e, E.Property) and _owned_by(e, var.name)),
            key=lambda e: e.key,
        )

    # -- construction ------------------------------------------------------

    def with_expr(self, expr: E.Expr, column: Optional[str] = None) -> "RecordHeader":
        if expr in self._map:
            return self
        col = column if column is not None else self._fresh_column(expr)
        m = dict(self._map)
        m[expr] = col
        return RecordHeader(m, self._paths)

    def with_exprs(self, *exprs: E.Expr) -> "RecordHeader":
        h = self
        for e in exprs:
            h = h.with_expr(e)
        return h

    def _fresh_column(self, expr: E.Expr) -> str:
        base = default_column_name(expr)
        used = set(self._map.values())
        if base not in used:
            return base
        i = 1
        while f"{base}_{i}" in used:
            i += 1
        return f"{base}_{i}"

    def with_alias(self, alias: E.Var, original: E.Var) -> "RecordHeader":
        """Bind ``alias`` to the same columns as ``original``
        (reference ``withAlias``). Aliasing a path binding re-registers the
        same member fields under the alias name."""
        if original.name in self._paths:
            p = dict(self._paths)
            p[alias.name] = self._paths[original.name]
            return RecordHeader(self._map, p)
        m = dict(self._map)
        for e in self.expressions_for(original):
            m[_replace_owner(e, alias)] = self._map[e]
        return RecordHeader(m, self._paths)

    def select(self, vars_or_exprs: Iterable[E.Expr]) -> "RecordHeader":
        """Keep only the given vars (with their sub-expressions) / exprs.

        Selecting a path binding keeps its member element columns, but
        re-owned under reserved ``__path_…`` names unless the member variable
        is itself selected — otherwise the member columns would leak the
        original variable names past a WITH and shadow later rebinding."""
        xs = list(vars_or_exprs)
        explicit = {x.name for x in xs if isinstance(x, E.Var)}
        keep: Dict[E.Expr, str] = {}
        paths: Dict[str, Tuple[str, ...]] = {}
        hidden: Dict[str, str] = {}  # original member field -> hidden name
        for x in xs:
            if isinstance(x, E.Var):
                if x.name in self._paths:
                    fields = []
                    for f in self._paths[x.name]:
                        comp = path_nodes_companion(f)
                        comp_exprs = [e for e in self._map if _owned_by(e, comp)]
                        if f in explicit or f.startswith("__path_"):
                            # explicitly selected, or already hidden by an
                            # earlier select: keep under the current name
                            fv = self.var(f)
                            for e in self.expressions_for(fv):
                                keep[e] = self._map[e]
                            for e in comp_exprs:
                                keep[e] = self._map[e]
                            fields.append(f)
                            continue
                        hf = hidden.get(f)
                        if hf is None:
                            hf = f"__path_{f}"
                            hidden[f] = hf
                            fv = self.var(f)
                            hv = E.Var(hf).with_type(fv.typ)
                            for e in self.expressions_for(fv):
                                keep[_replace_owner(e, hv)] = self._map[e]
                            if comp_exprs:
                                cv = E.Var(path_nodes_companion(hf)).with_type(
                                    self.var(comp).typ
                                )
                                for e in comp_exprs:
                                    keep[_replace_owner(e, cv)] = self._map[e]
                        fields.append(hf)
                    paths[x.name] = tuple(fields)
                    # member exprs already kept (hidden or via their own
                    # explicit selection) — do not re-keep under original names
                    continue
                for e in self.expressions_for(x):
                    keep[e] = self._map[e]
                if x in self._map:
                    keep[x] = self._map[x]
            elif x in self._map:
                keep[x] = self._map[x]
        return RecordHeader(keep, paths)

    def without(self, var: E.Var) -> "RecordHeader":
        if var.name in self._paths:
            p = {n: f for n, f in self._paths.items() if n != var.name}
            return RecordHeader(self._map, p)
        drop = set(self.expressions_for(var))
        return RecordHeader(
            {e: c for e, c in self._map.items() if e not in drop}, self._paths
        )

    def union(self, other: "RecordHeader") -> "RecordHeader":
        """Disjoint union; other's conflicting column names are renamed."""
        m = dict(self._map)
        used = set(m.values())
        renames: Dict[str, str] = {}
        for e, c in other._map.items():
            if e in m:
                continue
            col = renames.get(c)
            if col is None:
                col = c
                if col in used:
                    i = 1
                    while f"{c}_{i}" in used:
                        i += 1
                    col = f"{c}_{i}"
                renames[c] = col
                used.add(col)
            m[e] = col
        paths = dict(self._paths)
        paths.update(other._paths)
        return RecordHeader(m, paths)

    def rename_columns(self, mapping: Dict[str, str]) -> "RecordHeader":
        return RecordHeader(
            {e: mapping.get(c, c) for e, c in self._map.items()}, self._paths
        )

    # -- misc --------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RecordHeader)
            and self._map == other._map
            and self._paths == other._paths
        )

    def __hash__(self) -> int:
        return hash((frozenset(self._map.items()), frozenset(self._paths.items())))

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{e.pretty_expr()} -> {c}" for e, c in sorted(self._map.items(), key=lambda kv: kv[1])
        )
        return f"RecordHeader({inner})"


def _owned_by(e: E.Expr, name: str) -> bool:
    if isinstance(e, E.Var):
        return e.name == name
    if isinstance(e, (E.Id, E.StartNode, E.EndNode, E.HasLabel, E.HasType, E.Property)):
        inner = e.expr
        return isinstance(inner, E.Var) and inner.name == name
    return False


def _replace_owner(e: E.Expr, new_var: E.Var) -> E.Expr:
    if isinstance(e, E.Var):
        t = e.typ
        return new_var if t is None else new_var.with_type(new_var.typ or t)
    inner = e.expr
    assert isinstance(inner, E.Var)
    replacement = new_var.with_type(new_var.typ or inner.typ)
    clone = type(e)(**{**_fields_of(e), "expr": replacement})
    if e.typ is not None:
        object.__setattr__(clone, "_typ", e.typ)
    return clone


def _fields_of(e: E.Expr) -> Dict:
    import dataclasses

    return {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}


# ---------------------------------------------------------------------------
# Schema-driven header construction
# ---------------------------------------------------------------------------


def header_for_node(
    var_name: str,
    node_type: T.CTNodeType,
    schema: PropertyGraphSchema,
    base: Optional[RecordHeader] = None,
) -> RecordHeader:
    """Header columns a node variable carries: id, one boolean column per
    possible label, one column per possible property key
    (reference ``RecordHeader.forNode``)."""
    combos = (
        schema.combinations_for(node_type.labels)
        if node_type.labels
        else schema.label_combinations
    )
    possible_labels: Set[str] = set()
    for c in combos:
        possible_labels |= c
    keys = schema.node_property_keys_for_combinations(combos)
    v = E.Var(var_name).with_type(node_type)
    h = base or RecordHeader()
    h = h.with_expr(E.Id(v).with_type(T.CTInteger))
    for l in sorted(possible_labels):
        h = h.with_expr(E.HasLabel(v, l).with_type(T.CTBoolean))
    for k in sorted(keys):
        h = h.with_expr(E.Property(v, k).with_type(keys[k]))
    return h


def header_for_relationship(
    var_name: str,
    rel_type: T.CTRelationshipType,
    schema: PropertyGraphSchema,
    base: Optional[RecordHeader] = None,
) -> RecordHeader:
    types = rel_type.types or schema.relationship_types
    keys = schema.relationship_property_keys_for_types(types)
    v = E.Var(var_name).with_type(rel_type)
    h = base or RecordHeader()
    h = h.with_expr(E.Id(v).with_type(T.CTInteger))
    h = h.with_expr(E.StartNode(v).with_type(T.CTInteger))
    h = h.with_expr(E.EndNode(v).with_type(T.CTInteger))
    for t in sorted(types):
        h = h.with_expr(E.HasType(v, t).with_type(T.CTBoolean))
    for k in sorted(keys):
        h = h.with_expr(E.Property(v, k).with_type(keys[k]))
    return h
