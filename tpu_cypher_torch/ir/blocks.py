"""IR query blocks.

Mirrors the reference's Block DAG (``okapi-ir/.../api/block/*.scala``:
SourceBlock / MatchBlock / ProjectBlock / AggregationBlock /
OrderAndSliceBlock / UnwindBlock / ResultBlock) — here a linear pipeline,
which is what Cypher's clause chaining produces anyway (each WITH starts a
new horizon). Expressions inside blocks are typed ``ir.expr`` trees.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..frontend.ast import SortItem
from .expr import Agg, Expr, Var
from .pattern import IRPattern


class Block:
    pass


@dataclass
class MatchBlock(Block):
    pattern: IRPattern
    predicates: Tuple[Expr, ...] = ()
    optional: bool = False


@dataclass
class ProjectBlock(Block):
    """Bind new fields; keeps existing fields in scope until a SelectBlock."""

    items: Tuple[Tuple[str, Expr], ...]  # (field name, expr)
    distinct: bool = False


@dataclass
class AggregationBlock(Block):
    group: Tuple[Tuple[str, Expr], ...]  # grouping key fields
    aggregations: Tuple[Tuple[str, Agg], ...]


@dataclass
class FilterBlock(Block):
    predicate: Expr


@dataclass
class OrderAndSliceBlock(Block):
    sort_items: Tuple[SortItem, ...] = ()
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclass
class UnwindBlock(Block):
    list_expr: Expr
    fld: str


@dataclass
class DistinctBlock(Block):
    fields: Tuple[str, ...]


@dataclass
class SelectBlock(Block):
    """Narrow scope to the named fields (end of a WITH/RETURN horizon)."""

    fields: Tuple[str, ...]


@dataclass
class ResultBlock(Block):
    fields: Tuple[str, ...]


@dataclass
class FromGraphBlock(Block):
    qgn: str


@dataclass
class GraphResultBlock(Block):
    """RETURN GRAPH"""


@dataclass
class ConstructBlock(Block):
    """CONSTRUCT ... — new-graph spec (reference ``LogicalPatternGraph``)."""

    on_graphs: Tuple[str, ...]
    clones: Tuple[Tuple[str, str], ...]  # (new field, source field)
    new_pattern: IRPattern
    new_properties: Tuple[Tuple[str, str, Expr], ...]  # (field, key, value expr)
    sets: Tuple[Tuple[str, str, Expr], ...] = ()  # SET items (field, key, expr)
    set_labels: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()


@dataclass
class QueryIR:
    """A planned single query: linear block pipeline + final field order.

    ``params`` are the parameter names referenced; ``returns`` the output
    field order (None for graph-returning queries).
    """

    blocks: Tuple[Block, ...]
    returns: Optional[Tuple[str, ...]]
    source_graph: str = "session.ambient"

    def pretty(self) -> str:
        lines = []
        for b in self.blocks:
            lines.append(f"  {b!r}")
        return "QueryIR(\n" + "\n".join(lines) + "\n)"


@dataclass
class UnionIR:
    queries: Tuple["QueryIR", ...]
    all: bool = False
    returns: Optional[Tuple[str, ...]] = None


@dataclass
class CreateGraphIR:
    qgn: str
    inner: object  # QueryIR | UnionIR


@dataclass
class CreateViewIR:
    name: str
    params: Tuple[str, ...]
    inner_text: str


@dataclass
class DropGraphIR:
    qgn: str
    view: bool = False


# ---------------------------------------------------------------------------
# write IR (docs/mutation.md): CREATE / MERGE / SET / DELETE against the
# ambient mutable graph. The read prefix is a normal QueryIR (planned on the
# write query's pinned snapshot); the write ops evaluate host-side per
# binding row and commit as one WriteBatch.
# ---------------------------------------------------------------------------


@dataclass
class NodeTemplate:
    """One node element of a CREATE/MERGE pattern."""

    var: str  # binding name (fresh for anonymous nodes)
    bound: bool  # True: var is already bound — reuse, don't create
    labels: Tuple[str, ...] = ()
    props: Tuple[Tuple[str, Expr], ...] = ()


@dataclass
class RelTemplate:
    """One relationship element; endpoints name node templates/bindings."""

    var: str
    rel_type: str
    src: str
    dst: str
    props: Tuple[Tuple[str, Expr], ...] = ()


@dataclass
class SetItemSpec:
    """One SET item: property assign, label add, or whole-map rewrite."""

    var: str
    key: Optional[str] = None  # property key; None for labels / map value
    value: Optional[Expr] = None
    labels: Tuple[str, ...] = ()


@dataclass
class CreateOp(Block):
    nodes: Tuple[NodeTemplate, ...]
    rels: Tuple[RelTemplate, ...]


@dataclass
class MergeOp(Block):
    nodes: Tuple[NodeTemplate, ...]
    rels: Tuple[RelTemplate, ...]
    on_create: Tuple[SetItemSpec, ...] = ()
    on_match: Tuple[SetItemSpec, ...] = ()


@dataclass
class SetOp(Block):
    items: Tuple[SetItemSpec, ...]


@dataclass
class DeleteOp(Block):
    fields: Tuple[str, ...]
    detach: bool = False


@dataclass
class UpdateIR:
    """A write query: optional read prefix + ordered write ops."""

    read: Optional[QueryIR]
    ops: Tuple[Block, ...]
    source_graph: str = "session.ambient"
