"""SQL-table property-graph data source driven by Graph DDL.

The port of ``tpu_cypher/io/sql.py``, a re-design of the reference SQL PGDS
(``morpheus-spark-cypher/.../api/io/sql/SqlPropertyGraphDataSource.scala:75-330``
with ``IdGenerationStrategy.scala:29``): existing "SQL" tables (here: in-memory
column dicts or parquet/CSV files — ingested on the host, then held as
device columns by the session's table class) are mapped onto property graphs
by a :class:`~tpu_cypher.graph_ddl.GraphDdl` document.

Element ids (reference ``IdGenerationStrategy``):

* ``HASHED_ID`` — 63-bit content hash of (view key, id-column values); node ids
  are recomputed on the edge side from the JOIN ON columns, so no host join is
  needed (the reference's ``HashedId`` hash64 strategy).
* ``SERIALIZED_ID`` — monotonically increasing ids per view (reference
  ``SerializedId``); edge endpoint ids are resolved by a host-side hash join of
  the edge's join columns against the node view.

Ids are computed from the same Python values the JAX package hashes (the
lists of ``InMemoryTables``, the object cells of ``FileTables``), so both
packages give one graph the same ids: ``hash64`` hashes ``repr`` of each
value, and a numpy scalar's ``repr`` differs from a Python int's.
"""

from __future__ import annotations

import enum
import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import types as T
from ..api.mapping import NodeMapping, RelationshipMapping
from ..api.schema import PropertyGraphSchema
from ..graph_ddl.model import (
    EdgeToViewMapping,
    Graph,
    GraphDdl,
    GraphDdlError,
    NodeToViewMapping,
    NodeViewKey,
    ViewId,
)
from .datasource import DataSourceError, PropertyGraphDataSource

Columns = Dict[str, list]


class IdGenerationStrategy(enum.Enum):
    HASHED_ID = "hashed"
    SERIALIZED_ID = "serialized"


def hash64(*parts) -> int:
    """Deterministic 63-bit content hash (the reference uses xxhash via
    ``MorpheusFunctions.hash64``, ``MorpheusFunctions.scala:91``; any stable
    64-bit mix works — we use blake2b-8)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x1f")
    return int.from_bytes(h.digest(), "big") & 0x7FFF_FFFF_FFFF_FFFF


class SqlTableProvider:
    """Resolves ``schema.view`` names to host tables (column dicts)."""

    def table(self, schema: str, view: str) -> Columns:
        raise NotImplementedError


class InMemoryTables(SqlTableProvider):
    """Tables registered as ``{"schema.view": {col: [values]}}`` — the analog
    of the reference's Hive/H2 fixtures for tests and notebooks."""

    def __init__(self, tables: Dict[str, Columns]):
        self._tables = tables

    def table(self, schema: str, view: str) -> Columns:
        key = f"{schema}.{view}"
        if key not in self._tables:
            raise DataSourceError(
                f"View {key!r} not registered; known: {sorted(self._tables)}"
            )
        cols = self._tables[key]
        n = len(next(iter(cols.values()))) if cols else 0
        for c, vs in cols.items():
            if len(vs) != n:
                raise DataSourceError(f"Ragged column {c!r} in view {key!r}")
        return cols


class FileTables(SqlTableProvider):
    """Tables stored as ``<root>/<schema>/<view>.(parquet|csv)`` (reference
    ``SqlDataSourceConfig.File``/``readFile``,
    ``SqlPropertyGraphDataSource.scala:279``)."""

    def __init__(self, root: str, fmt: str = "parquet"):
        if fmt not in ("parquet", "csv"):
            raise DataSourceError(f"Unsupported format {fmt!r}")
        self.root = root
        self.fmt = fmt

    def table(self, schema: str, view: str) -> Columns:
        from .fs import require

        pd = require("pandas", "FileTables")
        if self.fmt == "parquet":
            require("pyarrow", "FileTables")
        path = os.path.join(self.root, schema, f"{view}.{self.fmt}")
        if not os.path.isfile(path):
            raise DataSourceError(f"No table file at {path}")
        if self.fmt == "parquet":
            df = pd.read_parquet(path)
        else:
            df = pd.read_csv(path)
        df = df.astype(object).where(pd.notnull(df), None)
        return {c: df[c].tolist() for c in df.columns}


class SqlPropertyGraphDataSource(PropertyGraphDataSource):
    """Maps SQL-style tables to property graphs via Graph DDL (reference
    ``SqlPropertyGraphDataSource.scala:75``)."""

    def __init__(
        self,
        graph_ddl: GraphDdl,
        data_sources: Dict[str, SqlTableProvider],
        id_strategy: IdGenerationStrategy = IdGenerationStrategy.HASHED_ID,
    ):
        if isinstance(graph_ddl, str):
            graph_ddl = GraphDdl.parse(graph_ddl)
        self.graph_ddl = graph_ddl
        self.data_sources = data_sources
        self.id_strategy = id_strategy

    # -- PGDS interface ----------------------------------------------------

    def has_graph(self, name: str) -> bool:
        return name in self.graph_ddl.graphs

    def graph_names(self) -> List[str]:
        return sorted(self.graph_ddl.graphs)

    def schema(self, name: str) -> Optional[PropertyGraphSchema]:
        g = self.graph_ddl.graphs.get(name)
        return g.schema if g is not None else None

    def store(self, name: str, graph) -> None:
        raise DataSourceError("SqlPropertyGraphDataSource does not support store")

    def delete(self, name: str) -> None:
        raise DataSourceError("SqlPropertyGraphDataSource does not support delete")

    def graph(self, name: str, session):
        from ..relational.graphs import ElementTable, ScanGraph

        ddl_graph = self.graph_ddl.graphs.get(name)
        if ddl_graph is None:
            raise DataSourceError(f"Graph {name!r} not declared in DDL")
        schema = ddl_graph.schema
        tables: List[ElementTable] = []
        # serialized ids must be globally unique across views: per-view offsets
        offsets = _SerialOffsets()
        node_index: Dict[NodeViewKey, Dict[Tuple, int]] = {}

        for nvm in ddl_graph.node_to_view_mappings:
            cols = self._read_view(nvm.view)
            id_cols = self._node_id_columns(ddl_graph, nvm, cols)
            ids = self._generate_ids(nvm.key, cols, id_cols, offsets)
            if self.id_strategy is IdGenerationStrategy.SERIALIZED_ID:
                node_index[nvm.key] = _key_index(cols, id_cols, ids)
            out: Columns = {"$id": ids}
            for prop, col in nvm.property_mappings:
                out[f"$p_{prop}"] = _require_column(cols, col, nvm.view)
            mapping = NodeMapping(
                id_key="$id",
                implied_labels=nvm.node_type.labels,
                property_mapping=tuple(
                    (prop, f"$p_{prop}") for prop, _ in nvm.property_mappings
                ),
            )
            tables.append(ElementTable(mapping, session.table_cls.from_columns(out)))

        for evm in ddl_graph.edge_to_view_mappings:
            if len(evm.rel_type.labels) != 1:
                raise GraphDdlError(
                    f"Single relationship type required, got {sorted(evm.rel_type.labels)}"
                )
            (rel_label,) = evm.rel_type.labels
            cols = self._read_view(evm.view)
            n = _num_rows(cols)
            ids = self._generate_ids(
                evm.key, cols, tuple(sorted(cols)) or (), offsets
            )
            src = self._endpoint_ids(
                ddl_graph, evm.start_node.node_view_key,
                evm.start_node.join_predicates, cols, node_index, evm.view,
            )
            dst = self._endpoint_ids(
                ddl_graph, evm.end_node.node_view_key,
                evm.end_node.join_predicates, cols, node_index, evm.view,
            )
            out = {"$id": ids, "$source": src, "$target": dst}
            for prop, col in evm.property_mappings:
                out[f"$p_{prop}"] = _require_column(cols, col, evm.view)
            mapping = RelationshipMapping(
                id_key="$id",
                source_key="$source",
                target_key="$target",
                rel_type=rel_label,
                property_mapping=tuple(
                    (prop, f"$p_{prop}") for prop, _ in evm.property_mappings
                ),
            )
            assert len(src) == n and len(dst) == n
            tables.append(ElementTable(mapping, session.table_cls.from_columns(out)))

        return ScanGraph(tables, schema)

    # -- helpers -----------------------------------------------------------

    def _read_view(self, vid: ViewId) -> Columns:
        ds, schema, view = vid.resolved
        provider = self.data_sources.get(ds)
        if provider is None:
            raise DataSourceError(
                f"Data source {ds!r} not configured; known: {sorted(self.data_sources)}"
            )
        return provider.table(schema, view)

    def _node_id_columns(
        self, g: Graph, nvm: NodeToViewMapping, cols: Columns
    ) -> Tuple[str, ...]:
        """Identity columns of a node view: the JOIN ON columns of the first
        referencing edge mapping, else all columns (reference
        ``SqlPropertyGraphDataSource.extractNode``, ``:200-207``)."""
        id_cols = g.node_id_columns_for(nvm.key)
        if id_cols is None:
            id_cols = tuple(sorted(cols))
        return id_cols

    def _generate_ids(
        self,
        view_key,
        cols: Columns,
        id_cols: Sequence[str],
        offsets: "_SerialOffsets",
    ) -> List[int]:
        n = _num_rows(cols)
        if self.id_strategy is IdGenerationStrategy.SERIALIZED_ID:
            base = offsets.claim(str(view_key), n)
            return list(range(base, base + n))
        key_cols = [_require_column(cols, c, view_key) for c in id_cols]
        tag = str(view_key)
        return [hash64(tag, *(kc[i] for kc in key_cols)) for i in range(n)]

    def _endpoint_ids(
        self,
        g: Graph,
        node_key: NodeViewKey,
        joins,
        edge_cols: Columns,
        node_index: Dict[NodeViewKey, Dict[Tuple, int]],
        edge_view: ViewId,
    ) -> List[int]:
        n = _num_rows(edge_cols)
        # order edge join columns to match the node view's id-column order
        node_id_cols = g.node_id_columns_for(node_key) or ()
        by_node_col = {j.node_column: j.edge_column for j in joins}
        try:
            edge_join_cols = [by_node_col[c] for c in node_id_cols]
        except KeyError as e:
            raise GraphDdlError(
                f"Edge view {edge_view} joins to {node_key} on columns "
                f"{sorted(by_node_col)} but the node view is identified by "
                f"{list(node_id_cols)} (missing {e})"
            )
        key_cols = [_require_column(edge_cols, c, edge_view) for c in edge_join_cols]
        if self.id_strategy is IdGenerationStrategy.HASHED_ID:
            tag = str(node_key)
            return [hash64(tag, *(kc[i] for kc in key_cols)) for i in range(n)]
        index = node_index.get(node_key)
        if index is None:
            raise GraphDdlError(f"No node mapping materialized for {node_key}")
        out: List[int] = []
        for i in range(n):
            key = tuple(kc[i] for kc in key_cols)
            if key not in index:
                raise DataSourceError(
                    f"Edge view {edge_view} references missing node {key} in {node_key}"
                )
            out.append(index[key])
        return out


class _SerialOffsets:
    """Allocates disjoint contiguous id ranges per view (the reference's
    partitioned monotonic ids, ``MorpheusFunctions.scala:76``)."""

    def __init__(self):
        self._next = 0
        self._claimed: Dict[str, int] = {}

    def claim(self, key: str, n: int) -> int:
        if key in self._claimed:
            return self._claimed[key]
        base = self._next
        self._claimed[key] = base
        self._next += n
        return base


def _key_index(cols: Columns, key_cols: Sequence[str], ids: List[int]) -> Dict[Tuple, int]:
    """Host-side join index: id-column values tuple → generated id."""
    key_vals = [cols[c] for c in key_cols]
    return {
        tuple(kc[i] for kc in key_vals): ids[i] for i in range(len(ids))
    }


def _num_rows(cols: Columns) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def _require_column(cols: Columns, name: str, where) -> list:
    if name not in cols:
        raise DataSourceError(
            f"Column {name!r} not found in view {where}; has {sorted(cols)}"
        )
    return cols[name]
