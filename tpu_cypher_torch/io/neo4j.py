"""Neo4j IO: bulk-import CSV sink, read/write query builders, gated PGDS.

The port of ``tpu_cypher/io/neo4j.py``, a re-design of the reference's Neo4j
integration:

* ``okapi-neo4j-io/.../ElementReader.scala:34`` — per-label-combination and
  per-relationship-type read queries (built here as plain strings, testable
  without a server)
* ``okapi-neo4j-io/.../SchemaFromProcedure.scala:39`` — schema via the
  ``db.schema.nodeTypeProperties`` / ``relTypeProperties`` procedures
* ``morpheus/.../sync/Neo4jGraphMerge.scala:53,77,132`` — delta write-back:
  ``CREATE INDEX`` on element keys + batched ``UNWIND $batch ... MERGE``
* ``morpheus/.../Neo4jBulkCSVDataSink.scala`` — export in the
  ``neo4j-admin import`` bulk format plus a parameterized ``import.sh``

The live driver connection is OPTIONAL: ``Neo4jPropertyGraphDataSource``
gates on the ``neo4j`` Python package at call time with a clear error; every
query-construction path and the bulk CSV sink are fully functional without
it.
"""

from __future__ import annotations

import csv
import os
import re
import stat
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from ..api import types as T
from ..api.schema import PropertyGraphSchema
from .datasource import DataSourceError, PropertyGraphDataSource

ID_KEY = "___id"
START_KEY = "___source"
END_KEY = "___target"

_SAFE_NAME = re.compile(r"[^A-Za-z0-9_]")


# ---------------------------------------------------------------------------
# connection config + driver gate
# ---------------------------------------------------------------------------


@dataclass
class Neo4jConfig:
    """Reference ``Neo4jConfig.scala``."""

    uri: str = "bolt://localhost:7687"
    user: str = "neo4j"
    password: Optional[str] = None
    database: str = "neo4j"


def _require_driver():
    try:
        import neo4j  # type: ignore

        return neo4j
    except ImportError as e:  # pragma: no cover - driver not in test image
        raise DataSourceError(
            "The Neo4j data source needs the optional 'neo4j' Python driver "
            "(pip install neo4j). Query construction and the bulk CSV sink "
            "(Neo4jBulkCSVDataSink) work without it."
        ) from e


# ---------------------------------------------------------------------------
# read-side query builders (ElementReader.scala:34)
# ---------------------------------------------------------------------------


def _label_predicate(labels: Iterable[str]) -> str:
    return "".join(f":`{l}`" for l in sorted(labels))


def exact_label_match_query(labels: Sequence[str], prop_keys: Sequence[str]) -> str:
    """Rows whose label set is EXACTLY ``labels``
    (reference ``flatExactLabelQuery``)."""
    props = "".join(f", n.`{k}`" for k in sorted(prop_keys))
    return (
        f"MATCH (n{_label_predicate(labels)}) "
        f"WHERE size(labels(n)) = {len(set(labels))} "
        f"RETURN id(n) AS {ID_KEY}{props}"
    )


def rel_type_query(rel_type: str, prop_keys: Sequence[str]) -> str:
    """Reference ``flatRelTypeQuery``."""
    props = "".join(f", r.`{k}`" for k in sorted(prop_keys))
    return (
        f"MATCH (s)-[r:`{rel_type}`]->(t) "
        f"RETURN id(r) AS {ID_KEY}, id(s) AS {START_KEY}, "
        f"id(t) AS {END_KEY}{props}"
    )


NODE_SCHEMA_PROCEDURE = "db.schema.nodeTypeProperties"
REL_SCHEMA_PROCEDURE = "db.schema.relTypeProperties"


def node_schema_query() -> str:
    return f"CALL {NODE_SCHEMA_PROCEDURE}()"


def rel_schema_query() -> str:
    return f"CALL {REL_SCHEMA_PROCEDURE}()"


# ---------------------------------------------------------------------------
# write-side statement builders (Neo4jGraphMerge.scala)
# ---------------------------------------------------------------------------


def create_index_statement(label: str, keys: Sequence[str]) -> str:
    """Neo4j 4+/5 index syntax (``CREATE INDEX ... FOR (n:L) ON (n.k)``).
    The reference targets Neo4j 3.x (``CREATE INDEX ON :L(k)``,
    ``Neo4jGraphMerge.scala:97-111``) — see
    ``create_index_statement_legacy`` for that form."""
    props = ", ".join(f"n.`{k}`" for k in keys)
    safe = _SAFE_NAME.sub("_", label) + "_" + "_".join(
        _SAFE_NAME.sub("_", k) for k in keys
    )
    return (
        f"CREATE INDEX `idx_{safe}` IF NOT EXISTS "
        f"FOR (n:`{label}`) ON ({props})"
    )


def create_index_statement_legacy(label: str, keys: Sequence[str]) -> str:
    """Neo4j 3.x syntax used by the reference."""
    cols = ", ".join(f"`{k}`" for k in keys)
    return f"CREATE INDEX ON :`{label}`({cols})"


def merge_node_statement(
    labels: Sequence[str], key_props: Sequence[str], other_props: Sequence[str]
) -> str:
    """Batched node MERGE by element key: ``UNWIND $batch AS row MERGE
    (n:Labels {keys...}) SET n += rest`` (reference ``mergeNodes``)."""
    keys = ", ".join(f"`{k}`: row.`{k}`" for k in sorted(key_props))
    stmt = f"UNWIND $batch AS row MERGE (n{_label_predicate(labels)} {{{keys}}})"
    if other_props:
        sets = ", ".join(f"n.`{k}` = row.`{k}`" for k in sorted(other_props))
        stmt += f" SET {sets}"
    return stmt


def merge_relationship_statement(
    rel_type: str,
    start_labels: Sequence[str],
    end_labels: Sequence[str],
    start_keys: Sequence[str],
    end_keys: Sequence[str],
    key_props: Sequence[str],
    other_props: Sequence[str],
) -> str:
    """Batched relationship MERGE between key-matched endpoints
    (reference ``mergeRelationships``)."""
    s_match = ", ".join(f"`{k}`: row.`source_{k}`" for k in sorted(start_keys))
    e_match = ", ".join(f"`{k}`: row.`target_{k}`" for k in sorted(end_keys))
    r_keys = ", ".join(f"`{k}`: row.`{k}`" for k in sorted(key_props))
    r_key_part = f" {{{r_keys}}}" if r_keys else ""
    stmt = (
        f"UNWIND $batch AS row "
        f"MATCH (s{_label_predicate(start_labels)} {{{s_match}}}) "
        f"MATCH (t{_label_predicate(end_labels)} {{{e_match}}}) "
        f"MERGE (s)-[r:`{rel_type}`{r_key_part}]->(t)"
    )
    if other_props:
        sets = ", ".join(f"r.`{k}` = row.`{k}`" for k in sorted(other_props))
        stmt += f" SET {sets}"
    return stmt


# ---------------------------------------------------------------------------
# bulk CSV sink (Neo4jBulkCSVDataSink.scala)
# ---------------------------------------------------------------------------

IMPORT_SCRIPT_NAME = "import.sh"

_IMPORT_SCRIPT_TEMPLATE = """#!/bin/sh
if [ $# -ne 1 ]
then
  echo "Please provide the path to your Neo4j installation (e.g. /usr/share/neo4j/)"
else
  ${{1}}bin/neo4j-admin import \\
  --database={database} \\
  --delimiter="," \\
  --array-delimiter="{array_delimiter}" \\
  --id-type=INTEGER \\
{node_args} \\
{rel_args}
fi
"""


def _clean_value(v, t: Optional[T.CypherType]):
    """Undo pandas NaN/float64 artifacts on optional columns: NaN -> None,
    and integer-typed floats back to int (pandas upcasts an int column with
    missing values to float64, which would corrupt int properties as
    '23.0'/'nan' on export)."""
    import math as _math

    import numpy as _np

    if v is None:
        return None
    if isinstance(v, (float, _np.floating)) and _math.isnan(v):
        return None
    m = t.material if t is not None else None
    if m is T.CTInteger and isinstance(v, (float, _np.floating)):
        return int(v)
    if isinstance(v, _np.integer):
        return int(v)
    if isinstance(v, _np.floating):
        return float(v)
    if isinstance(v, _np.bool_):
        return bool(v)
    return v


def _clean_records(df, types: Dict[str, T.CypherType]) -> List[Dict]:
    """One cleaned dict per row, built column by column: each cell keeps its
    own column's type. The JAX package walks ``df.iterrows()``, whose row
    Series share one dtype, so an integer cell in a row that also holds a
    float comes out as a float there (and is cleaned back to an int where
    its type is INTEGER)."""
    cols = list(df.columns)
    cleaned = [
        [_clean_value(v, types.get(c)) for v in df[c].tolist()] for c in cols
    ]
    return [dict(zip(cols, row)) for row in zip(*cleaned)]


def _bulk_type(t: Optional[T.CypherType]) -> str:
    """CypherType -> neo4j-admin import column type
    (reference ``DataTypeOps.toNeo4jBulkImportType``)."""
    m = t.material if t is not None else None
    if m is None or m is T.CTString or m is T.CTNull or m is T.CTAny:
        return "string"
    if m is T.CTInteger:
        return "int"
    if m is T.CTBoolean:
        return "boolean"
    if m is T.CTFloat:
        return "double"
    if isinstance(m, T.CTListType):
        return _bulk_type(m.inner) + "[]"
    return "string"


class Neo4jBulkCSVDataSink:
    """Writes a property graph into the ``neo4j-admin import`` bulk format:
    per label combination ``nodes/<combo>/{schema.csv,part_0.csv}``, per
    relationship type ``relationships/<type>/...``, plus an ``import.sh``
    parameterized with the Neo4j installation path. Needs no driver."""

    def __init__(self, root: str, array_delimiter: str = "|"):
        self.root = root
        self.array_delimiter = array_delimiter

    def _node_dir(self, name: str, combo) -> str:
        from .fs import _combo_dir

        return os.path.join(self.root, name, "nodes", _combo_dir(combo))

    def _rel_dir(self, name: str, rel_type: str) -> str:
        from .fs import _rel_dir

        return os.path.join(self.root, name, "relationships", _rel_dir(rel_type))

    def store(self, name: str, graph) -> None:
        from .fs import _plain_ctx, canonical_node_columns, canonical_rel_columns

        schema = graph.schema
        ctx = _plain_ctx(graph)
        node_args: List[str] = []
        rel_args: List[str] = []

        for combo in sorted(schema.label_combinations, key=sorted):
            df, types = canonical_node_columns(graph, combo, ctx)
            d = self._node_dir(name, combo)
            header = ["id:ID"] + [
                f"{k}:{_bulk_type(types.get(k))}" for k in df.columns if k != "id"
            ]
            self._write_table(d, header, df, [c for c in df.columns], types)
            # unlabeled nodes: plain --nodes, no empty label specifier
            label_spec = ":" + ":".join(sorted(combo)) if combo else ""
            node_args.append(
                f'  --nodes{label_spec} '
                f'"{os.path.join(d, "schema.csv")},{os.path.join(d, "part_0.csv")}"'
            )

        for rt in sorted(schema.relationship_types):
            df, types = canonical_rel_columns(graph, rt, ctx)
            d = self._rel_dir(name, rt)
            cols = [c for c in df.columns if c != "id"]
            header = []
            for c in cols:
                if c == "source":
                    header.append(":START_ID")
                elif c == "target":
                    header.append(":END_ID")
                else:
                    header.append(f"{c}:{_bulk_type(types.get(c))}")
            self._write_table(d, header, df, cols, types)
            rel_args.append(
                f'  --relationships:{rt} '
                f'"{os.path.join(d, "schema.csv")},{os.path.join(d, "part_0.csv")}"'
            )

        script = _IMPORT_SCRIPT_TEMPLATE.format(
            database=name,
            array_delimiter=self.array_delimiter,
            node_args=" \\\n".join(node_args),
            rel_args=" \\\n".join(rel_args),
        )
        script_path = os.path.join(self.root, name, IMPORT_SCRIPT_NAME)
        os.makedirs(os.path.dirname(script_path), exist_ok=True)
        with open(script_path, "w") as f:
            f.write(script)
        os.chmod(script_path, os.stat(script_path).st_mode | stat.S_IXUSR)

    def _write_table(
        self,
        d: str,
        header: List[str],
        df,
        cols: List[str],
        types: Dict[str, T.CypherType],
    ) -> None:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "schema.csv"), "w", newline="") as f:
            csv.writer(f).writerow(header)
        with open(os.path.join(d, "part_0.csv"), "w", newline="") as f:
            w = csv.writer(f)
            for record in _clean_records(df, types):
                out = []
                for c in cols:
                    v = record[c]
                    if isinstance(v, (list, tuple)):
                        v = self.array_delimiter.join(str(x) for x in v)
                    elif v is None:
                        v = ""
                    elif isinstance(v, bool):
                        v = "true" if v else "false"
                    out.append(v)
                w.writerow(out)


# ---------------------------------------------------------------------------
# live PGDS (driver-gated)
# ---------------------------------------------------------------------------


class Neo4jPropertyGraphDataSource(PropertyGraphDataSource):
    """Reads a live Neo4j database as a property graph: one node table per
    exact label combination, one relationship table per type, schema via the
    ``db.schema.*`` procedures (reference ``ElementReader`` +
    ``SchemaFromProcedure``). Write-back is MERGE-by-element-key
    (reference ``Neo4jGraphMerge``). All server communication is gated on the
    optional ``neo4j`` Python driver."""

    def __init__(self, config: Neo4jConfig, graph_name: str = "graph"):
        self.config = config
        self._graph_name = graph_name
        self._schema_cache: Optional[PropertyGraphSchema] = None
        self._driver = None

    # -- driver plumbing ---------------------------------------------------

    def _get_driver(self):
        """One driver (connection pool) per source, created lazily."""
        if self._driver is None:
            neo4j = _require_driver()
            auth = (
                (self.config.user, self.config.password)
                if self.config.password
                else None
            )
            self._driver = neo4j.GraphDatabase.driver(self.config.uri, auth=auth)
        return self._driver

    def _session(self):
        return self._get_driver().session(database=self.config.database)

    def _run(self, query: str, **params) -> List[Dict]:
        with self._session() as s:
            return [dict(r) for r in s.run(query, **params)]

    def close(self) -> None:
        if self._driver is not None:
            self._driver.close()
            self._driver = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- PGDS --------------------------------------------------------------

    def has_graph(self, name: str) -> bool:
        return name == self._graph_name

    def graph_names(self) -> List[str]:
        return [self._graph_name]

    def schema(self, name: str) -> Optional[PropertyGraphSchema]:
        if name != self._graph_name:
            return None
        if self._schema_cache is None:
            self._schema_cache = self._schema_from_procedure()
        return self._schema_cache

    def _schema_from_procedure(self) -> PropertyGraphSchema:
        """Reference ``SchemaFromProcedure.scala:39``."""
        schema = PropertyGraphSchema.empty()
        for row in self._run(node_schema_query()):
            labels = frozenset(row.get("nodeLabels") or [])
            prop = row.get("propertyName")
            types = row.get("propertyTypes") or []
            # a non-mandatory property can be absent -> nullable type
            # (the reference consumes 'mandatory' the same way)
            mandatory = bool(row.get("mandatory"))
            keys = (
                {prop: _cypher_type_for(types, mandatory)} if prop else {}
            )
            schema = schema.with_node_combination(labels, keys)
        for row in self._run(rel_schema_query()):
            rel_type = (row.get("relType") or "").strip(":`")
            prop = row.get("propertyName")
            types = row.get("propertyTypes") or []
            mandatory = bool(row.get("mandatory"))
            keys = (
                {prop: _cypher_type_for(types, mandatory)} if prop else {}
            )
            schema = schema.with_relationship_type(rel_type, keys)
        return schema

    def graph(self, name: str, session):
        if name != self._graph_name:
            raise DataSourceError(f"Unknown graph {name!r}; this source exposes "
                                  f"{self._graph_name!r}")
        schema = self.schema(name)
        from ..api.mapping import NodeMappingBuilder, RelationshipMappingBuilder
        from ..relational.graphs import ElementTable, ScanGraph

        table_cls = session.table_cls
        tables = []
        for combo in schema.label_combinations:
            keys = schema.node_property_keys(combo)
            rows = self._run(exact_label_match_query(sorted(combo), sorted(keys)))
            cols = {ID_KEY: [r[ID_KEY] for r in rows]}
            for k in sorted(keys):
                cols[f"n.`{k}`"] = [r.get(f"n.`{k}`") for r in rows]
            b = NodeMappingBuilder.on(ID_KEY).with_implied_label(*combo)
            for k in sorted(keys):
                b = b.with_property_key(k, f"n.`{k}`")
            tables.append(ElementTable(b.build(), table_cls.from_columns(cols)))
        for rt in schema.relationship_types:
            keys = schema.relationship_property_keys(rt)
            rows = self._run(rel_type_query(rt, sorted(keys)))
            cols = {
                ID_KEY: [r[ID_KEY] for r in rows],
                START_KEY: [r[START_KEY] for r in rows],
                END_KEY: [r[END_KEY] for r in rows],
            }
            for k in sorted(keys):
                cols[f"r.`{k}`"] = [r.get(f"r.`{k}`") for r in rows]
            b = (
                RelationshipMappingBuilder.on(ID_KEY)
                .from_(START_KEY)
                .to(END_KEY)
                .with_relationship_type(rt)
            )
            for k in sorted(keys):
                b = b.with_property_key(k, f"r.`{k}`")
            tables.append(ElementTable(b.build(), table_cls.from_columns(cols)))
        # the JAX package passes ``table_cls`` as a third argument, which
        # ``ScanGraph`` does not take, so its ``graph()`` raises TypeError
        return ScanGraph(tables, schema)

    def store(self, name: str, graph) -> None:
        """MERGE write-back by element key (reference ``Neo4jGraphMerge``):
        node batches per label combination keyed on all properties named in
        ``element_keys``; here we key on the exported ``id`` column."""
        from .fs import _plain_ctx, canonical_node_columns, canonical_rel_columns

        schema = graph.schema
        ctx = _plain_ctx(graph)
        with self._session() as s:
            # index the merge key per label first, as the reference does —
            # without it every MERGE row is a full store scan. Try the
            # modern (4+/5) syntax first, then the 3.x form the reference
            # uses; only an already-existing index is silently accepted.
            for label in sorted({l for combo in schema.label_combinations for l in combo}):
                for stmt in (
                    create_index_statement(label, ["id"]),
                    create_index_statement_legacy(label, ["id"]),
                ):
                    try:
                        s.run(stmt)
                        break
                    except Exception as e:  # noqa: BLE001 - fault-ok: index-create probe against external Neo4j, no device state
                        if "already exists" in str(e).lower() or "equivalent" in str(e).lower():
                            break
            for combo in schema.label_combinations:
                df, types = canonical_node_columns(graph, combo, ctx)
                props = [c for c in df.columns if c != "id"]
                stmt = merge_node_statement(sorted(combo), ["id"], props)
                s.run(stmt, batch=_clean_records(df, types))
            for rt in schema.relationship_types:
                df, types = canonical_rel_columns(graph, rt, ctx)
                props = [c for c in df.columns if c not in ("id", "source", "target")]
                # endpoint labels (when the schema knows the pattern) let the
                # MATCHes use the per-label id index instead of a full scan
                pats = [p for p in schema.schema_patterns if p.rel_type == rt]
                shapes = {(p.source_labels, p.target_labels) for p in pats}
                if len(shapes) == 1:
                    (sl, tl) = next(iter(shapes))
                    start_labels, end_labels = sorted(sl), sorted(tl)
                else:
                    start_labels, end_labels = [], []
                stmt = merge_relationship_statement(
                    rt, start_labels, end_labels, ["id"], ["id"], ["id"], props
                )
                batch = [
                    {
                        **{k: v for k, v in rec.items() if k not in ("source", "target")},
                        "source_id": rec["source"],
                        "target_id": rec["target"],
                    }
                    for rec in _clean_records(df, types)
                ]
                s.run(stmt, batch=batch)

    def delete(self, name: str) -> None:
        raise DataSourceError("Deleting a live Neo4j database is not supported")


def _cypher_type_for(
    neo4j_types: Sequence[str], mandatory: bool = True
) -> T.CypherType:
    """Neo4j procedure type names -> CypherType; non-mandatory properties are
    nullable (reference ``SchemaFromProcedure``)."""
    mapping = {
        "String": T.CTString,
        "Long": T.CTInteger,
        "Integer": T.CTInteger,
        "Double": T.CTFloat,
        "Boolean": T.CTBoolean,
        "StringArray": T.CTList(T.CTString),
        "LongArray": T.CTList(T.CTInteger),
        "DoubleArray": T.CTList(T.CTFloat),
    }
    ts = [mapping.get(t, T.CTAny) for t in neo4j_types]
    if not ts:
        return T.CTAny.nullable
    out = T.join_types(ts)
    return out if mandatory else out.nullable
