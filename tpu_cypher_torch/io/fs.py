"""Filesystem graph persistence.

The port of ``tpu_cypher/io/fs.py`` (itself a re-design of the reference's
FS data sources, ``morpheus/.../api/io/fs/FSGraphSource.scala``,
``AbstractPropertyGraphDataSource.scala:73-190``,
``GraphDirectoryStructure.scala:85``). Same directory layout, escaping,
cell encoding and stored-format metadata, so a graph that either package
stores loads in the other:

    <root>/<graphName>/propertyGraphSchema.json
    <root>/<graphName>/metadata.json
    <root>/<graphName>/nodes/<labelCombo>/part.<fmt>
    <root>/<graphName>/relationships/<relType>/part.<fmt>

Formats: ``parquet`` (pyarrow, default — typed, null-safe) and ``csv``
(lists/maps stored as JSON strings). Node tables are canonical: column
``id`` plus one column per property key; relationship tables add ``source``
and ``target``. The schema JSON mirrors the reference's upickle
serialization (``JsonSerialization.scala``) with our type-string lattice.

pandas and pyarrow are host packages that only this source needs: they are
imported where a graph is stored or loaded, and their absence is a typed
``DataSourceError`` naming the package, so ``tpu_cypher_torch.io`` imports
without them. On a ``CudaTable`` a null-free integer, float or boolean
column moves between the device and a DataFrame as one numpy array
(``CudaTable.frame_columns``, ``CudaTable.from_arrays``); every other
column goes value by value, as in the reference.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..api import types as T
from ..api.mapping import NodeMapping, RelationshipMapping
from ..api.schema import PropertyGraphSchema
from ..api.values import Duration
from ..ir import expr as E
from ..relational.graphs import ElementTable, ScanGraph
from .datasource import DataSourceError, PropertyGraphDataSource

SCHEMA_FILE = "propertyGraphSchema.json"
METADATA_FILE = "metadata.json"
_KEY_COLUMNS = ("id", "source", "target")


def require(module: str, what: str = "Storing or loading graph tables"):
    """Import an optional host package at the point of use; its absence is
    a ``DataSourceError`` that names it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise DataSourceError(
            f"{what} needs the optional '{module}' Python package, which "
            f"cannot be imported ({e})"
        ) from e


def _require_frames(fmt: str):
    pd = require("pandas")
    if fmt == "parquet":
        require("pyarrow")
    return pd


def _escape_label(label: str) -> str:
    # '_' is the combo separator and '.' enables '..' path traversal; quote()
    # leaves both unescaped, so escape them by hand — {'A','B_C'} vs
    # {'A_B','C'} stay distinct and (:`..`) cannot climb out of the graph dir
    return (
        urllib.parse.quote(label, safe="").replace("_", "%5F").replace(".", "%2E")
    )


def _combo_dir(labels) -> str:
    return "_".join(_escape_label(l) for l in sorted(labels)) or "__no_label__"


def _rel_dir(rel_type: str) -> str:
    return _escape_label(rel_type)


# ---------------------------------------------------------------------------
# canonical tables <-> pandas
# ---------------------------------------------------------------------------


def canonical_node_columns(graph, combo, ctx) -> Tuple[Any, Dict[str, T.CypherType]]:
    """Rows whose label set is EXACTLY ``combo``, as a DataFrame of columns
    id + props (reference ``MorpheusGraphExport.canonicalNodeTable``)."""
    from ..relational.ops import FilterOp

    op = graph.scan_operator("n", T.CTNodeType(frozenset(combo)), ctx)
    h = op.header
    v = h.var("n")
    # exact-combo filter: all other labels false
    for e in h.labels_for(v):
        if e.label not in combo:
            op = FilterOp(op, E.Not(e).with_type(T.CTBoolean))
    h = op.header
    prop_types = graph.schema.node_property_keys(frozenset(combo))
    pairs = [(h.column(h.id_expr(v)), "id")]
    for e in h.properties_for(v):
        if e.key in prop_types:
            pairs.append((h.column(e), e.key))
    t = op.table.project(pairs)
    return _table_to_pandas(t), {"id": T.CTInteger, **prop_types}


def canonical_rel_columns(graph, rel_type: str, ctx) -> Tuple[Any, Dict[str, T.CypherType]]:
    op = graph.scan_operator("r", T.CTRelationshipType(frozenset({rel_type})), ctx)
    h = op.header
    v = h.var("r")
    start = next(e for e in h.expressions_for(v) if isinstance(e, E.StartNode))
    end = next(e for e in h.expressions_for(v) if isinstance(e, E.EndNode))
    prop_types = graph.schema.relationship_property_keys(rel_type)
    pairs = [
        (h.column(h.id_expr(v)), "id"),
        (h.column(start), "source"),
        (h.column(end), "target"),
    ]
    for e in h.properties_for(v):
        if e.key in prop_types:
            pairs.append((h.column(e), e.key))
    t = op.table.project(pairs)
    return _table_to_pandas(t), {
        "id": T.CTInteger,
        "source": T.CTInteger,
        "target": T.CTInteger,
        **prop_types,
    }


def _table_to_pandas(t):
    """The table as a DataFrame equal to the reference's row-by-row build,
    dtypes included. A table with ``frame_columns`` (``CudaTable``) hands
    over whole columns: a numpy array where pandas would infer the same
    dtype from the values, else the decoded values."""
    pd = require("pandas")
    frame_columns = getattr(t, "frame_columns", None)
    if frame_columns is not None:
        cols: Dict[str, Any] = frame_columns()
    else:
        cols = {c: [] for c in t.physical_columns}
        for row in t.rows():
            for c in cols:
                cols[c].append(row.get(c))
    return pd.DataFrame(cols, columns=list(cols))


def _pandas_to_values(df, types: Dict[str, T.CypherType]) -> Dict[str, List]:
    out: Dict[str, List] = {}
    for c in df.columns:
        t = types.get(c)
        mat = t.material if t is not None else None
        vals = []
        for v in df[c].tolist():
            if v is None or (np.isscalar(v) and isinstance(v, float) and np.isnan(v)):
                vals.append(None)
            elif mat is T.CTInteger or c in _KEY_COLUMNS:
                vals.append(int(v))
            elif mat is T.CTFloat:
                vals.append(float(v))
            elif mat is T.CTBoolean:
                vals.append(bool(v))
            elif mat is T.CTString:
                vals.append(str(v))
            elif isinstance(v, np.ndarray):
                vals.append(v.tolist())
            else:
                vals.append(v)
        out[c] = vals
    return out


def _bulk_array(series, t: Optional[T.CypherType], key: bool) -> Optional[np.ndarray]:
    """``series`` as one numpy array when ``_pandas_to_values`` would give
    the same column kind, values and nulls: a null-free int64 column of an
    integer (or key) type, a NaN-free float64 column of a float type, a
    bool column of a boolean type. None sends the column by values."""
    if len(series) == 0:
        return None
    mat = t.material if t is not None else None
    kind = series.dtype.kind
    if kind == "i" and (mat is T.CTInteger or key):
        return series.to_numpy(dtype=np.int64)
    if kind == "f" and mat is T.CTFloat and not key and not series.isna().any():
        return series.to_numpy(dtype=np.float64)
    if kind == "b" and mat is T.CTBoolean and not key:
        return series.to_numpy(dtype=np.bool_)
    return None


def _frame_table(df, types: Dict[str, T.CypherType], table_cls, csv: bool):
    """A table of ``table_cls`` from a DataFrame read back from a part file:
    bulk columns (``_bulk_array``) by ``from_arrays``, the rest value by
    value as the reference's ``_read_df`` and ``_pandas_to_values`` decode
    them (CSV cells as objects with NA as None; encoded cells decoded into
    a column that pandas types anew, as the reference's column assignment
    does). ``Table.from_arrays`` turns arrays into the same values on a
    backend without a bulk path."""
    pd = require("pandas")
    cols: Dict[str, Any] = {}
    for c in df.columns:
        t = types.get(c)
        s = df[c]
        arr = _bulk_array(s, t, c in _KEY_COLUMNS)
        if arr is not None:
            cols[c] = arr
            continue
        if csv:
            s = s.astype(object).where(s.notna(), None)
        if _needs_encoding(t, csv=csv):
            s = pd.Series(
                [None if v is None else _decode_cell(v) for v in s.tolist()],
                index=s.index,
            )
        cols[c] = _pandas_to_values(s.to_frame(c), types)[c]
    return table_cls.from_arrays(cols)


# ---------------------------------------------------------------------------
# serialization of exotic values for parquet/csv
# ---------------------------------------------------------------------------

_JSON_TAG = "__tpu_cypher_json__:"


def _encode_cell(v):
    import datetime as _dt

    if isinstance(v, Duration):
        return _JSON_TAG + json.dumps(
            {"__duration__": [v.months, v.days, v.seconds, v.microseconds]}
        )
    if isinstance(v, _dt.datetime):
        return _JSON_TAG + json.dumps({"__localdatetime__": v.isoformat()})
    if isinstance(v, _dt.date):
        return _JSON_TAG + json.dumps({"__date__": v.isoformat()})
    if isinstance(v, (list, tuple, dict)):
        return _JSON_TAG + json.dumps(v)
    if isinstance(v, str):
        # protects CSV strings from NA-token mangling ('NA', 'null', '')
        return _JSON_TAG + json.dumps(v)
    return v


def _decode_cell(v):
    import datetime as _dt

    if isinstance(v, str) and v.startswith(_JSON_TAG):
        doc = json.loads(v[len(_JSON_TAG):])
        if isinstance(doc, dict) and "__duration__" in doc:
            m, d, s, us = doc["__duration__"]
            return Duration(m, d, s, us)
        if isinstance(doc, dict) and "__date__" in doc:
            return _dt.date.fromisoformat(doc["__date__"])
        if isinstance(doc, dict) and "__localdatetime__" in doc:
            return _dt.datetime.fromisoformat(doc["__localdatetime__"])
        return doc
    return v


def _needs_encoding(t: Optional[T.CypherType], csv: bool = False) -> bool:
    if t is None:
        return True
    m = t.material
    if csv and m is T.CTString:
        # CSV cannot distinguish null from 'NA'/'null'/'NaN'/'' — JSON-wrap
        return True
    return not (
        m is T.CTInteger or m is T.CTFloat or m is T.CTBoolean or m is T.CTString
    )


# ---------------------------------------------------------------------------
# the data source
# ---------------------------------------------------------------------------


class FSGraphSource(PropertyGraphDataSource):
    """Parquet/CSV graph persistence with the reference's directory layout."""

    def __init__(self, root: str, fmt: str = "parquet"):
        if fmt not in ("parquet", "csv"):
            raise DataSourceError(f"Unsupported format {fmt!r}")
        self.root = root
        self.fmt = fmt
        os.makedirs(root, exist_ok=True)

    # -- helpers -----------------------------------------------------------

    def _graph_dir(self, name: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(name, safe=""))

    def _part(self, d: str, fmt: Optional[str] = None) -> str:
        return os.path.join(d, f"part.{fmt or self.fmt}")

    def _write_df(self, df, types: Dict[str, T.CypherType], path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        df = df.copy()
        for c in df.columns:
            if _needs_encoding(types.get(c), csv=self.fmt == "csv"):
                df[c] = [
                    None if v is None else _encode_cell(v) for v in df[c].tolist()
                ]
        if self.fmt == "parquet":
            df.to_parquet(path, index=False)
        else:
            df.to_csv(path, index=False, na_rep="")

    def _read_raw(self, path: str, fmt: str):
        """The part file as pandas reads it, before any NA or cell decode."""
        pd = _require_frames(fmt)
        if not os.path.isfile(path):
            raise DataSourceError(f"Missing graph table file {path}")
        if fmt == "parquet":
            return pd.read_parquet(path)
        return pd.read_csv(path, keep_default_na=True)

    def _stored_format(self, name: str) -> str:
        """The format the graph was written with (``metadata.json``) — reads
        succeed even when the source is configured with the other format."""
        p = os.path.join(self._graph_dir(name), METADATA_FILE)
        if os.path.isfile(p):
            with open(p) as f:
                fmt = json.load(f).get("format")
            if fmt in ("parquet", "csv"):
                return fmt
        return self.fmt

    # -- PGDS --------------------------------------------------------------

    def has_graph(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._graph_dir(name), SCHEMA_FILE))

    def graph_names(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            urllib.parse.unquote(d)
            for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, SCHEMA_FILE))
        )

    def schema(self, name: str) -> Optional[PropertyGraphSchema]:
        p = os.path.join(self._graph_dir(name), SCHEMA_FILE)
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            return PropertyGraphSchema.from_json(f.read())

    def store(self, name: str, graph) -> None:
        if self.has_graph(name):
            raise DataSourceError(f"Graph {name!r} already exists; delete it first")
        _require_frames(self.fmt)
        d = self._graph_dir(name)
        schema = graph.schema
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, SCHEMA_FILE), "w") as f:
            f.write(schema.to_json())
        with open(os.path.join(d, METADATA_FILE), "w") as f:
            json.dump({"format": self.fmt, "version": 1}, f)
        ctx = _plain_ctx(graph)
        # table EXTRACTION stays serial (it drives the device); each file
        # WRITE is submitted to a thread pool AS extracted, so at most
        # pool-depth DataFrames are live at once and failures propagate
        # after all complete — the reference's async write discipline
        # (``AbstractPropertyGraphDataSource.scala:186``). The pool threads
        # touch host DataFrames only.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = []
            for combo in schema.label_combinations:
                df, types = canonical_node_columns(graph, combo, ctx)
                path = self._part(os.path.join(d, "nodes", _combo_dir(combo)))
                futures.append(pool.submit(self._write_df, df, types, path))
                del df
            for rt in schema.relationship_types:
                df, types = canonical_rel_columns(graph, rt, ctx)
                path = self._part(
                    os.path.join(d, "relationships", _rel_dir(rt))
                )
                futures.append(pool.submit(self._write_df, df, types, path))
                del df
            for f in futures:
                f.result()  # re-raises the worker's exception

    def graph(self, name: str, session):
        schema = self.schema(name)
        if schema is None:
            raise DataSourceError(f"Graph {name!r} not found under {self.root}")
        d = self._graph_dir(name)
        fmt = self._stored_format(name)
        csv = fmt == "csv"
        tables: List[ElementTable] = []
        for combo in schema.label_combinations:
            prop_types = schema.node_property_keys(combo)
            types = {"id": T.CTInteger, **prop_types}
            df = self._read_raw(
                self._part(os.path.join(d, "nodes", _combo_dir(combo)), fmt), fmt
            )
            mapping = NodeMapping(
                id_key="id",
                implied_labels=frozenset(combo),
                property_mapping=tuple(sorted((k, k) for k in prop_types)),
            )
            tables.append(
                ElementTable(mapping, _frame_table(df, types, session.table_cls, csv))
            )
        for rt in schema.relationship_types:
            prop_types = schema.relationship_property_keys(rt)
            types = {
                "id": T.CTInteger,
                "source": T.CTInteger,
                "target": T.CTInteger,
                **prop_types,
            }
            df = self._read_raw(
                self._part(os.path.join(d, "relationships", _rel_dir(rt)), fmt), fmt
            )
            mapping = RelationshipMapping(
                id_key="id",
                source_key="source",
                target_key="target",
                rel_type=rt,
                property_mapping=tuple(sorted((k, k) for k in prop_types)),
            )
            tables.append(
                ElementTable(mapping, _frame_table(df, types, session.table_cls, csv))
            )
        return ScanGraph(tables, schema)

    def delete(self, name: str) -> None:
        d = self._graph_dir(name)
        if os.path.isdir(d):
            shutil.rmtree(d)


def _plain_ctx(graph):
    """Runtime context for canonical-table extraction: the table factory is
    taken from the graph's own tables so empty scans (e.g. a union member
    lacking a relationship type) build tables of the right backend."""
    from ..relational.ops import RelationalRuntimeContext

    return RelationalRuntimeContext(
        resolve_graph=lambda qgn: None,
        parameters={},
        table_cls=_graph_table_cls(graph),
    )


def _graph_table_cls(graph):
    """The table class of the graph's own scans; a graph with none (the
    empty graph) extracts on ``CudaTable``, on the backend's device. The
    reference falls back to its host ``LocalTable`` there."""
    cls = _find_table_cls(graph)
    if cls is not None:
        return cls
    from ..backend.cuda.table import CudaTable

    return CudaTable


def _find_table_cls(graph):
    scans = getattr(graph, "scans", None)
    if scans:
        return type(scans[0].table)
    for member in getattr(graph, "members", []) or []:
        cls = _find_table_cls(member)
        if cls is not None:
            return cls
    inner = getattr(graph, "graph", None)
    if inner is not None:
        return _find_table_cls(inner)
    return None
