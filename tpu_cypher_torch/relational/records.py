"""Cypher records: user-facing result rows.

Re-design of ``RelationalCypherRecords``
(``okapi-relational/.../api/table/RelationalCypherRecords.scala:56``) and the
backends' ``rowToCypherMap``: materializes header columns back into Cypher
values (nodes/relationships reassembled from their id/label/property columns).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..api import types as T
from ..api.values import CypherMap, Node, Relationship
from ..ir import expr as E
from ..obs import trace as OT
from .header import RecordHeader


class RelationalCypherRecords:
    def __init__(self, header: RecordHeader, table, columns: Optional[Sequence[str]] = None):
        self.header = header
        self.table = table
        if columns is None:
            columns = [v.name for v in header.vars if not v.name.startswith("__")]
        self.columns = list(columns)
        # the owning query's span tree (set by CypherResult.records):
        # collect() re-enters it so device->host materialization — where
        # async dispatch drains — is attributed to the query
        self._trace: Optional[OT.QueryTrace] = None

    @property
    def size(self) -> int:
        return self.table.size

    def _materializers(self):
        from .materialize import (
            node_materializer,
            path_materializer,
            relationship_materializer,
        )

        h = self.header
        out = []
        for name in self.columns:
            var = h.var(name)
            m = (var.cypher_type or T.CTAny.nullable).material
            if h.has_path(name):
                out.append((name, path_materializer(h, var)))
            elif isinstance(m, T.CTNodeType):
                out.append((name, node_materializer(h, var)))
            elif isinstance(m, T.CTRelationshipType):
                out.append((name, relationship_materializer(h, var)))
            else:
                col = h.column(var)
                out.append((name, lambda r, c=col: r.get(c)))
        return out

    def collect(self) -> List[CypherMap]:
        if self._trace is None:
            mats = self._materializers()
            return [CypherMap((n, f(r)) for n, f in mats) for r in self.table.rows()]
        with OT.activate(self._trace):
            with OT.span("collect", kind="phase") as sp:
                mats = self._materializers()
                out = [
                    CypherMap((n, f(r)) for n, f in mats)
                    for r in self.table.rows()
                ]
                sp.note("rows", len(out))
        return out

    def iter_chunks(self, chunk_rows: int):
        """Yield ``CypherMap`` rows in bounded lists of ``chunk_rows`` —
        the cursor-streaming materialize step. Backed by the table's
        chunked decode (``CudaTable.rows_chunked``) when available, so a
        huge result never holds more than one decoded chunk of host
        values at a time; tables without a chunked path fall back to
        paging the fully-decoded row iterator (host backends, where the
        rows were Python objects all along)."""
        mats = self._materializers()
        chunk_rows = max(int(chunk_rows), 1)
        chunked = getattr(self.table, "rows_chunked", None)
        if chunked is not None:
            for rows in chunked(chunk_rows):
                yield [CypherMap((n, f(r)) for n, f in mats) for r in rows]
            return
        buf: List[CypherMap] = []
        for r in self.table.rows():
            buf.append(CypherMap((n, f(r)) for n, f in mats))
            if len(buf) >= chunk_rows:
                yield buf
                buf = []
        if buf:
            yield buf

    def to_bag(self):
        from ..testing.bag import Bag

        return Bag(self.collect())

    def to_pandas(self):
        """Result rows as a pandas DataFrame (the reference's
        ``DataFrameOutputExample`` direction: ``records.asDataFrame``).
        Elements render as their Cypher-value objects; plain columns keep
        native dtypes via the value rows."""
        import pandas as pd

        return pd.DataFrame(self.collect(), columns=self.columns)

    def show(self, n: int = 20) -> str:
        from ..utils.printer import format_rows

        rows = [[m[c] for c in self.columns] for m in self.collect()[: max(n, 0)]]
        return format_rows(self.columns, rows)

    # -- notebook / Zeppelin renderings (reference ZeppelinSupport) --------

    def to_table_tsv(self) -> str:
        from ..utils.visualization import records_to_table_tsv

        return records_to_table_tsv(self)

    def to_graph_json(self, indent: int = 2) -> str:
        from ..utils.visualization import records_to_graph_json

        return records_to_graph_json(self, indent)

    def _repr_html_(self) -> str:
        from ..utils.visualization import records_to_html

        return records_to_html(self)

    def __repr__(self) -> str:
        return f"CypherRecords({self.size} rows: {', '.join(self.columns)})"
