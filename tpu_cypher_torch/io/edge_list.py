"""Edge-list graph source.

The port of ``tpu_cypher/io/edge_list.py``, itself a re-design of the
Morpheus ``EdgeListDataSource``
(``morpheus/.../api/io/EdgeListDataSource.scala:42-110``): loads SNAP-style
``src dst`` whitespace/comma-separated edge lists as the fixed schema
``(:V)-[:E]->(:V)``. Lines starting with ``#`` are comments. Node ids are
the union of endpoint ids; edge ids are the line index tagged into a
separate range so they never collide with node ids (both live in the same
int64 id space). The default format parses with the native C++ tier
(``native.parse_edge_list_native``) when it built, else line by line here;
the tables are made from the parsed arrays (``table_cls.from_arrays``), so
a CUDA session's columns go to the card in one copy each."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..api.mapping import NodeMapping, RelationshipMapping
from ..api.schema import PropertyGraphSchema
from ..relational.graphs import ElementTable, ScanGraph
from .datasource import DataSourceError, PropertyGraphDataSource

NODE_LABEL = "V"
REL_TYPE = "E"

# edge ids are offset into the top half of the non-tagged id space so they
# never collide with node ids (graph tags live in bits 54+, see PrefixId)
EDGE_ID_OFFSET = 1 << 53


def load_edge_list(path: str, session, delimiter: Optional[str] = None) -> ScanGraph:
    src_a: Optional[np.ndarray] = None
    if delimiter is None:  # native fast path handles the default format
        from ..native import parse_edge_list_native

        with open(path, "rb") as fb:
            data = fb.read()
        try:
            parsed = parse_edge_list_native(data)
        except ValueError as e:
            raise DataSourceError(f"Malformed edge list {path!r}: {e}")
        if parsed is not None:
            src_a, dst_a = parsed
    if src_a is None:
        src: List[int] = []
        dst: List[int] = []
        with open(path) as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.replace(",", " ").split() if delimiter is None else line.split(delimiter)
                try:
                    src.append(int(parts[0]))
                    dst.append(int(parts[1]))
                except (IndexError, ValueError) as e:
                    raise DataSourceError(
                        f"Malformed edge-list line {lineno} in {path!r}: {line!r} ({e})"
                    )
        src_a = np.asarray(src, dtype=np.int64)
        dst_a = np.asarray(dst, dtype=np.int64)
    node_ids = np.unique(np.concatenate([src_a, dst_a])) if len(src_a) else np.zeros(0, np.int64)
    if len(src_a) and int(node_ids.max(initial=0)) >= EDGE_ID_OFFSET:
        raise DataSourceError("Edge-list node ids exceed the supported id range")
    edge_ids = np.arange(len(src_a), dtype=np.int64) + EDGE_ID_OFFSET

    node_table = session.table_cls.from_arrays({"id": node_ids})
    rel_table = session.table_cls.from_arrays(
        {"id": edge_ids, "source": src_a, "target": dst_a}
    )
    schema = (
        PropertyGraphSchema.empty()
        .with_node_combination(frozenset({NODE_LABEL}), {})
        .with_relationship_type(REL_TYPE, {})
    )
    return ScanGraph(
        [
            ElementTable(
                NodeMapping(id_key="id", implied_labels=frozenset({NODE_LABEL})),
                node_table,
            ),
            ElementTable(
                RelationshipMapping(
                    id_key="id", source_key="source", target_key="target", rel_type=REL_TYPE
                ),
                rel_table,
            ),
        ],
        schema,
    )


class EdgeListDataSource(PropertyGraphDataSource):
    """Maps graph names to ``<root>/<name>`` edge-list files."""

    def __init__(self, root: str, delimiter: Optional[str] = None):
        self.root = root
        self.delimiter = delimiter

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def has_graph(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def graph_names(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(f for f in os.listdir(self.root) if os.path.isfile(self._path(f)))

    def schema(self, name: str):
        return (
            PropertyGraphSchema.empty()
            .with_node_combination(frozenset({NODE_LABEL}), {})
            .with_relationship_type(REL_TYPE, {})
        )

    def graph(self, name: str, session):
        if not self.has_graph(name):
            raise DataSourceError(f"No edge list {name!r} under {self.root}")
        return load_edge_list(self._path(name), session, self.delimiter)

    def store(self, name: str, graph) -> None:
        raise DataSourceError("EdgeListDataSource is read-only")

    def delete(self, name: str) -> None:
        raise DataSourceError("EdgeListDataSource is read-only")
