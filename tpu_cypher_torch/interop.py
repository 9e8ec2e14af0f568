"""Carry graph state into the port from plain numpy arrays.

``graph_from_arrays`` builds the port's Person/KNOWS property graph from
arrays — the same assembly as ``io.ldbc.generate_snb`` (element ids as
given, KNOWS relationship ids ``EDGE_ID_OFFSET + i`` in edge order) — so
that a caller holding another engine's graph as arrays (the differential
tests read the JAX package's element tables with ``np.asarray``) runs the
port on identical state. Only numpy crosses the boundary.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .api import types as T
from .io.ldbc import _graph_from_arrays
from .relational.session import PropertyGraph


def graph_from_arrays(
    session,
    node_ids: np.ndarray,
    node_cols: Dict[str, object],
    prop_types: Dict[str, T.CypherType],
    src: np.ndarray,
    dst: np.ndarray,
) -> PropertyGraph:
    """Person nodes with ids ``node_ids`` and property columns
    ``node_cols`` (name -> numpy array or value list, typed by
    ``prop_types``), and one directed KNOWS relationship per
    ``(src[i], dst[i])`` pair of node ids."""
    ids = np.asarray(node_ids, dtype=np.int64)
    cols: Dict[str, object] = {"id": ids}
    cols.update({k: v for k, v in node_cols.items() if k != "id"})
    if "id" in node_cols and not np.array_equal(np.asarray(node_cols["id"]), ids):
        raise ValueError("node_cols['id'] disagrees with node_ids")
    g = _graph_from_arrays(
        session,
        ids,
        cols,
        dict(prop_types),
        np.asarray(src, dtype=np.int64),
        np.asarray(dst, dtype=np.int64),
        undirected_knows=False,
    )
    return PropertyGraph(session, g)
