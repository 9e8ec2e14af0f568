"""Per-graph device-resident CSR index for the fused expand path.

The port of the slice's part of ``tpu_cypher/backend/tpu/graph_index.py``:
a compacted CSR of each relationship-type set, built ONCE per graph on the
host (numpy lexsort) and kept on the backend's device, reused by every
query (``GraphIndex.of(graph)`` hangs the cache off the graph object):

* ``node_ids``  — sorted unique int64 element ids; position = compact id
* per (types, orientation): ``row_ptr``/``col_idx`` int32 CSR plus
  ``edge_orig`` mapping CSR edge position -> row of the canonical
  relationship scan
* per label set: the canonical node scan plus ``row_map`` taking a compact
  id to its row in that scan (-1 = node lacks the labels)

Edge keys, bitmaps, dense forms and the undirected var-length CSR belong
to operators that later slices port (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...api import types as T
from ...ir import expr as E
from . import device as _device
from .column import Column, TpuBackendError, to_device

# canonical scan variable names (reserved: queries cannot produce '$' vars)
CANON_NODE = "$gi_n"
CANON_REL = "$gi_r"


class GraphIndexError(TpuBackendError):
    """The graph cannot be CSR-indexed (e.g. dangling endpoints)."""


def _host_logical(col: Column, size: int) -> np.ndarray:
    """Host int64 copy of a scan column's logical rows: the ingest-time
    host mirror when present, else one device fetch."""
    if col._np_cache is not None:
        return np.asarray(col._np_cache[:size], dtype=np.int64)
    return col.data[:size].to(torch.int64).cpu().numpy()


def rekey_element_expr(e: E.Expr, canon: E.Var) -> Optional[E.Expr]:
    """Rebuild an element sub-expression onto the canonical scan variable
    (structural equality ignores the attached type)."""
    if isinstance(e, E.Var):
        return canon
    if isinstance(e, E.Id):
        return E.Id(canon)
    if isinstance(e, E.StartNode):
        return E.StartNode(canon)
    if isinstance(e, E.EndNode):
        return E.EndNode(canon)
    if isinstance(e, E.HasLabel):
        return E.HasLabel(canon, e.label)
    if isinstance(e, E.HasType):
        return E.HasType(canon, e.rel_type)
    if isinstance(e, E.Property):
        return E.Property(canon, e.key)
    return None


class GraphIndex:
    """CSR + canonical-scan cache for one RelationalCypherGraph."""

    @staticmethod
    def of(graph) -> "GraphIndex":
        gi = getattr(graph, "_cuda_graph_index", None)
        if gi is None:
            gi = GraphIndex(graph)
            try:
                graph._cuda_graph_index = gi
            except AttributeError:  # exotic graph impl without __dict__
                pass
        return gi

    def __init__(self, graph):
        self.graph = graph
        self._node_ids: Optional[Tuple[Any, np.ndarray]] = None
        # labels_key -> (cols, header, row_map)
        self._node_scans: Dict[Tuple[str, ...], Tuple[Dict, Any, Any]] = {}
        # types_key -> (cols, header); logical row counts in _rel_sizes
        self._rel_scans: Dict[Tuple[str, ...], Tuple[Dict, Any]] = {}
        self._rel_sizes: Dict[Tuple[str, ...], int] = {}
        # (types_key, reverse) -> (row_ptr, col_idx, edge_orig) device tensors
        self._csr: Dict[Tuple[Tuple[str, ...], bool], Tuple[Any, Any, Any]] = {}
        # types_key -> device int64[num_nodes] self-loop counts
        self._loop_count: Dict[Tuple[str, ...], Any] = {}
        # labels_key -> device bool[num_nodes] or None (unrestricted)
        self._label_mask: Dict[Tuple[str, ...], Optional[Any]] = {}
        # labels_key -> host row_map copy
        self._row_map_np: Dict[Tuple[str, ...], np.ndarray] = {}

    # -- nodes -------------------------------------------------------------

    def node_ids(self, ctx) -> Tuple[Any, np.ndarray]:
        """(device sorted unique int64 ids, host copy)."""
        if self._node_ids is None:
            self.node_scan((), ctx)
        return self._node_ids

    @property
    def num_nodes(self) -> int:
        """Size of the compact-id space."""
        if self._node_ids is None:
            raise GraphIndexError("node ids not built yet")
        return int(self._node_ids[0].shape[0])

    def node_scan(self, labels: Tuple[str, ...], ctx):
        """Canonical node scan for a label set: (columns, header, row_map).
        ``row_map[compact_id]`` = row index into the scan's columns, or -1
        when the node does not carry the labels (fused label filtering)."""
        key = tuple(sorted(labels))
        got = self._node_scans.get(key)
        if got is not None:
            return got
        op = self.graph.scan_operator(
            CANON_NODE, T.CTNodeType(frozenset(labels)), ctx
        )
        table = op.table
        header = op.header
        id_col = table._cols[header.column(E.Id(E.Var(CANON_NODE)))]
        ids_np = _host_logical(id_col, table.size)
        if self._node_ids is None:
            if key != ():
                # the unrestricted scan defines the compact id space
                self.node_scan((), ctx)
            else:
                sorted_ids = np.sort(ids_np)
                if len(sorted_ids) and (sorted_ids[1:] == sorted_ids[:-1]).any():
                    raise GraphIndexError("duplicate node ids")
                self._node_ids = (to_device(sorted_ids), sorted_ids)
        _, all_ids = self._node_ids
        n = len(all_ids)
        pos = np.searchsorted(all_ids, ids_np)
        pos = np.clip(pos, 0, max(n - 1, 0))
        if len(ids_np) and not (all_ids[pos] == ids_np).all():
            raise GraphIndexError("node scan id outside the graph id space")
        row_map = np.full(n, -1, dtype=np.int64)
        row_map[pos] = np.arange(len(ids_np), dtype=np.int64)
        self._row_map_np[key] = row_map
        out = (table._cols, header, to_device(row_map))
        self._node_scans[key] = out
        return out

    def label_mask(self, labels: Tuple[str, ...], ctx) -> Optional[Any]:
        """Device bool[num_nodes]: node carries the label set. ``None`` for
        the empty set (every node qualifies)."""
        key = tuple(sorted(labels))
        if not key:
            return None
        if key not in self._label_mask:
            self.node_scan(key, ctx)
            self._label_mask[key] = to_device(self._row_map_np[key] >= 0)
        return self._label_mask[key]

    # -- relationships -----------------------------------------------------

    @staticmethod
    def types_key(types) -> Tuple[str, ...]:
        return tuple(sorted(types)) if types else ()

    def rel_scan(self, types_key: Tuple[str, ...], ctx):
        """Canonical relationship scan: (columns, header)."""
        got = self._rel_scans.get(types_key)
        if got is not None:
            return got
        op = self.graph.scan_operator(
            CANON_REL, T.CTRelationshipType(frozenset(types_key)), ctx
        )
        out = (op.table._cols, op.header)
        self._rel_scans[types_key] = out
        self._rel_sizes[types_key] = op.table.size
        return out

    def _edge_endpoints(self, types_key: Tuple[str, ...], ctx):
        """Resolve one type set's relationships to compact endpoint
        positions: (src_pos int64, dst_pos int64, num_nodes) — validates
        that every endpoint is a graph node."""
        cols, header = self.rel_scan(types_key, ctx)
        nrel = self._rel_sizes[types_key]
        rel = E.Var(CANON_REL)
        start = cols[header.column(E.StartNode(rel))]
        end = cols[header.column(E.EndNode(rel))]
        _, all_ids = self.node_ids(ctx)
        n = len(all_ids)
        s_ids = _host_logical(start, nrel)
        d_ids = _host_logical(end, nrel)
        s = np.clip(np.searchsorted(all_ids, s_ids), 0, max(n - 1, 0)).astype(np.int64)
        d = np.clip(np.searchsorted(all_ids, d_ids), 0, max(n - 1, 0)).astype(np.int64)
        if len(s_ids) and (
            not (all_ids[s] == s_ids).all() or not (all_ids[d] == d_ids).all()
        ):
            raise GraphIndexError("relationship endpoint not a graph node")
        return s, d, n

    @staticmethod
    def _sorted_csr(a: np.ndarray, b: np.ndarray, n: int):
        """Lexsort edges by (a, b) and build the row_ptr. Returns host
        (row_ptr, order, a_sorted); within every row the neighbour column
        is nondecreasing (asserted)."""
        order = np.lexsort((b, a))
        a_sorted = a[order]
        if len(order) > 1:
            b_sorted = b[order]
            in_row_order = (b_sorted[1:] >= b_sorted[:-1]) | (
                a_sorted[1:] != a_sorted[:-1]
            )
            if not in_row_order.all():
                raise GraphIndexError(
                    "CSR build violated the sorted-by-neighbor contract"
                )
        row_ptr = np.searchsorted(a_sorted, np.arange(n + 1)).astype(np.int32)
        return row_ptr, order, a_sorted

    def csr(self, types_key: Tuple[str, ...], reverse: bool, ctx):
        """(row_ptr, col_idx, edge_orig) int32/int32/int64 device tensors
        for one orientation of one relationship-type set."""
        got = self._csr.get((types_key, reverse))
        if got is not None:
            return got
        s, d, n = self._edge_endpoints(types_key, ctx)
        if len(s) >= 2**31:
            raise GraphIndexError("edge count exceeds the int32 CSR")
        a, b = (d, s) if reverse else (s, d)
        row_ptr, order, _ = self._sorted_csr(a, b, n)
        out = (
            to_device(row_ptr),
            to_device(b[order].astype(np.int32)),
            to_device(order.astype(np.int64)),
        )
        self._csr[(types_key, reverse)] = out
        if not reverse and types_key not in self._loop_count:
            loops = s[s == d]
            self._loop_count[types_key] = to_device(
                np.bincount(loops, minlength=n).astype(np.int64)
            )
        return out

    def loop_count(self, types_key: Tuple[str, ...], ctx):
        """Device int64[num_nodes]: self-loop edges per node."""
        if types_key not in self._loop_count:
            self.csr(types_key, False, ctx)
        return self._loop_count[types_key]

    # -- id -> compact mapping --------------------------------------------

    def compact_of(self, id_col: Column, ctx) -> Tuple[Any, Any]:
        """Map an int64 element-id column to (compact ids, present mask)."""
        from . import jit_ops as J

        dev_ids, _ = self.node_ids(ctx)
        ids = id_col.data
        if self.num_nodes == 0:
            dev = _device.get()
            z = torch.zeros(ids.shape[0], dtype=torch.int64, device=dev)
            return z, torch.zeros(ids.shape[0], dtype=torch.bool, device=dev)
        return J.compact_lookup(dev_ids, ids, id_col.valid)
