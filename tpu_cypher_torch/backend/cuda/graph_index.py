"""Per-graph device-resident CSR index for the fused expand path.

The port of the slice's part of ``tpu_cypher/backend/tpu/graph_index.py``:
a compacted CSR of each relationship-type set, built ONCE per graph on the
host (numpy lexsort) and kept on the backend's device, reused by every
query (``GraphIndex.of(graph)`` hangs the cache off the graph object):

* ``node_ids``  — sorted unique int64 element ids; position = compact id
* per (types, orientation): ``row_ptr``/``col_idx`` int32 CSR plus
  ``edge_orig`` mapping CSR edge position -> row of the canonical
  relationship scan, and the sorted int64 ``edge_keys`` ``a*N + b`` (key
  position i is CSR position i)
* per label set: the canonical node scan plus ``row_map`` taking a compact
  id to its row in that scan (-1 = node lacks the labels)

* per type set: ``rel_row_index`` (relationship ids sorted, with the
  canonical scan row of each), ``csr_undirected`` (the both-orientation
  CSR of the var-length walk) and ``edge_keys_by_orig`` (the ``src*N +
  dst`` key of each canonical scan row, for the closing probe's
  relationship uniqueness)

Serving threads share one index (``serve/session_pool.py`` runs each on
its own CUDA stream). An accessor returns a filled entry without a lock;
on a miss it fills under the index's lock, so two first queries build a
CSR once while the second waits. A fill fences its stream before it
stores an entry (``_publish``), so no thread reads a structure another
thread's stream is still writing. ``GraphIndex.of`` creates one index
per graph under a module lock. The reference hangs its cache off the
graph with no lock.

* per (array, mesh) under a mesh of more than one shard: the contiguous
  slices the mesh tiers read (``csr_shards``: the CSR ``col_idx`` with
  ``row_ptr`` on each shard's device, for the chain's SpMV;
  ``edge_key_shards``: the sorted ``edge_keys``, for the range count), a
  view on the home device and a copy on another, filled under the lock
  and published behind the fences as every other entry is

* the dense forms of the count tier (``expand_op``'s dense and tiled
  tiers): ``dense_adj``, one bf16[(Npad, Npad)] adjacency with edge
  multiplicities per (types, orientation), built on the device (the
  distinct ``a*Npad + b`` cells and their counts by ``torch.unique``,
  written into a zeroed bf16 matrix: no host ``np.add.at`` over an
  int32 Npad^2 array), and ``dense_tiles``, a ``DenseTiles`` provider of
  (block, Npad) row blocks densified on the device from the row-sorted
  edges, for graphs past ``dense_adj``'s node cap

The reference's host edge bitmap (``edge_bitmap``) is not ported: the
closing probe keeps the sorted-key form on every device, so the CPU runs
the path the card runs.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...api import types as T
from ...ir import expr as E
from ...obs import trace as _obs_trace
from ...obs.trace import sync as host_sync
from ...parallel import mesh as PM
from . import device as _device
from .column import Column, TpuBackendError, to_device

# canonical scan variable names (reserved: queries cannot produce '$' vars)
CANON_NODE = "$gi_n"
CANON_REL = "$gi_r"

# the largest edge multiplicity a bf16 cell holds exactly
BF16_EXACT_MAX = 256

_MISSING = object()


class GraphIndexError(TpuBackendError):
    """The graph cannot be CSR-indexed (e.g. dangling endpoints)."""


def _host_logical(col: Column, size: int) -> np.ndarray:
    """Host int64 copy of a scan column's logical rows: the ingest-time
    host mirror when present, else one device fetch."""
    if col._np_cache is not None:
        return np.asarray(col._np_cache[:size], dtype=np.int64)
    with host_sync("index"):
        # tpulint: allow[host-sync] reason=one fetch per index build, cached per graph: the ids' host mirror, not on the per-query path
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


_OF_LOCK = threading.Lock()


def _cached(peek):
    """A cache accessor: ``peek(self, *args)`` returns its filled entry
    (or ``None``) with no lock, since entries are stored only after the
    filling stream is fenced; a miss runs the accessor, which checks again,
    under the index's lock."""

    def wrap(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            got = peek(self, *args, **kwargs)
            if got is not None:
                return got
            with self._lock:
                return method(self, *args, **kwargs)

        return run

    return wrap


class GraphIndex:
    """CSR + canonical-scan cache for one RelationalCypherGraph."""

    @staticmethod
    def of(graph) -> "GraphIndex":
        gi = getattr(graph, "_cuda_graph_index", None)
        if gi is None:
            with _OF_LOCK:
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
        self._lock = threading.RLock()
        self._node_ids: Optional[Tuple[Any, np.ndarray]] = None
        # labels_key -> (cols, header, row_map)
        self._node_scans: Dict[Tuple[str, ...], Tuple[Dict, Any, Any]] = {}
        # types_key -> (cols, header); logical row counts in _rel_sizes
        self._rel_scans: Dict[Tuple[str, ...], Tuple[Dict, Any]] = {}
        self._rel_sizes: Dict[Tuple[str, ...], int] = {}
        # (types_key, reverse) -> (row_ptr, col_idx, edge_orig) device tensors
        self._csr: Dict[Tuple[Tuple[str, ...], bool], Tuple[Any, Any, Any]] = {}
        # types_key -> both-orientation (row_ptr, col_idx, edge_orig)
        self._csr_und: Dict[Tuple[str, ...], Tuple[Any, Any, Any]] = {}
        # types_key -> (sorted int64 rel ids, canonical scan row of each)
        self._rel_id_index: Dict[Tuple[str, ...], Tuple[Any, Any]] = {}
        # (types_key, reverse) -> (max degree, edge count), host ints read off
        # the host row_ptr at build
        self._csr_deg: Dict[Tuple[Tuple[str, ...], bool], Tuple[int, int]] = {}
        # (types_key, reverse) -> sorted int64 edge keys
        self._edge_keys: Dict[Tuple[Tuple[str, ...], bool], Any] = {}
        # types_key -> int64 (src*N + dst) key of each canonical rel-scan row
        self._keys_by_orig: Dict[Tuple[str, ...], Any] = {}
        # types_key -> device int64[num_nodes] self-loop counts
        self._loop_count: Dict[Tuple[str, ...], Any] = {}
        # labels_key -> device bool[num_nodes] or None (unrestricted)
        self._label_mask: Dict[Tuple[str, ...], Optional[Any]] = {}
        # labels_key -> host row_map copy
        self._row_map_np: Dict[Tuple[str, ...], np.ndarray] = {}
        # (types_key, reverse, max_nodes) -> (bf16 matrix, max entry, max
        # row sum), or None where the dense form does not apply
        self._dense_adj: Dict[Tuple, Optional[Tuple[Any, int, int]]] = {}
        # (types_key, reverse, block) -> DenseTiles or None
        self._dense_tiles: Dict[Tuple, Optional["DenseTiles"]] = {}
        # (kind, types_key, reverse, mesh) -> the per-shard slices of the
        # mesh tiers (``csr_shards``, ``edge_key_shards``)
        self._shards: Dict[Tuple, Any] = {}

    def _publish(self, cache: Dict, key, value):
        """Store a filled entry once this thread's device work is done:
        other lanes read it, with no lock, on streams of their own."""
        _device.fence()
        cache[key] = value
        return value

    # -- nodes -------------------------------------------------------------

    @_cached(lambda self, ctx: self._node_ids)
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

    @_cached(lambda self, labels, ctx: self._node_scans.get(tuple(sorted(labels))))
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
                dev_ids = to_device(sorted_ids)
                _device.fence()
                self._node_ids = (dev_ids, sorted_ids)
        _, all_ids = self._node_ids
        n = len(all_ids)
        pos = np.searchsorted(all_ids, ids_np)
        pos = np.clip(pos, 0, max(n - 1, 0))
        if len(ids_np) and not (all_ids[pos] == ids_np).all():
            raise GraphIndexError("node scan id outside the graph id space")
        row_map = np.full(n, -1, dtype=np.int64)
        row_map[pos] = np.arange(len(ids_np), dtype=np.int64)
        self._row_map_np[key] = row_map
        return self._publish(self._node_scans, key, (table._cols, header, to_device(row_map)))

    @_cached(lambda self, labels, ctx: self._label_mask.get(tuple(sorted(labels))))
    def label_mask(self, labels: Tuple[str, ...], ctx) -> Optional[Any]:
        """Device bool[num_nodes]: node carries the label set. ``None`` for
        the empty set (every node qualifies)."""
        key = tuple(sorted(labels))
        if not key:
            return None
        if key not in self._label_mask:
            self.node_scan(key, ctx)
            self._publish(self._label_mask, key, to_device(self._row_map_np[key] >= 0))
        return self._label_mask[key]

    # -- relationships -----------------------------------------------------

    @staticmethod
    def types_key(types) -> Tuple[str, ...]:
        return tuple(sorted(types)) if types else ()

    @_cached(lambda self, types_key, ctx: self._rel_scans.get(types_key))
    def rel_scan(self, types_key: Tuple[str, ...], ctx):
        """Canonical relationship scan: (columns, header)."""
        got = self._rel_scans.get(types_key)
        if got is not None:
            return got
        op = self.graph.scan_operator(
            CANON_REL, T.CTRelationshipType(frozenset(types_key)), ctx
        )
        self._rel_sizes[types_key] = op.table.size
        return self._publish(self._rel_scans, types_key, (op.table._cols, op.header))

    @_cached(lambda self, types_key, ctx: self._rel_id_index.get(types_key))
    def rel_row_index(self, types_key: Tuple[str, ...], ctx):
        """(sorted int64 relationship ids, int64 canonical scan row of each)
        device tensors: the bridge from a relationship element id to the
        scan row that ``csr``'s ``edge_orig`` carries, how a fixed rel of
        the input becomes a forbidden edge of a fused var-length walk."""
        got = self._rel_id_index.get(types_key)
        if got is None:
            cols, header = self.rel_scan(types_key, ctx)
            n = self._rel_sizes[types_key]
            id_col = cols[header.column(header.id_expr(header.var(CANON_REL)))]
            ids = _host_logical(id_col, n)
            order = np.argsort(ids, kind="stable").astype(np.int64)
            got = self._publish(self._rel_id_index, types_key,
                                (to_device(ids[order]), to_device(order)))
        return got

    def _edge_endpoints(self, types_key: Tuple[str, ...], ctx):
        """Resolve one type set's relationships to compact endpoint
        positions: (src_pos int64, dst_pos int64, num_nodes) — validates
        that every endpoint is a graph node. Host work over every edge,
        traced as an ``index`` span."""
        with _obs_trace.span("edge_endpoints", kind="index"):
            return self._map_endpoints(types_key, ctx)

    def _map_endpoints(self, types_key: Tuple[str, ...], ctx):
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

    @_cached(lambda self, types_key, reverse, ctx: self._csr.get((types_key, reverse)))
    def csr(self, types_key: Tuple[str, ...], reverse: bool, ctx):
        """(row_ptr, col_idx, edge_orig) int32/int32/int64 device tensors
        for one orientation of one relationship-type set."""
        got = self._csr.get((types_key, reverse))
        if got is not None:
            return got
        with _obs_trace.span("csr_build", kind="index", reverse=reverse):
            return self._build_csr(types_key, reverse, ctx)

    def _build_csr(self, types_key: Tuple[str, ...], reverse: bool, ctx):
        s, d, n = self._edge_endpoints(types_key, ctx)
        if len(s) >= 2**31:
            raise GraphIndexError("edge count exceeds the int32 CSR")
        a, b = (d, s) if reverse else (s, d)
        row_ptr, order, a_sorted = self._sorted_csr(a, b, n)
        b_sorted = b[order]
        key = (types_key, reverse)
        out = (
            to_device(row_ptr),
            to_device(b_sorted.astype(np.int32)),
            to_device(order.astype(np.int64)),
        )
        # this orientation is lexsorted by (a, b), so the a*N + b keys come
        # out sorted from the same order as col_idx/edge_orig: key position
        # i is CSR position i (the WCOJ materialize reads eo[lo + k]). The
        # CSR is unpadded, so the keys are too (no 1 << 62 sentinel lanes)
        keys = to_device(a_sorted.astype(np.int64) * n + b_sorted.astype(np.int64))
        loops = None
        if not reverse and types_key not in self._loop_count:
            loops = to_device(np.bincount(s[s == d], minlength=n).astype(np.int64))
        _device.fence()  # one fence publishes every entry of this build
        self._csr_deg[key] = (int(np.diff(row_ptr).max()) if n else 0, int(len(s)))
        self._edge_keys[key] = keys
        if loops is not None:
            self._loop_count[types_key] = loops
        self._csr[key] = out
        return out

    @_cached(lambda self, types_key, reverse, ctx:
             self._csr_deg.get((types_key, reverse)))
    def csr_degree_stats(
        self, types_key: Tuple[str, ...], reverse: bool, ctx
    ) -> Tuple[int, int]:
        """(max degree, edge count) of one CSR orientation, host-cached at
        build: no device read."""
        if (types_key, reverse) not in self._csr_deg:
            self.csr(types_key, reverse, ctx)
        return self._csr_deg[(types_key, reverse)]

    @_cached(lambda self, types_key, ctx: self._csr_und.get(types_key))
    def csr_undirected(self, types_key: Tuple[str, ...], ctx):
        """(row_ptr, col_idx, edge_orig) of the both-orientation graph of one
        type set: every relationship contributes an edge from each endpoint
        (a self-loop once), and both orientations carry the same canonical
        scan row in ``edge_orig``, so the walked-edge masks of a var-length
        walk (``orig != prev``) keep relationships unique across
        directions."""
        got = self._csr_und.get(types_key)
        if got is not None:
            return got
        with _obs_trace.span("csr_build", kind="index", undirected=True):
            s, d, n = self._edge_endpoints(types_key, ctx)
            nrel = len(s)
            nonloop = s != d
            a = np.concatenate([s, d[nonloop]])
            b = np.concatenate([d, s[nonloop]])
            if len(a) >= 2**31:
                raise GraphIndexError("edge count exceeds the int32 CSR")
            rows = np.arange(nrel, dtype=np.int64)
            eo = np.concatenate([rows, rows[nonloop]])
            row_ptr, order, _ = self._sorted_csr(a, b, n)
            got = (
                to_device(row_ptr),
                to_device(b[order].astype(np.int32)),
                to_device(eo[order]),
            )
        return self._publish(self._csr_und, types_key, got)

    @_cached(lambda self, types_key, ctx: self._loop_count.get(types_key))
    def loop_count(self, types_key: Tuple[str, ...], ctx):
        """Device int64[num_nodes]: self-loop edges per node."""
        if types_key not in self._loop_count:
            self.csr(types_key, False, ctx)
        return self._loop_count[types_key]

    @_cached(lambda self, types_key, ctx, reverse=False:
             self._edge_keys.get((types_key, reverse)))
    def edge_keys(self, types_key: Tuple[str, ...], ctx, reverse: bool = False):
        """Sorted int64 device keys for the WCOJ range probes: (src*N + dst)
        forward, (dst*N + src) with ``reverse=True``."""
        if (types_key, reverse) not in self._edge_keys:
            self.csr(types_key, reverse, ctx)
        return self._edge_keys[(types_key, reverse)]

    @_cached(lambda self, types_key, ctx: self._keys_by_orig.get(types_key))
    def edge_keys_by_orig(self, types_key: Tuple[str, ...], ctx):
        """int64[num_rels] device tensor: the (src*N + dst) probe key of each
        canonical rel-scan row, sized exactly. ``into_close_count_unique``
        subtracts a carried chain edge from a probe range exactly when its
        key equals the probe key (same key <=> same endpoints; the range
        covers every edge of the type set, so the carried edge is in it iff
        the keys match)."""
        got = self._keys_by_orig.get(types_key)
        if got is None:
            s, d, n = self._edge_endpoints(types_key, ctx)
            got = self._publish(self._keys_by_orig, types_key, to_device(
                s.astype(np.int64) * n + d.astype(np.int64)
            ))
        return got

    # -- per-shard slices of the mesh tiers -----------------------------

    def _shard_entry(self, key, mesh, fill):
        """A per-(array, mesh) slice entry: read without a lock, filled
        under the index's lock, published after the mesh's devices and the
        backend's stream are fenced (a slice on another card is a copy)."""
        got = self._shards.get(key)
        if got is not None:
            return got
        with self._lock:
            got = self._shards.get(key)
            if got is None:
                got = fill()
                PM.fence(mesh)
                got = self._publish(self._shards, key, got)
        return got

    def csr_shards(self, types_key: Tuple[str, ...], reverse: bool, ctx, mesh):
        """One CSR orientation over ``mesh`` for the mesh form of the count
        chain's SpMV: (``row_ptr`` on each shard's device, ``col_idx`` split
        into contiguous slices), made once per (orientation, mesh)."""
        rp, ci, _ = self.csr(types_key, reverse, ctx)
        return self._shard_entry(
            ("csr", types_key, reverse, mesh), mesh,
            lambda: (PM.replicate(mesh, rp), PM.split(mesh, ci)),
        )

    def edge_key_shards(self, types_key: Tuple[str, ...], ctx, reverse: bool, mesh):
        """The sorted ``edge_keys`` split into contiguous slices over
        ``mesh``, for the sharded range count (counts add over contiguous
        slices), made once per (orientation, mesh)."""
        keys = self.edge_keys(types_key, ctx, reverse=reverse)
        return self._shard_entry(
            ("keys", types_key, reverse, mesh), mesh, lambda: PM.split(mesh, keys)
        )

    # -- dense forms of the count tier ----------------------------------

    DENSE_BLOCK = 256  # row-block and pad quantum of the dense forms

    # cached-tile budget of the tiled tier: below this many matrix CELLS
    # the densified row blocks stay on the device across the contraction
    # loop; above it each tile is densified again on every request
    TILE_CACHE_CELLS = 1 << 30  # 2 GiB of bf16

    def _peek_or_fill(self, cache: Dict, key, fill):
        """A cached entry that may be None: read without a lock, filled
        under the index's lock and published behind ``_publish``'s fence."""
        got = cache.get(key, _MISSING)
        if got is not _MISSING:
            return got
        with self._lock:
            got = cache.get(key, _MISSING)
            if got is not _MISSING:
                return got
            return self._publish(cache, key, fill())

    def dense_adj(
        self, types_key: Tuple[str, ...], reverse: bool, ctx,
        max_nodes: Optional[int] = None,
    ) -> Optional[Tuple[Any, int, int]]:
        """Dense bf16[(Npad, Npad)] adjacency with edge-MULTIPLICITY
        entries for the dense count tier (``jit_ops.mxu_close_count`` /
        ``mxu_distinct_pairs``): 2-hop path counts as blocked ``A @ A`` on
        the tensor cores. Returns ``(matrix, max_entry, max_row_sum)``, the
        exactness metadata callers bound the float32 cells with, or None
        when the graph is past ``max_nodes`` or a multiplicity exceeds
        bf16's exact-integer range (256). Rows and columns past N are
        zero. ``max_nodes=None`` resolves through the cost model
        (``optimizer.cost.mxu_dense_node_cap``), which honours a
        ``TPU_CYPHER_MXU_DENSE_MAX`` pin verbatim."""
        if max_nodes is None:
            from ...optimizer.cost import mxu_dense_node_cap

            max_nodes = mxu_dense_node_cap()
        key = (types_key, reverse, max_nodes)
        return self._peek_or_fill(
            self._dense_adj, key,
            lambda: self._build_dense_adj(types_key, reverse, ctx, max_nodes),
        )

    def _build_dense_adj(self, types_key, reverse, ctx, max_nodes):
        self.node_ids(ctx)
        n = self.num_nodes
        if not 0 < n <= max_nodes:
            return None  # the size gate, before any per-edge work
        with _obs_trace.span("dense_adj", kind="index", reverse=reverse):
            s, d, _ = self._edge_endpoints(types_key, ctx)
            a, b = (d, s) if reverse else (s, d)
            block = self.DENSE_BLOCK
            npad = -(-n // block) * block
            dev = _device.get()
            dense = torch.zeros(npad * npad, dtype=torch.bfloat16, device=dev)
            if len(a) == 0:
                return dense.view(npad, npad), 0, 0
            rows = to_device(a)
            cols = to_device(b)
            with host_sync("index"):
                cells, counts = torch.unique(rows * npad + cols, return_counts=True)
            with host_sync("index"):
                # tpulint: allow[host-sync] reason=one read per dense-tier build, cached per (graph, types, orientation): the bf16 exactness gate
                max_entry = int(counts.max())
            if max_entry > BF16_EXACT_MAX:
                return None
            dense[cells] = counts.to(torch.bfloat16)
            with host_sync("index"):
                # tpulint: allow[host-sync] reason=one read per dense-tier build, cached per (graph, types, orientation): the bf16 exactness gate
                max_row_sum = int(torch.bincount(rows, minlength=n).max())
            return dense.view(npad, npad), max_entry, max_row_sum

    def dense_tiles(
        self, types_key: Tuple[str, ...], reverse: bool, ctx,
        block: Optional[int] = None,
    ) -> Optional["DenseTiles"]:
        """Row-block provider for the TILED count tier: (block, Npad) bf16
        slices of the dense multiplicity adjacency densified on demand, so
        no (Npad, Npad) matrix exists and ``dense_adj``'s node cap does not
        apply. None when a multiplicity exceeds bf16's exact-integer range
        or the graph has no node."""
        b = block or self.DENSE_BLOCK
        return self._peek_or_fill(
            self._dense_tiles, (types_key, reverse, b),
            lambda: self._build_dense_tiles(types_key, reverse, ctx, b),
        )

    def _build_dense_tiles(self, types_key, reverse, ctx, block):
        self.node_ids(ctx)
        n = self.num_nodes
        if n == 0:
            return None
        s, d, _ = self._edge_endpoints(types_key, ctx)
        a, b = (d, s) if reverse else (s, d)
        if len(a) == 0:
            empty = np.zeros(0, np.int64)
            return DenseTiles(n, block, empty, empty, 0, 0)
        # exactness metadata without densifying: multiplicity = duplicate
        # (row, col) count; row sum = out-degree
        _, counts = np.unique(a * np.int64(n) + b, return_counts=True)
        max_entry = int(counts.max())
        if max_entry > BF16_EXACT_MAX:
            return None
        order = np.argsort(a, kind="stable")
        return DenseTiles(
            n, block, a[order], b[order], max_entry,
            int(np.bincount(a, minlength=n).max()),
        )

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


class DenseTiles:
    """On-demand (block, Npad) bf16 row blocks of a dense multiplicity
    adjacency, densified on the device from the row-sorted edge list: the
    tiled count tier's matrix view. Tiles stay cached on the device when
    the full matrix is under ``GraphIndex.TILE_CACHE_CELLS``; past it each
    request densifies again (the tier is then a forced path for
    correctness, not speed). A tile is published to the cache behind a
    fence, as the index's own entries are."""

    def __init__(self, n, block, rows_sorted, cols_sorted, max_entry, max_row_sum,
                 device=None):
        self.n = int(n)
        self.block = int(block)
        self.npad = -(-self.n // self.block) * self.block
        self.nblocks = self.npad // self.block
        rows = np.asarray(rows_sorted, dtype=np.int64)
        self._bounds = np.searchsorted(
            rows, np.arange(self.nblocks + 1, dtype=np.int64) * self.block
        )
        self._device = _device.get() if device is None else torch.device(device)
        self._rows = torch.as_tensor(rows, device=self._device)
        self._cols = torch.as_tensor(np.asarray(cols_sorted, dtype=np.int64),
                                     device=self._device)
        self.max_entry = max_entry
        self.max_row_sum = max_row_sum
        self._cache = (
            {} if self.npad * self.npad <= GraphIndex.TILE_CACHE_CELLS else None
        )

    def tile(self, i: int):
        if self._cache is not None:
            got = self._cache.get(i)
            if got is not None:
                return got
        lo, hi = int(self._bounds[i]), int(self._bounds[i + 1])
        dense = torch.zeros(self.block * self.npad, dtype=torch.bfloat16,
                            device=self._device)
        if hi > lo:
            cells = (self._rows[lo:hi] - i * self.block) * self.npad + self._cols[lo:hi]
            with host_sync("index"):
                cells, counts = torch.unique(cells, return_counts=True)
            dense[cells] = counts.to(torch.bfloat16)
        out = dense.view(self.block, self.npad)
        if self._cache is not None:
            _device.fence()
            self._cache[i] = out
        return out
