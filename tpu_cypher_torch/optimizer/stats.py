"""Per-graph statistics: the cardinalities the cost model composes.

Collected lazily from the graph's own scan machinery and cached ON the
graph object (the ``GraphIndex.of`` idiom — graphs are immutable here, so
object identity IS the statistics version; a rebuilt graph gets fresh
statistics). Three families:

* **label cardinalities** — logical row counts of the canonical node scan
  per label set (and the unrestricted scan, which defines the node space);
* **relationship-type cardinalities** — logical row counts of the
  canonical relationship scan per type set;
* **degree distributions** — per (type set, orientation): max degree and a
  log2-bucket out-degree histogram, computed on the HOST from the same
  endpoint arrays every CSR build starts from
  (``GraphIndex._edge_endpoints``), so no extra device sync is paid.

On the host-oracle backend (no ``GraphIndex``) the degree family degrades
to the average-degree estimate ``rels / nodes``; cardinalities work on
every backend because they only read ``table.size``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

from ..api import types as T

# scan variable used for statistics-only scans; never escapes this module
_STATS_VAR = "__opt_stats"


class GraphStatistics:
    """Lazily populated per-graph statistics. ``of`` caches one instance
    per graph object; every accessor memoizes per key."""

    @staticmethod
    def of(graph, ctx) -> "GraphStatistics":
        got = getattr(graph, "_tpu_cypher_opt_stats", None)
        if got is None:
            got = GraphStatistics(graph)
            try:
                graph._tpu_cypher_opt_stats = got
            except AttributeError:  # exotic graph impl without __dict__
                pass
        got._ctx = ctx  # scans only need *a* runtime context; any works
        return got

    def __init__(self, graph):
        self.graph = graph
        self._ctx = None
        self._node_counts: Dict[Tuple[str, ...], int] = {}
        self._rel_counts: Dict[Tuple[str, ...], int] = {}
        # (types_key, reverse) -> (max_degree, log2-bucket histogram)
        self._degrees: Dict[Tuple[Tuple[str, ...], bool], Tuple[int, Tuple[int, ...]]] = {}
        self._fingerprint: Optional[str] = None

    # -- cardinalities ---------------------------------------------------

    @staticmethod
    def labels_key(labels) -> Tuple[str, ...]:
        return tuple(sorted(labels)) if labels else ()

    def node_count(self, labels=()) -> int:
        """Logical row count of the canonical node scan for a label set."""
        key = self.labels_key(labels)
        got = self._node_counts.get(key)
        if got is None:
            op = self.graph.scan_operator(
                _STATS_VAR, T.CTNodeType(frozenset(key)), self._ctx
            )
            got = self._node_counts[key] = int(op.table.size)
        return got

    def rel_count(self, types=()) -> int:
        """Logical row count of the canonical relationship scan for a
        type set."""
        key = self.labels_key(types)
        got = self._rel_counts.get(key)
        if got is None:
            op = self.graph.scan_operator(
                _STATS_VAR, T.CTRelationshipType(frozenset(key)), self._ctx
            )
            got = self._rel_counts[key] = int(op.table.size)
        return got

    def label_selectivity(self, labels=()) -> float:
        """Fraction of all nodes carrying the label set (1.0 for the
        unrestricted set; an empty graph reads as fully selective)."""
        if not labels:
            return 1.0
        total = self.node_count(())
        if total <= 0:
            return 1.0
        return min(self.node_count(labels) / total, 1.0)

    # -- degree distributions --------------------------------------------

    def avg_degree(self, types=(), reverse: bool = False) -> float:
        """Mean out-degree (``reverse`` = in-degree) over ALL nodes for a
        type set — the uniform-fanout expand estimate."""
        n = self.node_count(())
        return self.rel_count(types) / max(n, 1)

    def degree_stats(
        self, types=(), reverse: bool = False
    ) -> Tuple[int, Tuple[int, ...]]:
        """(max_degree, log2-bucket histogram) for one orientation.
        Bucket ``i`` counts nodes with degree in ``[2^i, 2^(i+1))`` (bucket
        0 holds degree-1 nodes; degree-0 nodes are uncounted). Degrades to
        an average-degree singleton on backends without a ``GraphIndex``."""
        key = (self.labels_key(types), bool(reverse))
        got = self._degrees.get(key)
        if got is not None:
            return got
        got = self._degree_stats_host(key[0], key[1])
        if got is None:
            import math

            avg = self.avg_degree(types, reverse)
            est_max = int(math.ceil(avg)) * 4 + 1
            got = (est_max, (self.node_count(()),) if avg > 0 else ())
        self._degrees[key] = got
        return got

    def max_degree(self, types=(), reverse: bool = False) -> int:
        return self.degree_stats(types, reverse)[0]

    def _degree_stats_host(self, types_key, reverse: bool):
        """Exact degree distribution from the host endpoint arrays the CSR
        build resolves anyway; None when this graph has no GraphIndex
        (host-oracle backend)."""
        import numpy as np

        from ..backend.cuda.graph_index import GraphIndex
        from ..errors import reraise_if_device

        try:
            gi = GraphIndex.of(self.graph)
            gi.node_ids(self._ctx)
            s, d, n = gi._edge_endpoints(types_key, self._ctx)
        except Exception as exc:
            reraise_if_device(exc, site="optimizer.stats")
            return None
        ends = d if reverse else s
        if len(ends) == 0:
            return 0, ()
        degs = np.bincount(ends, minlength=n)
        degs = degs[degs > 0]
        max_deg = int(degs.max()) if degs.size else 0
        if max_deg <= 0:
            return 0, ()
        hist = np.bincount(
            np.floor(np.log2(degs)).astype(np.int64),
            minlength=int(np.floor(np.log2(max_deg))) + 1,
        )
        return max_deg, tuple(int(x) for x in hist)

    # -- identity ---------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable per-graph key for persisted calibration: a digest of the
        schema's label/type cardinalities. Computed from counts already
        gathered plus the unrestricted scans, so two processes ingesting
        the same graph agree on the key."""
        if self._fingerprint is None:
            parts = [f"n={self.node_count(())}", f"r={self.rel_count(())}"]
            schema = getattr(self.graph, "schema", None)
            if schema is not None:
                for lbl in sorted(getattr(schema, "labels", ()) or ()):
                    parts.append(f"l:{lbl}={self.node_count((lbl,))}")
                for typ in sorted(
                    getattr(schema, "relationship_types", ()) or ()
                ):
                    parts.append(f"t:{typ}={self.rel_count((typ,))}")
            digest = hashlib.sha256("|".join(parts).encode()).hexdigest()
            self._fingerprint = digest[:16]
        return self._fingerprint


def seed_statistics(
    graph,
    *,
    node_counts: Dict[Tuple[str, ...], int],
    rel_counts: Dict[Tuple[str, ...], int],
    fingerprint: str,
) -> GraphStatistics:
    """Stamp pre-computed statistics onto a graph object — the incremental
    versioning path for mutation snapshots (``storage/delta.py``). The
    mutable store maintains total and single-label/type cardinalities
    per write batch and chains the fingerprint
    (``advance_fingerprint``), so every snapshot carries exact counts and
    a batch-unique fingerprint with NO rescan; compound label-set counts
    and degree families stay lazy and compute against the (immutable)
    snapshot on demand. Because ``of`` caches on the graph attribute this
    writes, seeded statistics win over lazy collection."""
    st = GraphStatistics(graph)
    st._node_counts.update(node_counts)
    st._rel_counts.update(rel_counts)
    st._fingerprint = fingerprint
    try:
        graph._tpu_cypher_opt_stats = st
    except AttributeError:  # pragma: no cover - exotic graph without __dict__
        pass
    return st
