"""Delta-CSR mutation layer: immutable base + bucket-padded delta overlay.

Layout (docs/mutation.md): the graph a reader scans is always a
**snapshot** — either the immutable base ``ScanGraph`` alone (no pending
delta) or a :class:`SnapshotGraph` unioning three members in keep-first
dedup order::

    [ delta-live, delta-dead, base ]

* **delta-live** holds every element created or rewritten since the last
  compaction (rewrites carry the FULL post-image property row);
* **delta-dead** holds one tombstone row (``__dead = true``) per base
  element that was deleted or rewritten, placed in the element's BASE
  label-combo/type table so the stale base row loses the dedup race;
* **base** is the last compaction's ``ScanGraph`` — bucket-padded,
  CSR-indexed, plan-cached, never touched by writes.

Dedup on element id keeps the FIRST member's row, then a fixed
``__dead IS NULL`` filter drops tombstones and pad lanes. All
data-dependence lives in table DATA: with bucketing on, delta tables are
host-padded to the bucket lattice with dead pad rows, so consecutive
write batches (and compactions, which fold the delta back into a
bucket-padded base) reuse the same compiled programs.

Durability: ``commit`` appends the batch to the WAL (fsync = commit
point) before applying it in memory; ``serve/worker.py`` boot replays the
WAL after its graph-CREATE replay, reconstructing committed state
byte-identically. Writers never block readers: a query pins the snapshot
object it started with; a commit publishes a new one.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import itertools
import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..api import types as T
from ..api.mapping import NodeMapping, NodeMappingBuilder, RelationshipMappingBuilder
from ..api.schema import PropertyGraphSchema
from ..api.values import Duration, Node, Relationship
from ..backend.cuda import device as _device
from ..errors import MutationError
from ..ir import expr as E
from ..relational.graphs import (
    ElementTable,
    RelationalCypherGraph,
    ScanGraph,
    TableOp,
    _member_union_scan,
)
from ..runtime import faults as F
from ..utils.config import COMPACT_DELTA_MAX, COMPACT_MIN_BUCKET
from .wal import WriteAheadLog

# reserved system property marking tombstone + pad rows; null on every live
# row (so it never surfaces in materialized element properties) and
# rejected in user property maps
DEAD_KEY = "__dead"


# ---------------------------------------------------------------------------
# write batches
# ---------------------------------------------------------------------------


class WriteBatch:
    """The effect record of one committed write query — explicit ids and
    post-image rows, so applying a batch is deterministic everywhere it
    happens (live commit, WAL replay, cross-process catch-up)."""

    __slots__ = (
        "nodes_created",
        "rels_created",
        "nodes_rewritten",
        "rels_rewritten",
        "nodes_deleted",
        "rels_deleted",
    )

    def __init__(self):
        # (id, sorted labels, props) / (id, src, dst, type, props)
        self.nodes_created: List[Tuple[int, Tuple[str, ...], Dict[str, Any]]] = []
        self.rels_created: List[Tuple[int, int, int, str, Dict[str, Any]]] = []
        self.nodes_rewritten: List[Tuple[int, Tuple[str, ...], Dict[str, Any]]] = []
        self.rels_rewritten: List[Tuple[int, int, int, str, Dict[str, Any]]] = []
        self.nodes_deleted: List[int] = []
        self.rels_deleted: List[int] = []

    def is_empty(self) -> bool:
        return not (
            self.nodes_created
            or self.rels_created
            or self.nodes_rewritten
            or self.rels_rewritten
            or self.nodes_deleted
            or self.rels_deleted
        )

    def to_json(self) -> Dict[str, Any]:
        """JSON-safe form; a temporal property value rides as a tagged
        ``{"$temporal": [kind, text]}`` (``_temporal_to_json``), every
        other value as itself."""
        j = _props_to_json
        return {
            "nc": [[i, list(l), j(p)] for i, l, p in self.nodes_created],
            "rc": [[i, s, d, t, j(p)] for i, s, d, t, p in self.rels_created],
            "nw": [[i, list(l), j(p)] for i, l, p in self.nodes_rewritten],
            "rw": [[i, s, d, t, j(p)] for i, s, d, t, p in self.rels_rewritten],
            "nd": list(self.nodes_deleted),
            "rd": list(self.rels_deleted),
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "WriteBatch":
        b = WriteBatch()
        j = _props_from_json
        b.nodes_created = [(i, tuple(l), j(p)) for i, l, p in d.get("nc", ())]
        b.rels_created = [(i, s, dd, t, j(p)) for i, s, dd, t, p in d.get("rc", ())]
        b.nodes_rewritten = [(i, tuple(l), j(p)) for i, l, p in d.get("nw", ())]
        b.rels_rewritten = [(i, s, dd, t, j(p)) for i, s, dd, t, p in d.get("rw", ())]
        b.nodes_deleted = list(d.get("nd", ()))
        b.rels_deleted = list(d.get("rd", ()))
        return b

    def digest(self) -> str:
        """Canonical content digest — the fingerprint-chain increment."""
        text = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()[:16]


_TEMPORAL_TAG = "$temporal"


def _temporal_to_json(v: Any) -> Any:
    """A property value in its JSON form: a date, time, datetime or
    duration as ``{"$temporal": [kind, text(, zone)]}`` (a property value
    is never a map, so the tag cannot collide), a list element by element,
    anything else as itself."""
    if isinstance(v, list):
        return [_temporal_to_json(x) for x in v]
    if isinstance(v, Duration):
        return {_TEMPORAL_TAG: ["duration", [v.months, v.days, v.seconds, v.microseconds]]}
    if isinstance(v, _dt.datetime):
        if v.tzinfo is None:
            return {_TEMPORAL_TAG: ["localdatetime", v.isoformat()]}
        zone = getattr(v.tzinfo, "key", None)  # a zone named by region
        return {_TEMPORAL_TAG: ["datetime", v.isoformat()] + ([zone] if zone else [])}
    if isinstance(v, _dt.date):
        return {_TEMPORAL_TAG: ["date", v.isoformat()]}
    if isinstance(v, _dt.time):
        return {_TEMPORAL_TAG: ["localtime" if v.tzinfo is None else "time", v.isoformat()]}
    return v


def _temporal_from_json(v: Any) -> Any:
    """The inverse of ``_temporal_to_json``."""
    if isinstance(v, list):
        return [_temporal_from_json(x) for x in v]
    if not (isinstance(v, dict) and _TEMPORAL_TAG in v):
        return v
    kind, text, *zone = v[_TEMPORAL_TAG]
    if kind == "duration":
        m, d, sec, us = text
        return Duration(months=m, days=d, seconds=sec, microseconds=us)
    if kind == "date":
        return _dt.date.fromisoformat(text)
    if kind in ("time", "localtime"):
        return _dt.time.fromisoformat(text)
    out = _dt.datetime.fromisoformat(text)
    if zone:
        from zoneinfo import ZoneInfo

        out = out.astimezone(ZoneInfo(zone[0]))
    return out


def _props_to_json(props: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _temporal_to_json(v) for k, v in props.items()}


def _props_from_json(props: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _temporal_from_json(v) for k, v in props.items()}


def advance_fingerprint(prev: str, batch_digest: str) -> str:
    """Chain the statistics fingerprint one write batch forward. Chained
    (not recomputed from counts) so even a cardinality-neutral batch — a
    pure property SET — moves the fingerprint and invalidates stale
    result-cache entries."""
    return hashlib.sha256(f"{prev}|{batch_digest}".encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# snapshot graph
# ---------------------------------------------------------------------------


class SnapshotGraph(RelationalCypherGraph):
    """One immutable ``(base, delta)`` pair. Readers pin the instance they
    started with; commits publish a new one. Scans union
    ``[delta-live, delta-dead, base]`` with keep-first dedup on id, then
    filter ``__dead IS NULL`` — a FIXED program shape, so consecutive
    snapshots replan on the host but reuse compiled device programs."""

    def __init__(
        self,
        base: RelationalCypherGraph,
        live: Optional[ScanGraph],
        dead: Optional[ScanGraph],
        version: int,
    ):
        self.base = base
        self.live = live
        self.dead = dead
        self.version = version
        self.members: List[RelationalCypherGraph] = [
            g for g in (live, dead) if g is not None
        ] + [base]
        schema = PropertyGraphSchema.empty()
        for g in self.members:
            schema = schema + g.schema
        self.schema = schema
        self._scan_cache: Dict[Tuple[str, object], tuple] = {}
        self._scan_lock = threading.Lock()

    def scan_operator(self, var_name, ct, ctx):
        # one union materialization per (snapshot, var, type): the
        # snapshot is immutable, so the merged scan table is too. Without
        # the memo every query between two commits replays the
        # union+dedup+dead-filter dispatches — and under a serving pool
        # every in-flight lane replays them concurrently, which is where
        # mixed read/write traffic loses its read throughput. The lock
        # makes racing lanes share one build instead of duplicating it.
        key = (var_name, ct)
        hit = self._scan_cache.get(key)
        if hit is None:
            with self._scan_lock:
                hit = self._scan_cache.get(key)
                if hit is None:
                    op = self._build_scan(var_name, ct, ctx)
                    hit = (op.header, op.table)
                    _device.fence()  # other lanes read it on their own streams
                    self._scan_cache[key] = hit
        h, t = hit
        return TableOp(self, ctx, h, t)

    def _build_scan(self, var_name, ct, ctx):
        op = _member_union_scan(
            self, self.members, var_name, ct, ctx, dedup_var=var_name
        )
        h = op.header
        var = h.var(var_name)
        dead_e = next(
            (e for e in h.properties_for(var) if e.key == DEAD_KEY), None
        )
        if dead_e is None:
            # no member of this combo carries tombstones/pads: pure scan
            return op
        t = op.table.filter(E.IsNull(dead_e).with_type(T.CTBoolean), h, {})
        return TableOp(self, ctx, h, t)

    @property
    def patterns(self) -> frozenset:
        return frozenset()


# ---------------------------------------------------------------------------
# delta-overlay element tables
# ---------------------------------------------------------------------------


def _pad_target(n: int) -> int:
    """Rows a delta table occupies on the bucket lattice (identity when
    bucketing is off — exact sizes, recompiles accepted)."""
    from ..backend.cuda import bucketing

    if not bucketing.enabled():
        return n
    return max(bucketing.round_size(n), max(int(COMPACT_MIN_BUCKET.get()), 1))


def _delta_scan_graph(
    nodes: Iterable[Node],
    rels: Iterable[Relationship],
    table_cls,
    dead: bool,
) -> Optional[ScanGraph]:
    """Group delta elements into bucket-padded element tables carrying the
    ``__dead`` column (null on live rows, true on tombstones and pads).
    Pad lanes use unique ids above ``bucketing.ID_SENTINEL`` so they
    survive dedup and die at the snapshot filter."""
    from ..backend.cuda.bucketing import ID_SENTINEL

    sentinel = itertools.count()
    tables: List[ElementTable] = []
    mark = True if dead else None

    by_combo: Dict[frozenset, List[Node]] = {}
    for n in nodes:
        by_combo.setdefault(frozenset(n.labels), []).append(n)
    for combo, group in sorted(by_combo.items(), key=lambda kv: sorted(kv[0])):
        group = sorted(group, key=lambda n: n.id)
        keys = sorted({} if dead else {k for n in group for k in n.properties})
        rows = len(group)
        pad = _pad_target(rows) - rows
        cols: Dict[str, List[Any]] = {
            "id": [n.id for n in group]
            + [int(ID_SENTINEL) + next(sentinel) for _ in range(pad)]
        }
        for k in keys:
            cols[f"p_{k}"] = [n.properties.get(k) for n in group] + [None] * pad
        cols[f"p_{DEAD_KEY}"] = [mark] * rows + [True] * pad
        prop_pairs = tuple((k, f"p_{k}") for k in keys) + ((DEAD_KEY, f"p_{DEAD_KEY}"),)
        if combo:
            builder = NodeMappingBuilder.on("id").with_implied_label(*sorted(combo))
            for k, col in prop_pairs:
                builder.with_property_key(k, col)
            mapping = builder.build()
        else:
            mapping = NodeMapping("id", frozenset(), (), prop_pairs)
        tables.append(ElementTable(mapping, table_cls.from_columns(cols)))

    by_type: Dict[str, List[Relationship]] = {}
    for r in rels:
        by_type.setdefault(r.rel_type, []).append(r)
    for rel_type, group in sorted(by_type.items()):
        group = sorted(group, key=lambda r: r.id)
        keys = sorted({} if dead else {k for r in group for k in r.properties})
        rows = len(group)
        pad = _pad_target(rows) - rows
        cols = {
            "id": [r.id for r in group]
            + [int(ID_SENTINEL) + next(sentinel) for _ in range(pad)],
            "src": [r.start for r in group] + [int(ID_SENTINEL)] * pad,
            "dst": [r.end for r in group] + [int(ID_SENTINEL)] * pad,
        }
        for k in keys:
            cols[f"p_{k}"] = [r.properties.get(k) for r in group] + [None] * pad
        builder = (
            RelationshipMappingBuilder.on("id")
            .from_("src")
            .to("dst")
            .with_relationship_type(rel_type)
        )
        for k in keys:
            builder.with_property_key(k, f"p_{k}")
        builder.with_property_key(DEAD_KEY, f"p_{DEAD_KEY}")
        cols[f"p_{DEAD_KEY}"] = [mark] * rows + [True] * pad
        tables.append(ElementTable(builder.build(), table_cls.from_columns(cols)))

    if not tables:
        return None
    return ScanGraph(tables)


# ---------------------------------------------------------------------------
# the mutable graph
# ---------------------------------------------------------------------------


class MutableGraph(RelationalCypherGraph):
    """Authoritative element store + delta overlay + WAL.

    The session never plans against this object directly: the query
    pipeline rebinds to ``snapshot()`` on entry, so reads run on immutable
    graphs (plan cache keys on snapshot identity) while ``commit``
    publishes new versions underneath."""

    def __init__(
        self,
        session,
        nodes: Sequence[Node] = (),
        relationships: Sequence[Relationship] = (),
        *,
        name: str = "graph",
    ):
        self._session = session
        self._table_cls = session.table_cls
        self.name = name
        self._lock = threading.RLock()
        self._nodes: Dict[int, Node] = {n.id: n for n in nodes}
        self._rels: Dict[int, Relationship] = {r.id: r for r in relationships}
        self._adj: Dict[int, set] = {i: set() for i in self._nodes}
        for r in self._rels.values():
            self._adj.setdefault(r.start, set()).add(r.id)
            self._adj.setdefault(r.end, set()).add(r.id)
        self._next_id = max([*self._nodes, *self._rels, -1]) + 1
        # incremental statistics: total + single-label/type cardinalities
        self._node_counts: Dict[Tuple[str, ...], int] = {(): len(self._nodes)}
        for n in self._nodes.values():
            for l in n.labels:
                k = (l,)
                self._node_counts[k] = self._node_counts.get(k, 0) + 1
        self._rel_counts: Dict[Tuple[str, ...], int] = {(): len(self._rels)}
        for r in self._rels.values():
            k = (r.rel_type,)
            self._rel_counts[k] = self._rel_counts.get(k, 0) + 1
        self._compact_into_base()
        self._fp = self._initial_fingerprint()
        self._version = 0
        self._snapshot: Optional[RelationalCypherGraph] = None
        self._wal: Optional[WriteAheadLog] = None
        self._wal_offset = 0
        # telemetry
        self.compactions = 0
        self.deferred_compactions = 0
        self.replayed_batches = 0
        self.committed_batches = 0

    # -- graph interface -------------------------------------------------

    @property
    def schema(self) -> PropertyGraphSchema:  # type: ignore[override]
        return self.snapshot().schema

    def scan_operator(self, var_name, ct, ctx):
        return self.snapshot().scan_operator(var_name, ct, ctx)

    @property
    def patterns(self) -> frozenset:
        return frozenset()

    # -- durability ------------------------------------------------------

    def attach_wal(self, wal: WriteAheadLog, replay: bool = True) -> "MutableGraph":
        """Adopt a WAL; replay whatever committed batches it already holds
        (the worker-boot recovery path: called right after the graph-CREATE
        rebuild, so recovered state is byte-identical to a from-scratch
        rebuild that applied the same batches)."""
        with self._lock:
            self._wal = wal
            if replay:
                n = 0
                for rec in wal.replay():
                    self._advance(WriteBatch.from_json(rec["batch"]))
                    n += 1
                self._wal_offset = wal.size()
                self.replayed_batches = n
                if n:
                    self._maybe_compact()
        return self

    def catch_up(self) -> int:
        """Apply batches other processes appended to the shared WAL since
        we last looked — the cluster single-writer failover path. Caller
        holds ``write_lock``."""
        if self._wal is None:
            return 0
        records, new_off = self._wal.read_from(self._wal_offset)
        for rec in records:
            self._advance(WriteBatch.from_json(rec["batch"]))
        self._wal_offset = new_off
        return len(records)

    def refresh(self) -> int:
        """Apply batches OTHER processes committed to the shared WAL — the
        cluster read path: a replica worker serving reads converges on the
        writer's state without taking the exclusive file lock (``read_from``
        stops cleanly at a torn in-progress append; the next refresh picks
        it up once the writer's fsync completes)."""
        if self._wal is None:
            return 0
        with self._lock:
            n = self.catch_up()
            if n:
                self._maybe_compact()
            return n

    @contextmanager
    def write_lock(self):
        """Serialize one write transaction: in-process lock, plus the WAL
        file lock + catch-up when a WAL is attached (so a failed-over
        writer sees every batch the previous writer committed)."""
        with self._lock:
            if self._wal is not None:
                with self._wal.exclusive():
                    self.catch_up()
                    yield self
            else:
                yield self

    # -- commit ----------------------------------------------------------

    def allocate_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def commit(self, batch: WriteBatch) -> None:
        """WAL append (the commit point) then in-memory apply then
        publish. An exception during apply rolls the WAL back to the
        pre-append offset — a write the client saw fail must not be
        resurrected at replay. A crash AFTER the fsync is a committed
        write whose ack was lost: replay applies it (in-doubt resolves
        committed). Caller holds ``write_lock``."""
        if batch.is_empty():
            return
        with self._lock:
            F.fault_point("wal_append")
            off = None
            if self._wal is not None:
                off = self._wal.append(
                    {"lsn": self._version + 1, "batch": batch.to_json()}
                )
            try:
                F.fault_point("delta_apply")
                self._advance(batch)
            except BaseException:
                if self._wal is not None and off is not None:
                    self._wal.truncate(off)
                raise
            if self._wal is not None:
                self._wal_offset = self._wal.size()
            self.committed_batches += 1
            self._maybe_compact()

    def _advance(self, batch: WriteBatch) -> None:
        self._apply(batch)
        self._fp = advance_fingerprint(self._fp, batch.digest())
        self._version += 1
        self._snapshot = None

    # -- apply (shared by live commit, replay, catch-up) -----------------

    def _apply(self, batch: WriteBatch) -> None:
        for i, labels, props in batch.nodes_created:
            if i in self._nodes:
                raise MutationError(f"node id {i} already exists")
            node = Node(i, labels, dict(props))
            self._nodes[i] = node
            self._delta_nodes[i] = node
            self._adj.setdefault(i, set())
            self._bump_nodes(node.labels, +1)
            self._next_id = max(self._next_id, i + 1)
        for i, s, d, t, props in batch.rels_created:
            if i in self._rels:
                raise MutationError(f"relationship id {i} already exists")
            if s not in self._nodes or d not in self._nodes:
                raise MutationError(f"relationship {i} endpoint does not exist")
            rel = Relationship(i, s, d, t, dict(props))
            self._rels[i] = rel
            self._delta_rels[i] = rel
            self._adj.setdefault(s, set()).add(i)
            self._adj.setdefault(d, set()).add(i)
            self._bump_rels(t, +1)
            self._next_id = max(self._next_id, i + 1)
        for i, labels, props in batch.nodes_rewritten:
            old = self._nodes.get(i)
            if old is None:
                raise MutationError(f"cannot SET on missing node {i}")
            self._tombstone_node(i)
            node = Node(i, labels, dict(props))
            self._nodes[i] = node
            self._delta_nodes[i] = node
            self._bump_nodes(old.labels, -1)
            self._bump_nodes(node.labels, +1)
        for i, s, d, t, props in batch.rels_rewritten:
            old = self._rels.get(i)
            if old is None:
                raise MutationError(f"cannot SET on missing relationship {i}")
            self._tombstone_rel(i)
            rel = Relationship(i, s, d, t, dict(props))
            self._rels[i] = rel
            self._delta_rels[i] = rel
            self._bump_rels(old.rel_type, -1)
            self._bump_rels(t, +1)
        for i in batch.rels_deleted:
            old = self._rels.pop(i, None)
            if old is None:
                continue  # idempotent: DETACH cascades may overlap DELETE r
            self._tombstone_rel(i)
            self._delta_rels.pop(i, None)
            self._adj.get(old.start, set()).discard(i)
            self._adj.get(old.end, set()).discard(i)
            self._bump_rels(old.rel_type, -1)
        for i in batch.nodes_deleted:
            old = self._nodes.pop(i, None)
            if old is None:
                raise MutationError(f"cannot DELETE missing node {i}")
            if self._adj.get(i):
                raise MutationError(
                    f"cannot delete node {i}: it still has relationships "
                    "(use DETACH DELETE)"
                )
            self._adj.pop(i, None)
            self._tombstone_node(i)
            self._delta_nodes.pop(i, None)
            self._bump_nodes(old.labels, -1)

    def _tombstone_node(self, i: int) -> None:
        base = self._base_nodes.get(i)
        if base is not None and i not in self._dead_nodes:
            self._dead_nodes[i] = base

    def _tombstone_rel(self, i: int) -> None:
        base = self._base_rels.get(i)
        if base is not None and i not in self._dead_rels:
            self._dead_rels[i] = base

    def _bump_nodes(self, labels, d: int) -> None:
        self._node_counts[()] = self._node_counts.get((), 0) + d
        for l in labels:
            k = (l,)
            self._node_counts[k] = self._node_counts.get(k, 0) + d

    def _bump_rels(self, rel_type: str, d: int) -> None:
        self._rel_counts[()] = self._rel_counts.get((), 0) + d
        k = (rel_type,)
        self._rel_counts[k] = self._rel_counts.get(k, 0) + d

    # -- compaction ------------------------------------------------------

    def delta_rows(self) -> int:
        return (
            len(self._delta_nodes)
            + len(self._delta_rels)
            + len(self._dead_nodes)
            + len(self._dead_rels)
        )

    def _maybe_compact(self) -> None:
        threshold = max(int(COMPACT_DELTA_MAX.get()), 1)
        if self.delta_rows() < threshold:
            return
        try:
            F.fault_point("compact")
            self._compact_into_base()
            self._snapshot = None
            self.compactions += 1
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # fault-ok: the write is already durable in the
            # WAL — a failed compaction (injected or real) is deferred,
            # host-side only, and retried on the next commit over the
            # threshold; raising here would fail a committed write
            self.deferred_compactions += 1

    def _compact_into_base(self) -> None:
        """Fold the delta into a fresh immutable base (bucket-padded by
        the table materialize path exactly like any ingested graph) and
        reset the overlay. Sorted by id: the CSR build and the
        rebuild-from-scratch differential see identical tables."""
        from ..testing.create_graph import (
            InMemoryTestGraph,
            scan_graph_from_test_graph,
        )

        nodes = [self._nodes[i] for i in sorted(self._nodes)]
        rels = [self._rels[i] for i in sorted(self._rels)]
        self._base_graph = scan_graph_from_test_graph(
            InMemoryTestGraph(nodes, rels), self._table_cls
        )
        self._base_nodes = dict(self._nodes)
        self._base_rels = dict(self._rels)
        self._delta_nodes: Dict[int, Node] = {}
        self._delta_rels: Dict[int, Relationship] = {}
        self._dead_nodes: Dict[int, Node] = {}
        self._dead_rels: Dict[int, Relationship] = {}
        _device.fence()  # the next snapshot may be taken on another lane's stream

    # -- snapshots -------------------------------------------------------

    def snapshot(self) -> RelationalCypherGraph:
        """The current immutable ``(base, delta)`` read view. Cached until
        the next commit publishes a new version; repeat reads between
        commits therefore hit the plan cache on snapshot identity."""
        snap = self._snapshot
        if snap is not None:
            return snap
        with self._lock:
            snap = self._snapshot
            if snap is not None:
                return snap
            if self.delta_rows() == 0:
                snap = self._base_graph
            else:
                live = _delta_scan_graph(
                    self._delta_nodes.values(),
                    self._delta_rels.values(),
                    self._table_cls,
                    dead=False,
                )
                dead = _delta_scan_graph(
                    self._dead_nodes.values(),
                    self._dead_rels.values(),
                    self._table_cls,
                    dead=True,
                )
                snap = SnapshotGraph(self._base_graph, live, dead, self._version)
            from ..optimizer.stats import seed_statistics

            seed_statistics(
                snap,
                node_counts=dict(self._node_counts),
                rel_counts=dict(self._rel_counts),
                fingerprint=self._fp,
            )
            _device.fence()  # published to lanes on other streams
            self._snapshot = snap
            return snap

    def fingerprint(self) -> str:
        return self._fp

    def _initial_fingerprint(self) -> str:
        """Same digest format as ``GraphStatistics.fingerprint`` computed
        from the seeded counts, so an unwritten mutable graph agrees with
        the immutable graph built from the same CREATE query."""
        schema = self._base_graph.schema
        parts = [
            f"n={self._node_counts.get((), 0)}",
            f"r={self._rel_counts.get((), 0)}",
        ]
        for lbl in sorted(getattr(schema, "labels", ()) or ()):
            parts.append(f"l:{lbl}={self._node_counts.get((lbl,), 0)}")
        for typ in sorted(getattr(schema, "relationship_types", ()) or ()):
            parts.append(f"t:{typ}={self._rel_counts.get((typ,), 0)}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def mutable_graph_from_create_query(
    session, query: str, *, name: str = "graph", wal_path: Optional[str] = None
):
    """Build a writable graph from a CREATE fixture query, optionally
    durably backed: when ``wal_path`` is given, existing committed batches
    replay immediately (crash recovery) and future commits append."""
    from ..relational.session import PropertyGraph
    from ..testing.create_graph import parse_create_query

    tg = parse_create_query(query)
    mg = MutableGraph(session, tg.nodes, tg.relationships, name=name)
    if wal_path:
        mg.attach_wal(WriteAheadLog(wal_path))
    return PropertyGraph(session, mg)
