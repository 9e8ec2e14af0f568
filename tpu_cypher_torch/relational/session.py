"""The Cypher session: catalog + full query pipeline.

Re-design of ``RelationalCypherSession``
(``okapi-relational/.../api/graph/RelationalCypherSession.scala:63-270``) and
the user-facing ``CypherSession``/``PropertyGraph``
(``okapi-api/.../api/graph/CypherSession.scala:42`` /
``PropertyGraph.scala:45``): mounts the ambient graph, runs
parse -> IR -> logical plan -> optimize -> relational plan (all lazy —
``RelationalCypherSession.scala:130-267``), manages the catalog of stored
graphs and views, and supports driving tables (``readFrom``)."""

from __future__ import annotations

import itertools
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api import types as T
from ..api.mapping import NodeMapping, RelationshipMapping
from ..api.schema import PropertyGraphSchema
from ..errors import MutationError
from ..frontend import ast as A
from ..frontend.parser import parse as parse_cypher
from ..ir import blocks as B
from ..ir.builder import IRBuildError, IRBuilderContext, build_ir
from ..logical.optimizer import optimize as optimize_logical
from ..logical.planner import LogicalPlannerContext, plan_logical
from ..obs import metrics as OM
from ..obs import trace as OT
from ..utils import config as _config
from .graphs import (
    ElementTable,
    EmptyGraph,
    RelationalCypherGraph,
    ScanGraph,
    UnionGraph,
)
from .header import RecordHeader
from .ops import RelationalRuntimeContext
from .planner import plan_relational
from .records import RelationalCypherRecords

# ambient graphs mount under a reserved namespace ("ambient.") so they can
# never clobber user catalog entries; one fresh name per query (the reference
# mounts a fresh temp QGN per query too, RelationalCypherSession.scala:117)
AMBIENT_NS = "ambient"
SESSION_NS = "session"


class CatalogError(Exception):
    pass


def _referenced_params(body: str) -> set:
    """Names of every ``$param`` referenced in view body text (quote-aware,
    same scan as ``_substitute_graph_params``)."""
    out: set = set()
    _substitute_graph_params(body, _Collector(out))
    return out


class _Collector(dict):
    """Mapping that records lookups and never substitutes."""

    def __init__(self, out: set):
        self._out = out

    def __contains__(self, k) -> bool:
        self._out.add(k)
        return False


def _substitute_graph_params(body: str, mapping: Dict[str, str]) -> str:
    """Replace ``$param`` graph references in view body TEXT with argument
    QGNs — quote-aware (occurrences inside '...'/"..."/`...` literals are
    left alone) and without regex replacement-escape pitfalls."""
    out: List[str] = []
    i, n = 0, len(body)
    quote: Optional[str] = None
    while i < n:
        ch = body[i]
        if quote is not None:
            out.append(ch)
            if ch == "\\" and quote in "'\"" and i + 1 < n:
                out.append(body[i + 1])
                i += 2
                continue
            if ch == quote:
                quote = None
            i += 1
            continue
        if ch in ("'", '"', '`'):
            quote = ch
            out.append(ch)
            i += 1
            continue
        if ch == "$":
            j = i + 1
            while j < n and (body[j].isalnum() or body[j] == "_"):
                j += 1
            word = body[i + 1 : j]
            if word in mapping:
                out.append(mapping[word])
                i = j
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class CypherResult:
    """Lazy result (reference ``RelationalCypherResult``).

    Materialization is one attempt on the device rung, logged in
    ``execution_log``. Either the query succeeds or a classified device
    fault (``tpu_cypher_torch.errors``) reaches the caller typed; a raw
    CUDA runtime error never escapes, and no rung re-executes the query
    on the host."""

    def __init__(self, session, logical_plan, relational_plan, returns, graph=None):
        self.session = session
        self.logical_plan = logical_plan
        self.relational_plan = relational_plan
        self._returns = returns
        self._graph = graph
        self._records: Optional[RelationalCypherRecords] = None
        # per-query compile telemetry: {"compiles": n, "compile_seconds": s}
        # of REAL XLA compilations observed while THIS result's plan
        # materialized (jit/persistent-cache hits count zero — the
        # compiled-once/run-many regression signal)
        self.compile_stats: Optional[Dict[str, float]] = None
        # one entry per execution attempt: {"rung", "ok", "seconds",
        # "duration_ms", and on failure "error" (typed class name) +
        # "site" + "span_id" (the failing operator's span in the trace
        # tree)} — the per-result robustness telemetry next to
        # ``compile_stats``
        self.execution_log: List[Dict[str, Any]] = []
        # the per-query span tree (obs.trace), grown across the pipeline
        # phases and the execution; surfaced via ``profile()``
        self._trace: Optional[OT.QueryTrace] = None

    @property
    def records(self) -> Optional[RelationalCypherRecords]:
        if self._records is not None:
            return self._records
        if self.relational_plan is None:
            return None
        self._records = self._execute()
        # collect() re-enters the trace so row materialization shows up
        # as a span of THIS query
        self._records._trace = self._trace
        return self._records

    def profile(self, execute: bool = True) -> OT.QueryProfile:
        """The ``PROFILE``-style sibling of the ``EXPLAIN``-style
        ``plans``: the query's span tree (phases, relational operators,
        kernel launches, pad ratios, the execution rung) as a rendered tree +
        JSON (``docs/observability.md``). Executes the query first unless
        ``execute=False`` (an unexecuted result profiles only its
        planning phases)."""
        if execute and self.relational_plan is not None:
            _ = self.records
        trace = self._trace
        if trace is None:
            # catalog statements / internal results carry no trace
            trace = OT.QueryTrace("query")
        return OT.QueryProfile(trace)

    # -- execution ---------------------------------------------------------

    def _execute(self) -> RelationalCypherRecords:
        """One attempt on the device rung. The reference degrades a
        classified device fault down its ladder (exact buckets, chunked,
        then the host oracle); the port has no rung below the device, so
        a kernel or device fault reaches the caller typed."""
        import time as _time

        from .. import errors as ERR
        from ..runtime import guard as G

        session = self.session
        # deadline resolution: session option > context-local request
        # override (the serving layer's per-client deadline) > env default
        limit = session.query_deadline_s
        if limit is None:
            limit = G.request_deadline_s()
        if limit is None:
            limit = G.DEADLINE_S.get()
        deadline_at = (
            _time.monotonic() + float(limit) if limit and limit > 0 else None
        )

        if self._trace is None:
            self._trace = OT.QueryTrace("query")
        trace = self._trace
        # per-query metric deltas ride the JSON-lines event when the sink
        # is configured; otherwise skip the scope entirely
        import contextlib as _ctl

        scope = OM.REGISTRY.scope() if OM.sink_configured() else None
        rung = G.RUNG_DEVICE
        entry: Dict[str, Any] = {"rung": rung}
        with _ctl.ExitStack() as outer:
            outer.enter_context(OT.activate(trace))
            if scope is not None:
                outer.enter_context(scope)
            t0 = _time.perf_counter()
            trace.failed_span_id = None
            try:
                with OT.span("execute", kind="phase", rung=rung):
                    with G.activate(rung, deadline_at=deadline_at):
                        recs = self._materialize_attempt(self.relational_plan)
            except Exception as exc:  # classified below; see errors.py
                typed = ERR.classify(exc)
                if typed is None:
                    raise
                dt = _time.perf_counter() - t0
                entry["ok"] = False
                entry["error"] = type(typed).__name__
                entry["site"] = typed.site
                entry["seconds"] = round(dt, 6)
                entry["duration_ms"] = round(dt * 1000, 3)
                if trace.failed_span_id is not None:
                    # the deepest span open when the fault surfaced —
                    # the failing operator, attributable in the trace
                    entry["span_id"] = trace.failed_span_id
                self.execution_log.append(entry)
                self._emit_query_event(False, scope)
                if typed is exc:
                    raise
                raise typed from exc
            dt = _time.perf_counter() - t0
            entry["ok"] = True
            entry["seconds"] = round(dt, 6)
            entry["duration_ms"] = round(dt * 1000, 3)
            self.execution_log.append(entry)
            self._emit_query_event(True, scope)
            self._observe_feedback(trace)
            return recs

    def _observe_feedback(self, trace) -> None:
        """Fold this query's operator spans (seconds, true/padded rows)
        into the optimizer's per-graph calibration — the adaptive half of
        the cost model. Advisory: a feedback failure never takes down a
        query that just succeeded."""
        graph = self._graph
        if graph is None:
            # internal results are not handed the ambient graph; the plan's
            # leaf operators carry the resolved relational graph
            graph = getattr(self.relational_plan, "graph", None)
        if graph is None or trace is None:
            return
        try:
            from ..optimizer import feedback as _feedback

            base = getattr(graph, "_graph", graph)
            _feedback.observe(trace, base, self.relational_plan.context)
        except Exception as exc:
            from .. import errors as ERR

            ERR.reraise_if_device(exc, site="optimizer.feedback")

    def _emit_query_event(self, ok: bool, scope) -> None:
        """One schema-versioned JSON line per finished query to the
        ``TPU_CYPHER_METRICS_FILE`` sink: phase timings, the execution
        log, compile stats, and the metric deltas scoped to this query."""
        if not OM.sink_configured():
            return
        trace = self._trace
        OM.write_event(
            {
                "event": "query",
                "ok": ok,
                "total_seconds": round(trace.total_seconds, 6),
                "phases": {
                    k: round(v, 6) for k, v in trace.phase_seconds().items()
                },
                "execution_log": self.execution_log,
                "compile_stats": self.compile_stats,
                "metrics": scope.snapshot() if scope is not None else {},
            }
        )

    def _materialize_attempt(self, plan) -> RelationalCypherRecords:
        """Execute ``plan`` once."""
        from ..backend.cuda import bucketing
        from ..utils.profiling import PROFILE_DIR, profile_trace

        compiles_before = bucketing.compile_snapshot()
        with profile_trace():  # no-op unless profiling
            table = plan.table  # pulls the whole physical plan
            if PROFILE_DIR.get():
                # async launches would escape the trace: block on device work
                table = table.cache()
        if self.compile_stats is None:
            self.compile_stats = bucketing.compile_delta(compiles_before)
        return RelationalCypherRecords(plan.header, table, self._returns)

    @property
    def graph(self):
        if self._graph is not None:
            return self._graph
        if self.relational_plan is not None:
            return PropertyGraph(self.session, self.relational_plan.graph)
        return None

    @property
    def plans(self) -> str:
        out = []
        if self.logical_plan is not None:
            out.append("=== Logical plan ===\n" + self.logical_plan.pretty())
        if self.relational_plan is not None:
            out.append("=== Relational plan ===\n" + self.relational_plan.pretty())
        return "\n\n".join(out)

    def show(self, n: int = 20) -> str:
        r = self.records
        return r.show(n) if r is not None else "(no records)"


class PropertyGraph:
    """User-facing graph handle (reference ``PropertyGraph.scala:45``)."""

    def __init__(self, session: "CypherSession", relational_graph: RelationalCypherGraph):
        self.session = session
        self._graph = relational_graph

    @property
    def schema(self) -> PropertyGraphSchema:
        return self._graph.schema

    def cypher(self, query: str, parameters: Optional[Dict[str, Any]] = None, **kw) -> CypherResult:
        return self.session.cypher(query, parameters, graph=self, **kw)

    def nodes(self, var: str = "n", labels: Sequence[str] = ()) -> RelationalCypherRecords:
        ctx = self.session._runtime_context({})
        op = self._graph.scan_operator(var, T.CTNodeType(labels), ctx)
        return RelationalCypherRecords(op.header, op.table, [var])

    def relationships(self, var: str = "r", types: Sequence[str] = ()) -> RelationalCypherRecords:
        ctx = self.session._runtime_context({})
        op = self._graph.scan_operator(var, T.CTRelationshipType(types), ctx)
        return RelationalCypherRecords(op.header, op.table, [var])

    def union(self, *others: "PropertyGraph") -> "PropertyGraph":
        return PropertyGraph(
            self.session, UnionGraph([self._graph] + [o._graph for o in others])
        )

    def to_visualization_json(self, indent: int = 2) -> str:
        """Zeppelin ``%network``-style JSON of the whole graph
        (reference ``ZeppelinSupport.ZeppelinGraph``)."""
        from ..utils.visualization import graph_to_json

        return graph_to_json(self, indent)


class CypherSession:
    """Reference ``CypherSession``/``RelationalCypherSession``."""

    def __init__(
        self,
        table_cls,
        persistent_cache_dir: Optional[str] = None,
        memory_budget_bytes: Optional[int] = None,
        query_deadline_seconds: Optional[float] = None,
    ):
        from ..backend.cuda import bucketing

        self.table_cls = table_cls
        # per-query wall-clock deadline (seconds; None = env
        # TPU_CYPHER_QUERY_DEADLINE_S, 0 = off) — expiry raises the typed,
        # terminal QueryTimeout (docs/robustness.md)
        self.query_deadline_s = query_deadline_seconds
        if memory_budget_bytes is not None:
            # pre-flight materialize admission against the HBM budget;
            # process-global (the device is process-global too)
            bucketing.MEM_BUDGET.set(int(memory_budget_bytes))
        # compile telemetry is always on (one string compare per
        # jax.monitoring event): every result carries ``compile_stats``
        bucketing.install_compile_listener()
        # persistent compilation cache: the disk tier under the in-process
        # jit caches, so warm programs survive process restarts. Option
        # wins; the env var covers deployments that cannot touch code.
        cache_dir = persistent_cache_dir or _config.COMPILE_CACHE_DIR.get()
        if cache_dir:
            bucketing.enable_persistent_cache(cache_dir)
        self._catalog: Dict[str, RelationalCypherGraph] = {}
        self._views: Dict[str, Tuple[Tuple[str, ...], str]] = {}
        # (view, arg qgns, referenced params) -> (argument graph objects,
        # mounted result qgn). The stored graph objects are compared by
        # identity at lookup (and keep the arguments alive, so a recycled
        # id can never produce a stale hit); replacing a stored graph
        # therefore misses, and the superseded mounted result is evicted
        # (reference CypherCatalog caches view executions per arg tuple)
        self._view_cache: Dict[Tuple, Tuple[Tuple, str]] = {}
        self._views_expanding: set = set()  # cycle guard
        self._sources: Dict[str, "PropertyGraphDataSource"] = {}
        self._counter = itertools.count()
        # (query text, ambient graph id, param type sig) -> (graph object,
        # logical, relational, returns), LRU-ordered. The stored graph
        # reference keeps the id from being recycled; lookups re-check
        # identity anyway. Hits CLONE the plan per execution — the cached
        # tree is never mutated.
        from collections import OrderedDict

        self._plan_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()

    # -- data source namespaces (reference PropertyGraphCatalog.register) --

    def register_source(self, namespace: str, source) -> None:
        """Mount a ``PropertyGraphDataSource`` under ``namespace.*``
        (reference ``CypherSession.registerSource``)."""
        if namespace in (SESSION_NS, AMBIENT_NS):
            raise CatalogError(f"Namespace {namespace!r} is reserved")
        self._sources[namespace] = source

    def deregister_source(self, namespace: str) -> None:
        self._sources.pop(namespace, None)

    def _split(self, qgn: str) -> Tuple[str, str]:
        ns, _, rest = qgn.partition(".")
        return ns, rest

    # -- factories ---------------------------------------------------------

    @staticmethod
    def local() -> "CypherSession":
        from ..backend.local.table import LocalTable

        return CypherSession(LocalTable)

    @staticmethod
    def cuda(
        device=None,
        memory_budget_bytes: Optional[int] = None,
        query_deadline_seconds: Optional[float] = None,
    ) -> "CypherSession":
        """CUDA-backend session. Runs on ``cuda:0`` unless ``device`` names
        another one; ``device="cpu"`` runs every kernel's plain PyTorch
        version on the host (the tests do). Without CUDA and without an
        explicit CPU request this raises: the backend never carries on
        quietly on the host. The device is process-global
        (``backend/cuda/device.py``) — it decides where graph ingest
        lives, which outlives any one session."""
        from ..backend.cuda import device as _device
        from ..backend.cuda.table import CudaTable

        _device.use(device)
        return CypherSession(
            CudaTable,
            memory_budget_bytes=memory_budget_bytes,
            query_deadline_seconds=query_deadline_seconds,
        )

    # -- observability -----------------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus text exposition of the unified metrics registry
        (kernel builds, kernel tiers, fault sites, execution rungs,
        stage timings — the metric names table is in
        ``docs/observability.md``). Scrape-ready: serve it from any HTTP
        handler."""
        return OM.REGISTRY.prometheus_text()

    # -- prewarm -----------------------------------------------------------

    def warmup(
        self,
        queries: Sequence[str],
        graph: Optional[PropertyGraph] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Compile the hot path AHEAD of traffic: run each query once to
        completion (records fully materialized) so every jit composite on
        its plan is compiled — onto the shape-bucket lattice when
        ``TPU_CYPHER_BUCKET`` is on, into the persistent cache when one is
        configured. Per-request latency then pays dispatch, not XLA.

        Returns {"queries": n, "compiles": total new XLA compilations,
        "compile_seconds": time spent in them, "per_query": [...]} — a
        second warmup of the same corpus should report compiles == 0."""
        from ..backend.cuda import bucketing

        per_query: List[Dict[str, Any]] = []
        before_all = bucketing.compile_snapshot()
        for q in queries:
            before = bucketing.compile_snapshot()
            result = self.cypher(q, parameters, graph=graph)
            records = result.records
            if records is not None:
                records.collect()  # force every device program, host syncs
            delta = bucketing.compile_delta(before)
            delta["query"] = q
            per_query.append(delta)
        out = bucketing.compile_delta(before_all)
        out["queries"] = len(list(queries))
        out["per_query"] = per_query
        return out

    # -- catalog -----------------------------------------------------------

    def _qualify(self, name: str) -> str:
        return name if "." in name else f"{SESSION_NS}.{name}"

    def store_graph(self, name: str, graph: PropertyGraph):
        qgn = self._qualify(name)
        ns, rest = self._split(qgn)
        if ns in self._sources:
            self._sources[ns].store(rest, graph._graph)
        else:
            self._catalog[qgn] = graph._graph

    def graph(self, name: str) -> PropertyGraph:
        qgn = self._qualify(name)
        return PropertyGraph(self, self._resolve_qgn(qgn))

    def _resolve_qgn(self, qgn: str) -> RelationalCypherGraph:
        if qgn in self._catalog:
            return self._catalog[qgn]
        ns, rest = self._split(qgn)
        if ns in self._sources:
            return self._sources[ns].graph(rest, self)
        raise CatalogError(f"Graph {qgn!r} not in catalog")

    def drop_graph(self, name: str):
        qgn = self._qualify(name)
        ns, rest = self._split(qgn)
        if ns in self._sources:
            self._sources[ns].delete(rest)
        else:
            self._catalog.pop(qgn, None)

    @property
    def catalog_names(self) -> List[str]:
        names = [n for n in self._catalog if not n.startswith(AMBIENT_NS + ".")]
        for ns, src in self._sources.items():
            names.extend(f"{ns}.{g}" for g in src.graph_names())
        return sorted(names)

    # -- graph construction ------------------------------------------------

    def read_from(self, *element_tables: ElementTable) -> PropertyGraph:
        """Reference ``RelationalCypherSession.readFrom`` (``:81``)."""
        return PropertyGraph(self, ScanGraph(list(element_tables)))

    def create_graph_from_create_query(self, create_query: str) -> PropertyGraph:
        from ..testing.create_graph import graph_from_create_query

        return graph_from_create_query(self, create_query)

    # -- parameterized views (reference RelationalCypherSession.scala:185-187,
    # CypherCatalog.scala) ---------------------------------------------------

    def _expand_views(self, stmt, parameters=None):
        """Rewrite every ``FROM GRAPH view(args)`` into a plain FROM GRAPH
        of the view's materialized result: the stored view text is re-planned
        (with the caller's value parameters) against the argument graphs, the
        resulting graph is mounted, and the execution is cached per
        (view, argument graphs, parameters)."""
        if isinstance(stmt, A.SingleQuery):
            new = tuple(
                self._expand_view_clause(c, parameters) for c in stmt.clauses
            )
            return stmt if new == stmt.clauses else A.SingleQuery(new)
        if isinstance(stmt, A.UnionQuery):
            new = tuple(self._expand_views(q, parameters) for q in stmt.queries)
            return (
                stmt
                if new == stmt.queries
                else A.UnionQuery(new, stmt.all)
            )
        if isinstance(stmt, A.CreateGraphStatement):
            inner = self._expand_views(stmt.inner, parameters)
            return (
                stmt
                if inner is stmt.inner
                else A.CreateGraphStatement(stmt.qgn, inner)
            )
        return stmt

    def _expand_view_clause(self, c, parameters=None):
        if not isinstance(c, A.FromGraph):
            return c
        is_view = c.graph_name in self._views
        if is_view and not c.args:
            # a stored graph of the same bare name wins — creating a view
            # must not silently change the meaning of FROM GRAPH <graph>
            try:
                self._resolve_qgn(self._qualify(c.graph_name))
                is_view = False
            except CatalogError:
                pass
        if c.args or is_view:
            return A.FromGraph(
                self._resolve_view(c.graph_name, c.args, parameters)
            )
        return c

    def _view_param_closure(self, name: str, _seen: frozenset = frozenset()) -> set:
        """``$params`` referenced by a view's body text, transitively through
        views its body appears to invoke (textual name match — conservative:
        a false positive only widens the cache key)."""
        params, text = self._views[name]
        refs = _referenced_params(text)
        for other in self._views:
            if other == name or other in _seen:
                continue
            if re.search(r"\b" + re.escape(other) + r"\s*\(", text) or re.search(
                r"GRAPH\s+" + re.escape(other) + r"\b", text
            ):
                refs |= self._view_param_closure(other, _seen | {name})
        return refs

    def _resolve_view(
        self, name: str, args: Sequence[str], parameters=None
    ) -> str:
        if name not in self._views:
            raise CatalogError(f"Unknown view {name!r}")
        params, text = self._views[name]
        if len(args) != len(params):
            raise CatalogError(
                f"View {name!r} takes {len(params)} graph argument(s) "
                f"({', '.join('$' + p for p in params)}), got {len(args)}"
            )
        arg_qgns = tuple(self._qualify(a) for a in args)
        arg_graphs = tuple(self._resolve_qgn(q) for q in arg_qgns)
        # parameters referenced by the body OR any view it may invoke key
        # the cache (nested views receive the caller's parameters too)
        referenced = self._view_param_closure(name) - set(params)
        param_key = tuple(
            sorted(
                (k, repr(v))
                for k, v in (parameters or {}).items()
                if k in referenced
            )
        )
        key = (name, arg_qgns, param_key)
        cached = self._view_cache.get(key)
        if cached is not None:
            prev_graphs, vq = cached
            if all(a is b for a, b in zip(prev_graphs, arg_graphs)) and (
                vq in self._catalog
            ):
                return vq
            # argument graph replaced: evict the superseded materialization
            self._catalog.pop(vq, None)
            del self._view_cache[key]
        if key in self._views_expanding:
            raise CatalogError(f"Recursive view definition: {name!r}")
        body = _substitute_graph_params(text, dict(zip(params, arg_qgns)))
        self._views_expanding.add(key)
        try:
            result = self.cypher(body, parameters)  # views-of-views recurse
        finally:
            self._views_expanding.discard(key)
        g = result.graph
        if g is None:
            raise CatalogError(f"View {name!r} must produce a graph")
        vq = f"{AMBIENT_NS}.view_{name}_{next(self._counter)}"
        self._catalog[vq] = g._graph
        self._view_cache[key] = (arg_graphs, vq)
        return vq

    # -- runtime -----------------------------------------------------------

    def _runtime_context(self, parameters: Dict[str, Any]) -> RelationalRuntimeContext:
        return RelationalRuntimeContext(
            self._resolve_qgn, dict(parameters or {}), self.table_cls
        )

    def _graph_patterns(self) -> Dict[str, Any]:
        """qgn -> graph, for the optimizer's
        ``replace_scans_with_recognized_patterns`` — the graph carries both
        its stored patterns and the bag-equivalence check
        (``supports_pattern_rewrite``). Only resolved graphs: pattern
        metadata is not worth forcing a source load."""
        out: Dict[str, Any] = {}
        for qgn, g in self._catalog.items():
            if any(
                type(p).__name__ in ("NodeRelPattern", "TripletPattern")
                for p in g.patterns
            ):
                out[qgn] = g
        return out

    def _catalog_schemas(self) -> Dict[str, Any]:
        """qgn -> schema for every known graph; source-backed graphs resolve
        their schema lazily on first access (stored schema JSON — no full
        graph load, reference ``AbstractPropertyGraphDataSource.schema``)."""
        session = self

        class _LazySchemas(dict):
            def __missing__(self, qgn: str):
                ns, _, rest = qgn.partition(".")
                if ns in session._sources:
                    s = session._sources[ns].schema(rest)
                    if s is not None:
                        self[qgn] = s
                        return s
                raise KeyError(qgn)

            def __contains__(self, qgn) -> bool:
                try:
                    self[qgn]
                    return True
                except KeyError:
                    return False

        return _LazySchemas(
            {qgn: g.schema for qgn, g in self._catalog.items()}
        )

    # -- the pipeline ------------------------------------------------------

    # keywords that make a plan depend on catalog / graph-creation state
    # beyond the ambient graph — such queries are never plan-cached. FROM
    # alone covers the keyword-optional `FROM <name>` form; a false match
    # (e.g. a property named `from`) only skips caching, never corrupts.
    # CREATE/MERGE/SET/DELETE/DETACH mark write queries (docs/mutation.md):
    # they run host-side against the mutable store and produce no reusable
    # relational plan, so they never enter the plan cache either.
    _PLAN_CACHE_EXCLUDES = (
        "FROM", "CATALOG", "CONSTRUCT", "GRAPH",
        "CREATE", "MERGE", "SET", "DELETE", "DETACH",
    )
    _PLAN_CACHE_MAX = 256

    def _plan_cache_key(self, query, graph, parameters, driving_table):
        """Hashable key for reusing a fully-planned query, or None when the
        query is ineligible (catalog interaction, driving tables, non-scalar
        parameters). Parameter VALUES stay out of the key — plans reference
        them symbolically and resolve at table-compute time — but their
        TYPES are in it (typing may specialize on them)."""
        if driving_table is not None or graph is None:
            return None
        up = query.upper()
        if any(
            re.search(rf"\b{s}\b", up) is not None
            for s in self._PLAN_CACHE_EXCLUDES
        ):
            return None
        psig = []
        for k in sorted(parameters):
            v = parameters[k]
            if v is not None and not isinstance(v, (bool, int, float, str)):
                return None
            psig.append((k, type(v).__name__))
        # plan-SHAPE config is part of the key: WCOJ routing and join-order
        # choice happen at plan time, so flipping TPU_CYPHER_WCOJ or
        # TPU_CYPHER_OPT between calls (the bench's wcoj-vs-binary and
        # join-order legs, serve-tier overrides) must not replay a stale
        # cached plan. Calibration drift is deliberately NOT in the key:
        # a cached plan stays pinned while feedback accumulates (zero warm
        # recompiles); a replan under new calibration needs a mode flip or
        # cache eviction.
        plan_cfg = (
            _config.WCOJ_MODE.get().strip().lower(),
            int(_config.WCOJ_MIN_ROWS.get()),
            _config.OPT_MODE.get().strip().lower(),
        )
        return (query, id(graph._graph), tuple(psig), plan_cfg)

    @staticmethod
    def _clone_plan(root, parameters):
        """Per-execution copy of a cached operator tree: fresh lazy-table
        slots and a fresh runtime context carrying THIS call's parameters,
        sharing the immutable pieces (headers, expressions, source tables,
        graph indexes). The cached plan itself is never mutated, so lazy
        CypherResults handed out earlier keep their own state."""
        import copy

        old_ctx = root.context
        new_ctx = RelationalRuntimeContext(
            old_ctx.resolve_graph, dict(parameters), old_ctx.table_cls
        )
        memo: Dict[int, Any] = {}

        def walk(op):
            got = memo.get(id(op))
            if got is not None:
                return got
            new = copy.copy(op)
            memo[id(op)] = new  # before children: DAG sharing preserved
            new.children = tuple(walk(c) for c in op.children)
            new._table = None
            if hasattr(new, "_plan"):
                new._plan = None
            if getattr(new, "_ctx", None) is not None:
                new._ctx = new_ctx
            return new

        return walk(root)

    def cypher(
        self,
        query: str,
        parameters: Optional[Dict[str, Any]] = None,
        graph: Optional[PropertyGraph] = None,
        driving_table=None,
    ) -> CypherResult:
        """Plan (and for catalog statements, execute) a query. A device
        fault during PLANNING (scan staging runs device ops) reaches the
        caller typed; materialize-time faults surface from
        ``CypherResult.records``."""
        try:
            return self._cypher_pipeline(query, parameters, graph, driving_table)
        except Exception as exc:
            from .. import errors as ERR

            typed = ERR.classify(exc)
            if typed is None or typed is exc:
                raise
            raise typed from exc

    def _cypher_pipeline(
        self,
        query: str,
        parameters: Optional[Dict[str, Any]] = None,
        graph: Optional[PropertyGraph] = None,
        driving_table=None,
    ) -> CypherResult:
        parameters = dict(parameters or {})
        # A mutable ambient graph pins the snapshot it had when the query
        # arrived (docs/mutation.md): readers plan and execute against that
        # immutable (base, delta) pair; concurrent writers publish new
        # snapshots without ever blocking this query. The snapshot object is
        # cached per version, so its identity doubles as the plan-cache
        # graph identity (a committed write changes it -> replan).
        from ..storage.delta import MutableGraph as _MG

        mutable = None
        if graph is not None and isinstance(graph._graph, _MG):
            mutable = graph._graph
            graph = PropertyGraph(self, mutable.snapshot())
        cache_key = self._plan_cache_key(query, graph, parameters, driving_table)
        if cache_key is not None:
            hit = self._plan_cache.get(cache_key)
            if hit is not None and hit[0] is graph._graph:
                self._plan_cache.move_to_end(cache_key)
                _, logical, relational, returns = hit
                result = CypherResult(
                    self, logical,
                    self._clone_plan(relational, parameters), returns,
                )
                # a plan-cache hit skips every planning phase: its trace
                # starts empty and says so
                result._trace = OT.QueryTrace("query", plan_cache="hit")
                return result
        trace = OT.QueryTrace(
            "query", plan_cache="miss" if cache_key is not None else "bypass"
        )
        ambient = graph._graph if graph is not None else EmptyGraph()
        ambient_qgn = f"{AMBIENT_NS}.q{next(self._counter)}"
        self._catalog[ambient_qgn] = ambient  # mountAmbientGraph (reference :117)

        with OT.activate(trace):
            with OT.span("parse", kind="phase"):
                stmt = parse_cypher(query)
            stmt = self._expand_views(stmt, parameters)

            input_fields: Dict[str, T.CypherType] = {}
            driving_header = None
            if driving_table is not None:
                if not isinstance(driving_table, self.table_cls):
                    # coerce a foreign-backend driving table into this
                    # session's table type (columnwise; the reference
                    # instead requires the backend's own table type at the
                    # API boundary)
                    driving_table = self.table_cls.from_columns(
                        {
                            c: driving_table.column_values(c)
                            for c in driving_table.physical_columns
                        }
                    )
                driving_header = RecordHeader()
                from ..ir import expr as E

                for col in driving_table.physical_columns:
                    t = driving_table.column_type(col)
                    input_fields[col] = t
                    driving_header = driving_header.with_expr(
                        E.Var(col).with_type(t), col
                    )

            schemas = self._catalog_schemas()
            ir_ctx = IRBuilderContext(
                schema=ambient.schema,
                parameters=parameters,
                catalog_schemas=schemas,
                working_graph=ambient_qgn,
                input_fields=input_fields,
            )
            with OT.span("ir", kind="phase"):
                ir = build_ir(stmt, ir_ctx)

            # catalog statements
            if isinstance(ir, B.CreateGraphIR):
                inner = self._plan_and_run(ir.inner, parameters, input_fields, driving_table, driving_header, ambient_qgn, schemas)
                result_graph = inner.graph
                if result_graph is None:
                    raise CatalogError("CREATE GRAPH inner query must return a graph")
                self.store_graph(ir.qgn, result_graph)
                result = CypherResult(self, None, None, None, graph=result_graph)
                result._trace = trace
                return result
            if isinstance(ir, B.CreateViewIR):
                self._views[ir.name] = (ir.params, ir.inner_text)
                return CypherResult(self, None, None, None)
            if isinstance(ir, B.DropGraphIR):
                if ir.view:
                    self._views.pop(ir.qgn, None)
                    for key in [k for k in self._view_cache if k[0] == ir.qgn]:
                        _, vq = self._view_cache.pop(key)
                        self._catalog.pop(vq, None)
                else:
                    self.drop_graph(ir.qgn)
                return CypherResult(self, None, None, None)

            if isinstance(ir, B.UpdateIR):
                if mutable is None:
                    raise MutationError(
                        "write queries require a mutable graph; this graph "
                        "is immutable (create it via "
                        "storage.mutable_graph_from_create_query)"
                    )
                from .mutate import execute_update

                def run_read(read_ir):
                    return self._plan_and_run(
                        read_ir, parameters, input_fields, driving_table,
                        driving_header, ambient_qgn, schemas,
                    )

                result = execute_update(
                    self, ir, mutable, parameters, run_read
                )
                result._trace = trace
                return result

            result = self._plan_and_run(
                ir, parameters, input_fields, driving_table, driving_header,
                ambient_qgn, schemas,
            )
        result._trace = trace
        if cache_key is not None and result.relational_plan is not None:
            while len(self._plan_cache) >= self._PLAN_CACHE_MAX:
                self._plan_cache.popitem(last=False)  # LRU victim
            # store a TABLE-FREE clone: the first caller's live plan will
            # memoize materialized (device-resident) tables as it executes,
            # and the cache must not pin those for the session lifetime
            self._plan_cache[cache_key] = (
                graph._graph, result.logical_plan,
                self._clone_plan(result.relational_plan, {}),
                result._returns,
            )
        return result

    def _plan_and_run(
        self, ir, parameters, input_fields, driving_table, driving_header, ambient_qgn,
        schemas=None,
    ) -> CypherResult:
        lctx = LogicalPlannerContext(ambient_qgn, tuple(input_fields.items()))
        with OT.span("logical", kind="phase"):
            logical = plan_logical(ir, lctx)
        with OT.span("logical_opt", kind="phase"):
            logical = optimize_logical(
                logical,
                self._catalog[ambient_qgn].schema,
                schemas if schemas is not None else self._catalog_schemas(),
                ambient_qgn,
                self._graph_patterns(),
            )
        rctx = self._runtime_context(parameters)
        with OT.span("relational", kind="phase"):
            relational = plan_relational(
                logical, rctx, driving_table, driving_header
            )
        if getattr(self.table_cls, "plan_expand_fastpath", None) is not None:
            from .prune import prune_fused_columns

            with OT.span("prune", kind="phase"):
                relational = prune_fused_columns(relational)
        from .cse import share_common_subplans

        with OT.span("cse", kind="phase"):
            relational = share_common_subplans(relational)
        returns = getattr(ir, "returns", None)
        return CypherResult(self, logical, relational, returns)
