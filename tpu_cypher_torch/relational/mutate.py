"""Write-query execution: host-evaluated write ops over snapshot rows.

The split mirrors the storage layout (docs/mutation.md): the read prefix
of a write query plans and executes like any query — on the pinned
immutable snapshot, through the full device stack — and materializes its
binding rows. The write suffix then evaluates HOST-side, row by row,
against a transaction view layered over the mutable store, and commits as
ONE :class:`~tpu_cypher.storage.delta.WriteBatch` (one WAL record, one
snapshot publish). Writers therefore never block readers, and a failed
write evaluation commits nothing.

Cypher surface (limits documented in docs/mutation.md):

* ``CREATE`` patterns (new nodes/relationships; bound vars as endpoints),
* single-part ``MERGE`` — a node, or one relationship between bound
  endpoints — with ``ON CREATE SET`` / ``ON MATCH SET``,
* ``SET`` property assign / label add / whole-map rewrite,
* ``DELETE`` / ``DETACH DELETE``,
* a read prefix of MATCH / UNWIND / WITH; RETURN after writes is not
  supported (write queries return their counters).
"""

from __future__ import annotations

import operator
import re
from typing import Any, Dict, List, Mapping, Optional, Set

from ..api.values import Node, Relationship
from ..errors import MutationError, classify
from ..ir import blocks as B
from ..ir import expr as E
from ..storage.delta import MutableGraph, WriteBatch

_WRITE_RE = re.compile(
    r"\b(CREATE|MERGE|SET|DELETE|DETACH)\b", re.IGNORECASE
)
_CATALOG_RE = re.compile(r"\b(CATALOG|CONSTRUCT)\b", re.IGNORECASE)


def is_write_query(query: str) -> bool:
    """Syntactic write sniff shared by the session and every serving tier:
    a write query must skip the result cache, skip batch coalescing, never
    be re-executed by the host-oracle planning fallback, and (cluster)
    route to the writer worker. Errs on the safe side — a false positive
    (a property named ``set``, say) only costs those optimizations, never
    correctness; catalog statements are not graph writes."""
    return bool(_WRITE_RE.search(query)) and not _CATALOG_RE.search(query)


_ARITH = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "%": operator.mod,
    "^": operator.pow,
}


def eval_write_expr(e: E.Expr, env: Mapping[str, Any], params: Mapping[str, Any]):
    """Host evaluator for write-side expressions (the ``_eval_literal``
    idiom of testing/create_graph.py extended with bindings, parameters,
    element property access, and arithmetic)."""
    if isinstance(e, E.Lit):
        return e.value
    if isinstance(e, E.Param):
        if e.name not in params:
            raise MutationError(f"missing parameter ${e.name}")
        return params[e.name]
    if isinstance(e, E.Var):
        if e.name not in env:
            raise MutationError(f"unbound variable {e.name!r} in write")
        return env[e.name]
    if isinstance(e, E.ListLit):
        return [eval_write_expr(i, env, params) for i in e.items]
    if isinstance(e, E.MapLit):
        return {
            k: eval_write_expr(v, env, params)
            for k, v in zip(e.keys, e.values)
        }
    if isinstance(e, E.Property):
        obj = eval_write_expr(e.expr, env, params)
        if obj is None:
            return None
        if isinstance(obj, (Node, Relationship)):
            return obj.properties.get(e.key)
        if isinstance(obj, Mapping):
            return obj.get(e.key)
        raise MutationError(f"cannot read property {e.key!r} of {obj!r}")
    if isinstance(e, E.Id):
        obj = eval_write_expr(e.expr, env, params)
        return None if obj is None else obj.id
    if isinstance(e, E.StartNode):
        obj = eval_write_expr(e.expr, env, params)
        return None if obj is None else obj.start
    if isinstance(e, E.EndNode):
        obj = eval_write_expr(e.expr, env, params)
        return None if obj is None else obj.end
    if isinstance(e, E.Neg):
        v = eval_write_expr(e.expr, env, params)
        return None if v is None else -v
    if isinstance(e, E.ArithmeticExpr):
        lhs = eval_write_expr(e.lhs, env, params)
        rhs = eval_write_expr(e.rhs, env, params)
        if lhs is None or rhs is None:
            return None
        return _ARITH[type(e).symbol](lhs, rhs)
    if isinstance(e, E.FunctionCall):
        from ..ir.functions import lookup

        fd = lookup(e.name)
        args = [eval_write_expr(a, env, params) for a in e.args]
        if fd.null_prop and any(a is None for a in args):
            return None
        return fd.fn(*args)
    raise MutationError(
        f"unsupported expression in write: {e.pretty_expr()}"
    )


class _Tx:
    """One write transaction: an overlay view (created / rewritten /
    deleted) over the mutable store, folded into a WriteBatch at commit."""

    def __init__(self, m: MutableGraph):
        self.m = m
        self.created_nodes: Dict[int, Node] = {}
        self.created_rels: Dict[int, Relationship] = {}
        self.rewritten_nodes: Dict[int, Node] = {}
        self.rewritten_rels: Dict[int, Relationship] = {}
        self.deleted_nodes: Set[int] = set()
        self.deleted_rels: Set[int] = set()
        self.stats: Dict[str, int] = {
            "nodes_created": 0,
            "relationships_created": 0,
            "properties_set": 0,
            "labels_added": 0,
            "nodes_deleted": 0,
            "relationships_deleted": 0,
            "merges_matched": 0,
        }

    # -- transaction view -------------------------------------------------

    def node(self, i: int) -> Optional[Node]:
        if i in self.deleted_nodes:
            return None
        return (
            self.created_nodes.get(i)
            or self.rewritten_nodes.get(i)
            or self.m._nodes.get(i)
        )

    def rel(self, i: int) -> Optional[Relationship]:
        if i in self.deleted_rels:
            return None
        return (
            self.created_rels.get(i)
            or self.rewritten_rels.get(i)
            or self.m._rels.get(i)
        )

    def iter_nodes(self):
        seen = self.created_nodes.keys() | self.rewritten_nodes.keys()
        ids = sorted(seen | self.m._nodes.keys())
        for i in ids:
            n = self.node(i)
            if n is not None:
                yield n

    def iter_rels(self):
        seen = self.created_rels.keys() | self.rewritten_rels.keys()
        ids = sorted(seen | self.m._rels.keys())
        for i in ids:
            r = self.rel(i)
            if r is not None:
                yield r

    def incident(self, node_id: int) -> Set[int]:
        out = set(self.m._adj.get(node_id, ())) - self.deleted_rels
        for i, r in self.created_rels.items():
            if i not in self.deleted_rels and node_id in (r.start, r.end):
                out.add(i)
        return out

    # -- mutations --------------------------------------------------------

    def put_node(self, n: Node, created: bool) -> None:
        if created:
            self.created_nodes[n.id] = n
        elif n.id in self.created_nodes:
            self.created_nodes[n.id] = n
        else:
            self.rewritten_nodes[n.id] = n

    def put_rel(self, r: Relationship, created: bool) -> None:
        if created:
            self.created_rels[r.id] = r
        elif r.id in self.created_rels:
            self.created_rels[r.id] = r
        else:
            self.rewritten_rels[r.id] = r

    def delete_rel(self, i: int) -> None:
        if i in self.deleted_rels:
            return
        if self.rel(i) is None:
            return
        self.deleted_rels.add(i)
        self.stats["relationships_deleted"] += 1

    def delete_node(self, i: int, detach: bool) -> None:
        if self.node(i) is None:
            return
        inc = self.incident(i)
        if inc and not detach:
            raise MutationError(
                f"cannot delete node {i}: it still has relationships "
                "(use DETACH DELETE)"
            )
        for rid in sorted(inc):
            self.delete_rel(rid)
        self.deleted_nodes.add(i)
        self.stats["nodes_deleted"] += 1

    # -- batch assembly ---------------------------------------------------

    def to_batch(self) -> WriteBatch:
        b = WriteBatch()
        for i in sorted(self.created_nodes):
            if i in self.deleted_nodes:
                continue
            n = self.created_nodes[i]
            b.nodes_created.append((i, tuple(sorted(n.labels)), dict(n.properties)))
        for i in sorted(self.created_rels):
            if i in self.deleted_rels:
                continue
            r = self.created_rels[i]
            b.rels_created.append((i, r.start, r.end, r.rel_type, dict(r.properties)))
        for i in sorted(self.rewritten_nodes):
            if i in self.deleted_nodes:
                continue
            n = self.rewritten_nodes[i]
            b.nodes_rewritten.append(
                (i, tuple(sorted(n.labels)), dict(n.properties))
            )
        for i in sorted(self.rewritten_rels):
            if i in self.deleted_rels:
                continue
            r = self.rewritten_rels[i]
            b.rels_rewritten.append(
                (i, r.start, r.end, r.rel_type, dict(r.properties))
            )
        # rels first: batch apply deletes them before their endpoints
        b.rels_deleted = [i for i in sorted(self.deleted_rels) if i in self.m._rels]
        b.nodes_deleted = [i for i in sorted(self.deleted_nodes) if i in self.m._nodes]
        return b


# ---------------------------------------------------------------------------
# op application
# ---------------------------------------------------------------------------


def _clean_props(pairs, env, params) -> Dict[str, Any]:
    out = {}
    for k, v in pairs:
        val = eval_write_expr(v, env, params)
        if val is not None:
            out[k] = val
    return out


def _alive_node(env, var: str, tx: _Tx) -> Node:
    got = env.get(var)
    if not isinstance(got, Node):
        raise MutationError(f"{var!r} is not a bound node")
    cur = tx.node(got.id)
    if cur is None:
        raise MutationError(f"node {got.id} was deleted in this query")
    return cur


def _apply_create(op: B.CreateOp, env: Dict[str, Any], tx: _Tx, params) -> None:
    for nt in op.nodes:
        if nt.bound or nt.var in env:
            _alive_node(env, nt.var, tx)
            continue
        node = Node(
            tx.m.allocate_id(), nt.labels, _clean_props(nt.props, env, params)
        )
        tx.put_node(node, created=True)
        env[nt.var] = node
        tx.stats["nodes_created"] += 1
        tx.stats["properties_set"] += len(node.properties)
    for rt in op.rels:
        src = _alive_node(env, rt.src, tx)
        dst = _alive_node(env, rt.dst, tx)
        rel = Relationship(
            tx.m.allocate_id(),
            src.id,
            dst.id,
            rt.rel_type,
            _clean_props(rt.props, env, params),
        )
        tx.put_rel(rel, created=True)
        env[rt.var] = rel
        tx.stats["relationships_created"] += 1
        tx.stats["properties_set"] += len(rel.properties)


def _apply_set_items(items, env: Dict[str, Any], tx: _Tx, params) -> None:
    for item in items:
        got = env.get(item.var)
        if got is None:
            continue  # SET on an unmatched OPTIONAL binding is a no-op
        if isinstance(got, Node):
            cur = tx.node(got.id)
            if cur is None:
                raise MutationError(f"SET on deleted node {got.id}")
            labels, props = set(cur.labels), dict(cur.properties)
            created = got.id in tx.created_nodes
            if item.key is not None:
                val = eval_write_expr(item.value, env, params)
                if val is None:
                    props.pop(item.key, None)
                else:
                    props[item.key] = val
                tx.stats["properties_set"] += 1
            elif item.labels:
                tx.stats["labels_added"] += len(set(item.labels) - labels)
                labels |= set(item.labels)
            else:
                val = eval_write_expr(item.value, env, params)
                if not isinstance(val, Mapping):
                    raise MutationError("SET n = value requires a map")
                if any(str(k).startswith("__") for k in val):
                    raise MutationError("property keys may not start with __")
                props = {k: v for k, v in val.items() if v is not None}
                tx.stats["properties_set"] += len(props)
            new = Node(cur.id, labels, props)
            tx.put_node(new, created=created)
            env[item.var] = new
        elif isinstance(got, Relationship):
            cur = tx.rel(got.id)
            if cur is None:
                raise MutationError(f"SET on deleted relationship {got.id}")
            props = dict(cur.properties)
            created = got.id in tx.created_rels
            if item.labels:
                raise MutationError("cannot SET labels on a relationship")
            if item.key is not None:
                val = eval_write_expr(item.value, env, params)
                if val is None:
                    props.pop(item.key, None)
                else:
                    props[item.key] = val
                tx.stats["properties_set"] += 1
            else:
                val = eval_write_expr(item.value, env, params)
                if not isinstance(val, Mapping):
                    raise MutationError("SET r = value requires a map")
                if any(str(k).startswith("__") for k in val):
                    raise MutationError("property keys may not start with __")
                props = {k: v for k, v in val.items() if v is not None}
                tx.stats["properties_set"] += len(props)
            new = Relationship(cur.id, cur.start, cur.end, cur.rel_type, props)
            tx.put_rel(new, created=created)
            env[item.var] = new
        else:
            raise MutationError(f"SET target {item.var!r} is not an element")


def _apply_merge(op: B.MergeOp, env: Dict[str, Any], tx: _Tx, params) -> None:
    if op.rels:
        rt = op.rels[0]
        src = _alive_node(env, rt.src, tx)
        dst = _alive_node(env, rt.dst, tx)
        want = _clean_props(rt.props, env, params)
        found = None
        for r in tx.iter_rels():
            if (
                r.rel_type == rt.rel_type
                and r.start == src.id
                and r.end == dst.id
                and all(r.properties.get(k) == v for k, v in want.items())
            ):
                found = r
                break
        if found is not None:
            env[rt.var] = found
            tx.stats["merges_matched"] += 1
            _apply_set_items(op.on_match, env, tx, params)
            return
        rel = Relationship(tx.m.allocate_id(), src.id, dst.id, rt.rel_type, want)
        tx.put_rel(rel, created=True)
        env[rt.var] = rel
        tx.stats["relationships_created"] += 1
        tx.stats["properties_set"] += len(want)
        _apply_set_items(op.on_create, env, tx, params)
        return
    nt = op.nodes[0]
    if nt.bound or (nt.var in env and isinstance(env.get(nt.var), Node)):
        _alive_node(env, nt.var, tx)
        tx.stats["merges_matched"] += 1
        _apply_set_items(op.on_match, env, tx, params)
        return
    want = _clean_props(nt.props, env, params)
    required = set(nt.labels)
    found = None
    for n in tx.iter_nodes():
        if required <= n.labels and all(
            n.properties.get(k) == v for k, v in want.items()
        ):
            found = n
            break
    if found is not None:
        env[nt.var] = found
        tx.stats["merges_matched"] += 1
        _apply_set_items(op.on_match, env, tx, params)
        return
    node = Node(tx.m.allocate_id(), nt.labels, want)
    tx.put_node(node, created=True)
    env[nt.var] = node
    tx.stats["nodes_created"] += 1
    tx.stats["properties_set"] += len(want)
    _apply_set_items(op.on_create, env, tx, params)


def _apply_delete(op: B.DeleteOp, env: Dict[str, Any], tx: _Tx) -> None:
    for var in op.fields:
        got = env.get(var)
        if got is None:
            continue
        if isinstance(got, Node):
            tx.delete_node(got.id, op.detach)
        elif isinstance(got, Relationship):
            tx.delete_rel(got.id)
        else:
            raise MutationError(f"DELETE target {var!r} is not an element")


def apply_write_ops(
    mutable: MutableGraph,
    ops,
    envs: List[Dict[str, Any]],
    parameters: Mapping[str, Any],
) -> _Tx:
    """Evaluate the write ops clause-major over the binding rows (standard
    Cypher: each clause runs over every row before the next clause) and
    return the filled transaction. Caller holds ``write_lock`` and
    commits ``tx.to_batch()``."""
    tx = _Tx(mutable)
    for op in ops:
        for env in envs:
            if isinstance(op, B.CreateOp):
                _apply_create(op, env, tx, parameters)
            elif isinstance(op, B.MergeOp):
                _apply_merge(op, env, tx, parameters)
            elif isinstance(op, B.SetOp):
                _apply_set_items(op.items, env, tx, parameters)
            elif isinstance(op, B.DeleteOp):
                _apply_delete(op, env, tx)
            else:  # pragma: no cover - builder emits only the above
                raise MutationError(f"unknown write op {type(op).__name__}")
    return tx


def execute_update(session, ir: B.UpdateIR, mutable: MutableGraph, parameters, run_read):
    """Run one write query: read prefix on the pinned snapshot (outside
    the write lock — writers never block readers, and a slow read holds
    no lock), then evaluate + commit under the write lock. Returns a
    CypherResult whose ``write_stats`` carries the Cypher counters."""
    from .session import CypherResult

    envs: List[Dict[str, Any]] = [{}]
    if ir.read is not None:
        inner = run_read(ir.read)
        recs = inner.records
        rows = recs.collect() if recs is not None else []
        envs = [dict(r) for r in rows]
    with mutable.write_lock():
        tx = apply_write_ops(mutable, ir.ops, envs, parameters)
        batch = tx.to_batch()
        try:
            mutable.commit(batch)
        except Exception as exc:
            # the commit fault sites (wal_append/delta_apply) raise RAW
            # I/O-shaped faults; callers must only ever see the typed
            # taxonomy — same discipline as the read ladder
            typed = classify(exc)
            if typed is not None:
                raise typed from exc
            raise
    result = CypherResult(session, None, None, None)
    result.write_stats = dict(
        tx.stats,
        contains_updates=not batch.is_empty(),
        graph_version=mutable._version,
        fingerprint=mutable.fingerprint(),
    )
    return result
