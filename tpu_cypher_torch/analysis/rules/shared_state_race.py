"""shared-state-race: annotated shared objects mutate only under their owner.

The serving tier shares a handful of objects between the asyncio event
loop and the ``SessionPool`` worker lanes: the admission scheduler's
queues, the batcher's open windows, the metrics registry every lane
writes through. Each such class declares its OWNER with a comment
annotation on (or directly above) the ``class`` line:

    # shared-by: loop
    class AdmissionScheduler: ...          # only the event loop mutates

    class MetricsRegistry:  # shared-by: lanes
        ...                                # lanes mutate, under the lock

The rule derives the check from the annotation:

* ``loop`` — the object is loop-owned (the scheduler/batcher design:
  "everything here runs on the event loop, no locks"). Mutating methods
  must be ``async def`` (they can only run on the loop) or sync methods
  that are NOT reachable from any worker lane in the call graph. A
  lane-reachable sync method mutating loop-owned state is the race.
* ``lanes`` — the object is mutated from worker threads; every mutation
  of ``self.<attr>`` outside ``__init__`` must sit lexically inside a
  ``with <...lock...>:`` block (an attribute chain containing "lock" —
  ``self._lock``, ``self._reg._lock`` both qualify).

"Mutation" is an assignment/augmented assignment to ``self.<attr>`` or
``self.<attr>[..]``, or a mutator-method call on it (``append``, ``pop``,
``update``, ...). ``__init__``/``__post_init__`` are exempt — construction
happens-before sharing. Unannotated classes are not checked: the
annotation is the opt-in contract, which the serving classes of
``serve/`` carry.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set, Tuple

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext

_ANNOT_RE = re.compile(r"#\s*shared-by:\s*(?P<owner>\S+)")
_OWNERS = ("lanes", "loop")
_MUTATORS = (
    "append", "add", "update", "pop", "remove", "clear", "extend",
    "setdefault", "popitem", "insert", "discard", "appendleft",
)
_EXEMPT_METHODS = ("__init__", "__post_init__")


def _annotation(ctx: FileContext, cls: ast.ClassDef) -> Optional[Tuple[str, int]]:
    """(owner, comment line) from the class line or the line above."""
    for ln in (cls.lineno, cls.lineno - 1):
        m = _ANNOT_RE.search(ctx.line_text(ln))
        if m:
            return m.group("owner"), ln
    return None


def _self_attr_target(node: ast.expr) -> Optional[str]:
    """``self.X`` / ``self.X[..]`` as a mutation target -> ``X``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _under_lock(ctx: FileContext, node: ast.AST, fn: ast.AST) -> bool:
    cur = ctx.parent.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.With):
            for item in cur.items:
                if "lock" in dotted_name(item.context_expr).lower():
                    return True
        cur = ctx.parent.get(cur)
    return False


class SharedStateRaceRule(Rule):
    id = "shared-state-race"
    title = "shared serving objects mutate only under their declared owner"
    rationale = (
        "the scheduler/batcher run lock-free BECAUSE only the loop touches "
        "them, and the metrics registry survives lanes BECAUSE of its "
        "lock — an ownership violation is a silent data race"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        classes = [
            n for n in ast.walk(ctx.tree) if isinstance(n, ast.ClassDef)
        ]
        if not classes:
            return
        graph = None
        lane: Set[ast.AST] = set()
        for cls in classes:
            annot = _annotation(ctx, cls)
            if annot is None:
                continue
            owner, _ln = annot
            if owner not in _OWNERS:
                yield ctx.finding(
                    self.id,
                    cls,
                    f"unknown ownership '{owner}' on class '{cls.name}' — "
                    "the annotation must be '# shared-by: lanes' or "
                    "'# shared-by: loop'",
                )
                continue
            if graph is None:
                graph = project.callgraph
                lane = graph.lane_reachable()
            for meth in cls.body:
                if not isinstance(
                    meth, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if meth.name in _EXEMPT_METHODS:
                    continue
                for mut_node, attr in self._mutations(ctx, meth):
                    if owner == "lanes":
                        if not _under_lock(ctx, mut_node, meth):
                            yield ctx.finding(
                                self.id,
                                mut_node,
                                f"'{cls.name}' is shared-by: lanes but "
                                f"'{meth.name}' mutates self.{attr} outside "
                                "a 'with <lock>:' block — lane-shared state "
                                "mutates only under the owning lock",
                            )
                    else:  # loop
                        if isinstance(meth, ast.AsyncFunctionDef):
                            continue  # coroutines only ever run on the loop
                        if meth in lane:
                            yield ctx.finding(
                                self.id,
                                mut_node,
                                f"'{cls.name}' is shared-by: loop but sync "
                                f"method '{meth.name}' (reachable from a "
                                f"worker lane) mutates self.{attr} — "
                                "loop-owned state mutates only on the "
                                "event loop",
                            )
                            break  # one finding per lane-reachable method

    @staticmethod
    def _mutations(
        ctx: FileContext, meth: ast.AST
    ) -> Iterator[Tuple[ast.AST, str]]:
        """(node, attr) for every self-attribute mutation lexically in
        ``meth`` (excluding nested defs — their execution context is their
        own problem)."""
        for node in ast.walk(meth):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not meth:
                    continue
            if ctx.enclosing_function(node) is not meth:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = _self_attr_target(t)
                    if attr is not None:
                        yield node, attr
            elif isinstance(node, ast.AugAssign):
                attr = _self_attr_target(node.target)
                if attr is not None:
                    yield node, attr
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                parts = name.split(".")
                if (
                    len(parts) >= 3
                    and parts[0] == "self"
                    and parts[-1] in _MUTATORS
                ):
                    yield node, parts[1]
