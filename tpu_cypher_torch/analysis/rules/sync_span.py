"""sync-span: device→host syncs sit inside an ``obs.trace.sync`` span.

The port's own rule (the reference has no counterpart). ``host-sync``
holds every sync to a fault-pointed function; this rule holds the same
syncs, over the same scope and the same torch taint model, to a timed
span: the blocking call must be lexically inside ``with sync(<site>):``
(``tpu_cypher_torch/obs/trace.py``), in its own function. That span is
what names an idle gap of the device after the host's wait
(``sync:<site>``), what times the wait, and what counts the site in
``tpu_cypher_host_sync_total``. A sync outside one is a wait no profile
can see.

Containment is lexical and stops at the function: a ``with sync(..)`` in
a caller, or around a nested function's definition, does not cover the
call. The span is recognised by how the file imports it: ``from
...obs.trace import sync [as name]``, or ``sync`` on the module bound by
``from ...obs import trace [as name]`` or ``import ...obs.trace as name``.
A call the taint model flags that does not wait on the device (a CPU
tensor's ``.numpy()``, say) is suppressed with its reason, as under
``host-sync``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext
from .host_sync import HostSyncRule, in_scope

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def sync_span_names(ctx: FileContext) -> Set[str]:
    """The dotted names under which ``ctx`` calls ``obs.trace.sync``."""
    names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for alias in node.names:
                bound = alias.asname or alias.name
                if alias.name == "sync" and (
                    module == "obs.trace" or module.endswith(".obs.trace")
                ):
                    names.add(bound)
                elif alias.name == "trace" and (
                    module == "obs" or module.endswith(".obs")
                ):
                    names.add(f"{bound}.sync")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith(".obs.trace") and alias.asname:
                    names.add(f"{alias.asname}.sync")
    return names


class SyncSpanRule(Rule):
    id = "sync-span"
    title = "device syncs sit inside an obs.trace.sync span"
    rationale = (
        "a sync outside a sync span is an untimed wait: the device's idle "
        "gap after it carries no site's name, and the sync counter misses it"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        if not in_scope(ctx.relpath):
            return
        names = sync_span_names(ctx)
        for call, sync, _ in HostSyncRule().sites(ctx, project):
            if self._inside_span(ctx, call, names):
                continue
            yield ctx.finding(
                self.id,
                call,
                f"{sync} forces a device->host sync outside an obs.trace.sync "
                "span — wrap the blocking call in `with sync(<site>):` (or "
                "suppress with the reason it does not wait on the device)",
            )

    @staticmethod
    def _inside_span(ctx: FileContext, call: ast.Call, names: Set[str]) -> bool:
        """True when a ``with`` of the call's own function, between the call
        and the function, enters ``sync(..)``."""
        node = ctx.parent.get(call)
        while node is not None and not isinstance(node, _FUNC_NODES):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and dotted_name(expr.func) in names:
                        return True
            node = ctx.parent.get(node)
        return False
