"""exception-hygiene: a broad except may not silently swallow a device
fault.

The port's copy of ``tpu_cypher/analysis/rules/exception_hygiene.py``,
over the WHOLE port: any bare ``except`` / ``except Exception`` / ``except
BaseException`` must either re-raise (a typed ``tpu_cypher_torch.errors``
class or the original), route device faults on through
``errors.reraise_if_device``, or carry an explicit ``fault-ok`` annotation
on the except line stating why the handler is host-side-only. Without one
of the three, a real DeviceLost/OOM can be eaten by a convenience fallback
and never reach the caller typed.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext

_RERAISE_NAMES = ("reraise_if_device", "_reraise_if_device")


class ExceptionHygieneRule(Rule):
    id = "exception-hygiene"
    title = "broad excepts re-raise device faults or are marked fault-ok"
    rationale = (
        "a broad handler that neither re-raises nor routes through "
        "errors.reraise_if_device can swallow DeviceLost/OOM and starve "
        "the retry ladder"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException")
            )
            if not broad:
                continue
            reraises = any(
                isinstance(n, ast.Raise) for n in ast.walk(node)
            ) or any(
                isinstance(n, ast.Call)
                and dotted_name(n.func).split(".")[-1] in _RERAISE_NAMES
                for n in ast.walk(node)
            )
            annotated = "fault-ok" in ctx.line_text(node.lineno)
            if not (reraises or annotated):
                yield ctx.finding(
                    self.id,
                    node,
                    "broad except neither re-raises, routes through "
                    "errors.reraise_if_device, nor carries a '# fault-ok: "
                    "<why host-side-only>' annotation",
                )
