"""async-blocking: nothing reachable from an ``async def`` body blocks.

The port's copy of ``tpu_cypher/analysis/rules/async_blocking.py``.

The serving tier multiplexes every client onto ONE asyncio event loop
(``serve/``): a single ``time.sleep``, socket op, synchronous
``session.cypher``, or device sync (``torch.cuda.synchronize()``,
``int(<device value>)``, ``.item()``) executed on the loop stalls every
connected client for its full duration — the whole point of the
``SessionPool`` lane design is that blocking engine work happens on
worker threads.

The check is interprocedural: the blocking summaries
(``analysis/dataflow.py``) propagate "can block the calling thread"
bottom-up through the call graph, so an ``async def`` that calls a sync
helper that calls ``session.cypher`` three modules away flags AT THE
AWAITABLE'S CALL SITE, with the full chain in the message. The sanctioned
escape hatches stay silent by construction:

* ``await pool.run(lambda: self._execute(..))`` — a call inside a
  ``lambda`` is DEFERRED; the call graph marks the site ``in_lambda`` and
  neither the direct check nor the summaries attribute it to the
  enclosing coroutine (the lambda body executes on the worker lane).
* ``run_in_executor(ex, fn)`` / ``to_thread(fn)`` — ``fn`` is passed by
  reference, never called on the loop; no call edge exists.
* awaiting another ``async def`` — calling a coroutine function only
  builds the coroutine; its body is the loop scheduler's business and is
  checked on its own.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, Rule
from ..project import ProjectContext


class AsyncBlockingRule(Rule):
    id = "async-blocking"
    title = "async def bodies never block the event loop"
    rationale = (
        "one blocking call on the loop stalls every connected client; "
        "blocking engine work belongs on the pool's worker lanes "
        "(run_in_executor / to_thread)"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        graph = project.callgraph
        blocking = project.blocking
        for fn in ctx.functions:
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            info = graph.info_for(fn)
            if info is None:
                continue
            for site, targets in graph.callees(info):
                if site.in_lambda:
                    continue  # deferred body: executes on a worker lane
                reason = blocking.direct_reason(info, site.call)
                if reason is not None:
                    yield ctx.finding(
                        self.id,
                        site.call,
                        f"async '{fn.name}' blocks the event loop: {reason} "
                        "— move the blocking work to a worker lane "
                        "(run_in_executor / to_thread)",
                    )
                    continue
                for tgt in targets:
                    if tgt.is_async:
                        continue  # a coroutine call only builds the coroutine
                    sub = blocking.blocking_reason(tgt.node)
                    if sub is not None:
                        yield ctx.finding(
                            self.id,
                            site.call,
                            f"async '{fn.name}' blocks the event loop via "
                            f"{tgt.qualname}() -> {sub.render()} — move the "
                            "blocking work to a worker lane "
                            "(run_in_executor / to_thread)",
                        )
                        break
