"""host-sync: device→host syncs sit behind a ``fault_point``.

The port's counterpart of ``tpu_cypher/analysis/rules/host_sync.py``.
An ``int(cuda_scalar)`` / ``.item()`` / ``.tolist()`` / ``.cpu()`` /
``torch.cuda.synchronize()`` blocks the host on the device stream — on
the card, a stream stall: it is exactly where an OOM or a lost device
surfaces, where the query deadline must be checked, and where the trace
spans stamp their sync points. The port keeps the reference's contract:
every such sync happens inside a function that passes through a named
``fault_point`` — that is what makes the fault-injection matrix exhaustive
and the ladder's retry windows deterministic. A sync outside a
fault-pointed function is invisible to injection, to the deadline, and to
obs.

Detection is SEMANTIC, not textual: the project-wide torch device-taint
lattice (``analysis/dataflow.py``) decides whether a value is a CUDA
tensor, chasing assignments, returns, and call sites across modules.
``int(x)`` flags when ``x`` came from ``helper(rows)`` and ``helper``
returns ``torch.cumsum(...)`` two files away — or when ``helper`` is a
passthrough and the ARGUMENT was device-valued; ``int(x.shape[0])``,
``x.numel()``, host arithmetic and allocator statistics
(``torch.cuda.max_memory_allocated()``) never flag. Containment stays
lexical on purpose: the contract is that the sync site's OWN function (or
a lexical encloser) passes through ``fault_point`` — a fault-pointed
caller three frames up does not make the sync observable at the right
site name.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from ..core import FileContext, Finding, Rule, dotted_name
from ..dataflow import sync_kind
from ..project import ProjectContext

SCOPE_DIRS = ("backend/cuda/", "parallel/")


def in_scope(relpath: str) -> bool:
    return any(d in relpath for d in SCOPE_DIRS)


class HostSyncRule(Rule):
    id = "host-sync"
    title = "device syncs happen at fault_point-wrapped sites"
    rationale = (
        "a sync outside a fault-pointed function is invisible to fault "
        "injection, the query deadline, and the span sync-point telemetry"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        if not in_scope(ctx.relpath):
            return
        for call, sync, guarded in self.sites(ctx, project):
            if guarded:
                continue
            yield ctx.finding(
                self.id,
                call,
                f"{sync} forces a device->host sync in a function with no "
                "fault_point — wrap the sync site (or suppress with the "
                "reason it cannot fault)",
            )

    def sites(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Tuple[ast.Call, str, bool]]:
        """Every sync the taint model sees in ``ctx``, scope aside, as
        (call, sync kind, under a fault_point)."""
        taint = project.device_taint
        for call in ctx.calls:
            fn = ctx.enclosing_function(call)
            if fn is None:
                continue  # module scope: import-time constants, not syncs
            sync = sync_kind(taint, ctx, fn, call)
            if sync is not None:
                yield call, sync, self._under_fault_point(ctx, fn)

    # -- fault_point containment --------------------------------------------

    @staticmethod
    def _under_fault_point(ctx: FileContext, fn: ast.AST) -> bool:
        """True when ``fn`` or any lexically enclosing function makes a
        direct ``fault_point(..)`` call in its own scope."""
        node: Optional[ast.AST] = fn
        while node is not None:
            for call in ctx.calls_in(node):
                if dotted_name(call.func).split(".")[-1] == "fault_point":
                    return True
            node = ctx.enclosing_function(node)
        return False
