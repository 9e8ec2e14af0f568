"""pad-mask-discipline: bucketed tensors must be masked before
pad-sensitive consumers.

The port's counterpart of the reference's rule. Once an extent rounds the
bucket lattice, lanes past the true count hold garbage, and any
*pad-sensitive* consumer — a reduction (pads pollute the total), a sort
(pads interleave with live keys unless forced last via the ID_SENTINEL
discipline), or a ``searchsorted`` over the padded table (pads shift
every rank) — must see the tensor only after a mask against the true
count. The interpreter tracks that proof as the ``masked`` bit on the
BUCKETED lattice point. The masks that count: ``jit_ops._live_lanes``
(and ``row_tail_mask``), a 3-arg ``torch.where`` (or its method form
``masked_fill``), a comparison against a ``torch.arange`` iota, and
multiplication or conjunction with an already-masked tensor; ``F.pad``,
``cumsum``, gathers and ``not`` forfeit it.

A ``mask=`` or ``where=`` argument on the reduction itself
(``torch.masked.sum(x, mask=live)``) is the sanctioned in-place form.
Lines carrying an ``allow[pad-invariant]`` suppression are declared
exact-size sites — nothing there is padded.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, Rule, dotted_name
from .. import shapes as S

_SCOPE = ("backend/cuda/", "parallel/")

# reductions whose result a single garbage lane corrupts
_REDUCERS = S._REDUCERS
_SORTS = S._SORTS


class PadMaskRule(Rule):
    id = "pad-mask-discipline"
    title = "bucketed tensor reaches a pad-sensitive op unmasked"
    rationale = (
        "Past the true count, a bucket-padded tensor holds garbage lanes. "
        "A reduction, sort, or searchsorted that consumes it without a "
        "mask against the true count (torch.where against a liveness "
        "mask, an arange-vs-count comparison, _live_lanes, or the "
        "reduction's own mask=) computes over that garbage."
    )

    def check(self, ctx: FileContext, project) -> Iterator[Finding]:
        if not any(d in ctx.relpath for d in _SCOPE):
            return
        if not S.in_scope(ctx.relpath):
            return
        ana = project.shapes
        for call in ctx.calls:
            line = getattr(call, "lineno", 0)
            if ctx.allowed(line, "pad-invariant") is not None:
                continue  # declared exact-size site
            method = isinstance(call.func, ast.Attribute) and not S.is_function_form(call)
            if not (S.is_function_form(call) or method):
                continue
            leaf = S.call_leaf(call)
            name = dotted_name(call.func) or f"<tensor>.{leaf}"
            ops = ana._operands(call, method)
            fn = ctx.enclosing_function(call)

            if leaf in _REDUCERS:
                if any(kw.arg in ("mask", "where") for kw in call.keywords):
                    continue  # sanctioned in-place mask
                if not ops or (
                    leaf in ("max", "min")
                    and ana._elementwise_minmax(call, method)
                ):
                    continue
                v = ana.classify_array(ctx, fn, ops[0])
                if v.kind == S.BUCKETED_KIND and not v.masked:
                    yield ctx.finding(
                        self.id,
                        call,
                        f"{name} reduces a bucket-padded tensor "
                        f"({v.render()}) with no mask against its true "
                        f"count: pad lanes pollute the result. Mask via "
                        f"torch.where(live, x, neutral) or pass mask=.",
                    )
            elif leaf in _SORTS:
                for op_expr in ops[:1]:
                    v = ana.classify_array(ctx, fn, op_expr)
                    if v.kind == S.BUCKETED_KIND and not v.masked:
                        yield ctx.finding(
                            self.id,
                            call,
                            f"{name} sorts a bucket-padded tensor "
                            f"({v.render()}) whose pad lanes are not "
                            f"forced last: garbage keys interleave with "
                            f"live rows. Apply the ID_SENTINEL discipline "
                            f"(torch.where(live, keys, sentinel)) first.",
                        )
            elif leaf == "searchsorted" and ops:
                v = ana.classify_array(ctx, fn, ops[0])
                if v.kind == S.BUCKETED_KIND and not v.masked:
                    yield ctx.finding(
                        self.id,
                        call,
                        f"{name} searches a bucket-padded table "
                        f"({v.render()}) whose pad lanes were never "
                        f"masked to the sentinel: padded keys shift every "
                        f"rank. Mask pads to ID_SENTINEL before building "
                        f"the sorted table.",
                    )
