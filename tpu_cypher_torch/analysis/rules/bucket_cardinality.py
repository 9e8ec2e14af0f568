"""bucket-cardinality: every kernel gate call needs a static bound on the
distinct extents it can launch at.

The port's counterpart of the reference's rule. The port has no compile
cache keyed by shape: PyTorch runs eagerly and each kernel builds once.
What the rule bounds here is the number of distinct extents a kernel
gate's extent parameter (its ``size=``, its ``k=``: see
``shapes.KernelBoundary``) can take at one call site — the number of
launch shapes, which is what one captured launch per shape (a CUDA graph)
would cost later. STATIC takes exactly one value, BUCKETED at most the
lattice's rung count (``shapes.BUCKET_BOUNDS``), DATA_DEPENDENT is
unbounded — an unrounded count threaded into a gate's extent, which is
this rule's finding. UNKNOWN makes no claim and never fires.

The per-site bounds (the bounded ones too) are exported through
``--facts-out``. Lines carrying an ``allow[pad-invariant]`` suppression
are declared exact-size sites and stay out of scope here too.
"""

from __future__ import annotations

from typing import Iterator

from ..core import FileContext, Finding, Rule
from .. import shapes as S


class BucketCardinalityRule(Rule):
    id = "bucket-cardinality"
    title = "unbounded launch extents at a kernel gate call"
    rationale = (
        "A kernel gate's extent parameter sizes what the launch writes: a "
        "data-dependent (unrounded) value there admits unboundedly many "
        "launch shapes — one per distinct runtime count. Round through "
        "the bucket lattice to cap it at the lattice's rung count."
    )

    def check(self, ctx: FileContext, project) -> Iterator[Finding]:
        if not S.in_scope(ctx.relpath):
            return
        ana = project.shapes
        graph = project.callgraph
        for call in ctx.calls:
            line = getattr(call, "lineno", 0)
            if ctx.allowed(line, "pad-invariant") is not None:
                continue  # declared exact-size site
            fn = ctx.enclosing_function(call)
            for tgt in graph.resolve_call(ctx, call):
                extents = ana.boundary.gate_extents(tgt)
                if not extents:
                    continue
                for pname, expr in S._bound_args(call, S.target_params(tgt)):
                    if pname not in extents:
                        continue
                    v = ana.classify_size(ctx, fn, expr)
                    if v.kind == S.DATA_KIND:
                        yield ctx.finding(
                            self.id,
                            expr,
                            f"extent {pname}= of kernel gate "
                            f"{tgt.qualname}() is data-dependent "
                            f"({v.render()}): unbounded launch shapes at "
                            f"this call site. Round via bucketing.round_size "
                            f"to bound them.",
                        )
                break  # one gate's signature view per call
