"""shape-stability: no DATA_DEPENDENT extent may reach the kernel gate.

The port's counterpart of the reference's rule, the semantic upgrade of
the lexical ``pad-invariant``: the abstract shape interpreter
(``analysis.shapes``) classifies every size and tensor expression, and
this rule fires where a provably data-dependent extent reaches the point
where the lattice would round it — the port's launch boundary:

(a) a sized-materialize kwarg of a tensor op (``J.mask_nonzero(size=)``,
    ``repeat_interleave(output_size=)``, ``bincount(minlength=)``) fed a
    data-dependent count;
(b) an unsized value-dependent materialize (``torch.nonzero``,
    ``torch.unique``) inside a registered kernel impl (the code under the
    gate) — the launch's own extent then comes from the data;
(c) a tensor whose leading dim is data-dependent handed to
    ``dispatch.launch`` (the arrays its kernel and plain closures take);
(c') the same tensor passed to a kernel gate (a ``hopper/*`` wrapper
    that calls ``dispatch.launch``), on a parameter that is not one of the
    gate's extents (those are ``bucket-cardinality``'s).

Each such site is one launch shape per distinct runtime count where the
lattice exists to bound them. A gate's own parameters are not judged
inside it: their class comes from the callers, and the finding belongs at
the call that passes the data-dependent tensor. Lines carrying an
``allow[pad-invariant]`` suppression are declared exact-size sites; the
semantic rules honour those declarations rather than re-litigating them.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from ..core import FileContext, Finding, Rule, dotted_name
from .. import shapes as S


def _declared_exact(ctx: FileContext, line: int) -> bool:
    return ctx.allowed(line, "pad-invariant") is not None


def _launch_operands(call: ast.Call) -> List[ast.AST]:
    """The tensors a ``dispatch.launch`` call hands its tiers: the
    arguments of each closure's call (and any direct argument), first
    occurrence of each expression only."""
    out: List[ast.AST] = []
    seen = set()
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Lambda):
            body = a.body
            exprs = list(body.args) if isinstance(body, ast.Call) else []
        elif isinstance(a, ast.Constant):
            continue
        else:
            exprs = [a]
        for e in exprs:
            key = ast.dump(e)
            if key not in seen:
                seen.add(key)
                out.append(e)
    return out


class ShapeStabilityRule(Rule):
    id = "shape-stability"
    title = "data-dependent shape reaches the kernel gate"
    rationale = (
        "An extent the interpreter proves data-dependent (a synced "
        "reduction, an unsized nonzero, a boolean-mask index) that reaches "
        "a sized-materialize kwarg, a kernel gate or dispatch.launch is one "
        "launch shape per distinct runtime value. Route it through "
        "bucketing.round_size so the shapes stay on the lattice."
    )

    def check(self, ctx: FileContext, project) -> Iterator[Finding]:
        if not S.in_scope(ctx.relpath):
            return
        ana = project.shapes
        boundary = ana.boundary
        graph = project.callgraph
        for call in ctx.calls:
            line = getattr(call, "lineno", 0)
            if _declared_exact(ctx, line):
                continue
            fn = ctx.enclosing_function(call)
            name = dotted_name(call.func)
            leaf = S.call_leaf(call)
            tensor_op = S.is_function_form(call) or (
                isinstance(call.func, ast.Attribute) and leaf in S._UNSIZED
            )
            label = name or f"<tensor>.{leaf}"

            if tensor_op:
                # (a) a sized-materialize kwarg fed a data-dependent count
                kw = S.size_kwarg(call)
                if kw is not None:
                    v = ana.classify_size(ctx, fn, kw.value)
                    if v.kind == S.DATA_KIND:
                        yield ctx.finding(
                            self.id,
                            kw.value,
                            f"{label}({kw.arg}=...) receives a "
                            f"data-dependent count ({v.render()}): one "
                            f"launch shape per distinct value. Round it via "
                            f"bucketing.round_size first.",
                        )

                # (b) an unsized value-dependent materialize under the gate
                if leaf in S._UNSIZED and fn is not None and fn in boundary.impls:
                    yield ctx.finding(
                        self.id,
                        call,
                        f"unsized {label} inside kernel impl {fn.name}(): the "
                        f"launch extent is data-dependent. Size it (bucketed) "
                        f"before the gate.",
                    )

            params = set(ctx.param_names(fn)) if fn is not None else set()

            # (c) a data-dependent tensor crossing dispatch.launch
            if S.launches(call):
                for arg in _launch_operands(call):
                    if isinstance(arg, ast.Name) and arg.id in params:
                        continue  # judged at the gate's callers
                    v = ana.classify_array(ctx, fn, arg)
                    if v.kind == S.DATA_KIND:
                        yield ctx.finding(
                            self.id,
                            arg,
                            f"tensor with data-dependent leading dim "
                            f"({v.render()}) crosses the {name} boundary: "
                            f"every distinct extent is a fresh launch "
                            f"shape. Pad to the bucket lattice first.",
                        )
                continue

            # (c') a data-dependent tensor passed to a kernel gate
            targets = [
                t for t in graph.resolve_call(ctx, call) if t.node in boundary.gates
            ]
            for tgt in targets[:1]:  # one gate's parameter view per call
                extents = boundary.gate_extents(tgt)
                for pname, arg in S._bound_args(call, S.target_params(tgt)):
                    if pname in extents:
                        continue  # extents are bucket-cardinality's beat
                    v = ana.classify_array(ctx, fn, arg)
                    if v.kind == S.DATA_KIND:
                        yield ctx.finding(
                            self.id,
                            arg,
                            f"tensor with data-dependent leading dim "
                            f"({v.render()}) passed to kernel gate "
                            f"{tgt.qualname}(): one launch shape per "
                            f"distinct extent. Pad to the bucket lattice "
                            f"before the gate.",
                        )
