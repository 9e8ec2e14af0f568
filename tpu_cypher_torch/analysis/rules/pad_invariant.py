"""pad-invariant: sized materializes round through the bucket lattice.

The port's counterpart of the reference's rule. Every data-dependent
output size in the port's tensor code is either carried as a sized
materialize — ``J.mask_nonzero(mask, size=..)``,
``torch.repeat_interleave(.., output_size=..)``, ``torch.bincount(..,
minlength=..)``, or the ``size=`` of a ``hopper/*`` kernel gate — or
compacted by an unsized ``torch.nonzero``. Under the ``TPU_CYPHER_BUCKET``
lattice a size that reaches one of those without passing
``bucketing.round_size`` (or the pow2 / multiple helpers) gives one launch
shape PER DISTINCT COUNT instead of one per lattice rung. The sanctioned
shapes are exactly two: the size is a parameter of the enclosing
primitive (the caller rounds it: the ``*_counted`` discipline), or the
size expression routes through a ``bucketing`` rounding helper first.
A site that sizes its lanes exactly on purpose says so with an inline
``allow[pad-invariant] reason=..``; the shape rules honour that
declaration.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext
from ..shapes import call_leaf, is_function_form, size_kwarg

SCOPE_DIRS = ("backend/cuda/", "parallel/")
_ROUNDERS = (
    "round_size",
    "round_up_pow2",
    "round_up_multiple",
    "bucket_pad_host",
)
_BUCKETING_SUFFIX = "backend/cuda/bucketing.py"


def _mentions_rounder(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and call_leaf(n) in _ROUNDERS:
            return True
    return False


class PadInvariantRule(Rule):
    id = "pad-invariant"
    title = "sized materializes route through bucketing.round_size"
    rationale = (
        "an unrounded data-dependent size gives one launch shape per "
        "distinct count — the shape churn the bucket lattice exists to bound"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        if not any(d in ctx.relpath for d in SCOPE_DIRS):
            return
        if ctx.relpath.endswith(_BUCKETING_SUFFIX):
            return  # the lattice itself
        for call in ctx.calls:
            name = dotted_name(call.func)
            size_kw = size_kwarg(call)
            if size_kw is None:
                # the classic trap: an UNSIZED torch.nonzero compacts to a
                # value-dependent extent and syncs for it
                if name == "torch.nonzero":
                    yield ctx.finding(
                        self.id,
                        call,
                        "unsized torch.nonzero — value-dependent output "
                        "shape; use the sized form with a bucketed size "
                        "(jit_ops.mask_nonzero / column.mask_to_idx_bucketed)",
                    )
                continue
            fn = ctx.enclosing_function(call)
            if self._size_sanctioned(ctx, fn, size_kw.value, 0):
                continue
            label = name or (
                f"<tensor>.{call_leaf(call)}"
                if not is_function_form(call) and call_leaf(call)
                else "call"
            )
            yield ctx.finding(
                self.id,
                call,
                f"{label}({size_kw.arg}=..) with a size that neither "
                "routes through bucketing.round_size/round_up_* nor is a "
                "parameter of the enclosing primitive — every "
                "data-dependent materialize size must round the bucket "
                "lattice or declare itself exact",
            )

    def _size_sanctioned(
        self,
        ctx: FileContext,
        fn: Optional[ast.AST],
        expr: ast.AST,
        depth: int,
    ) -> bool:
        if depth > 4:
            return False
        if _mentions_rounder(expr):
            return True
        if isinstance(expr, ast.Constant):
            return True  # a literal size is one fixed shape
        if isinstance(expr, ast.Attribute) or (
            isinstance(expr, ast.Subscript)
            and isinstance(expr.value, ast.Attribute)
        ):
            # shape-derived sizes (x.shape[0], self._cap) are already
            # padded/static by the time they are attributes
            return True
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func)
            if name in ("len", "min", "max", "int"):
                return all(
                    self._size_sanctioned(ctx, fn, a, depth + 1)
                    for a in expr.args
                )
            return False
        if isinstance(expr, ast.BinOp):
            return self._size_sanctioned(
                ctx, fn, expr.left, depth + 1
            ) and self._size_sanctioned(ctx, fn, expr.right, depth + 1)
        if isinstance(expr, ast.Name):
            if fn is not None and expr.id in ctx.param_names(fn):
                # a parameter: the caller computed (and rounded) the size —
                # this is the *_counted primitive shape
                return True
            assigns = ctx.assignments(fn, expr.id)
            return bool(assigns) and any(
                self._size_sanctioned(ctx, fn, v, depth + 1)
                for v in assigns
            )
        return False
