"""obs-emission: telemetry flows through the unified registry and every
kernel launch goes through dispatch.

The port's counterpart of ``tpu_cypher/analysis/rules/obs_emission.py``,
retargeted from ``pl.pallas_call`` to the port's raw launches. Three
sub-checks:

* no module-global ``NAME = {"k": 0, ...}`` counter dicts outside ``obs/``
  — counters belong to the registry where scopes, export, and reset work;
* a raw launch — a ``_build.lib(..)`` call, which loads a kernel's
  shared library, or a ctypes ``lib.<kernel>_launch`` symbol — may only
  appear under ``backend/cuda/hopper/``, inside a function that the same
  file's ``dispatch.register(name, site, ..., impls=(..))`` names as an
  impl: no kernel may bypass eligibility, the device rule, fault sites,
  or use counters. The native host tier (``native/``, C++ over ctypes)
  launches no kernel and has no such symbol;
* the two chokepoint files keep their emission contracts:
  ``runtime/faults.py``'s ``fault_point`` counts through a registry
  counter, and ``hopper/dispatch.py``'s ``launch`` feeds the
  ``KERNEL_LAUNCH`` registry counter and opens a kernel span.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext

_HOPPER_DIR = "backend/cuda/hopper/"
_FAULTS_SUFFIX = "runtime/faults.py"
_DISPATCH_SUFFIX = "backend/cuda/hopper/dispatch.py"
# a ctypes symbol of a kernel source: ``expand_rows_launch`` and the like
_LAUNCH_SYMBOL = re.compile(r"^[a-z][a-z0-9_]*_launch$")


def _assigned_from_counter(ctx: FileContext, var: str) -> bool:
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == var
                for t in node.targets
            )
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "counter"
        ):
            return True
    return False


def _func(ctx: FileContext, name: str) -> Optional[ast.AST]:
    for fn in ctx.functions:
        if fn.name == name:
            return fn
    return None


def _calls_inc_on(ctx: FileContext, fn: ast.AST, var: str) -> bool:
    for call in ctx.calls_under(fn):
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "inc"
            and isinstance(f.value, ast.Name)
            and f.value.id == var
        ):
            return True
    return False


def raw_launch(node: ast.AST) -> Optional[str]:
    """What makes ``node`` a raw launch site, or None."""
    if isinstance(node, ast.Call) and dotted_name(node.func).endswith(
        "_build.lib"
    ):
        return "_build.lib(..)"
    if isinstance(node, ast.Attribute) and _LAUNCH_SYMBOL.match(node.attr):
        return f"ctypes {node.attr}"
    return None


class ObsEmissionRule(Rule):
    id = "obs-emission"
    title = "counters live in the obs registry; kernels launch via dispatch"
    rationale = (
        "module-global counter dicts escape scopes/export/reset; a raw "
        "launch outside a registered impl bypasses eligibility, the "
        "device rule, fault sites, and use counters"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        yield from self._check_counter_dicts(ctx)
        yield from self._check_raw_launches(ctx, project)
        if ctx.relpath.endswith(_FAULTS_SUFFIX):
            yield from self._check_faults_chokepoint(ctx)
        if ctx.relpath.endswith(_DISPATCH_SUFFIX):
            yield from self._check_dispatch_chokepoint(ctx)

    def _check_counter_dicts(self, ctx: FileContext) -> Iterator[Finding]:
        if "obs/" in ctx.relpath:
            return  # the registry itself
        for node in ctx.tree.body:  # module level only
            if not (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)
            ):
                continue
            vals = node.value.values
            if vals and all(
                isinstance(v, ast.Constant) and v.value == 0 for v in vals
            ):
                names = ", ".join(
                    t.id
                    for t in node.targets
                    if isinstance(t, ast.Name)
                )
                yield ctx.finding(
                    self.id,
                    node,
                    f"module-global counter dict {names or '<target>'} — "
                    "counters belong to the obs registry "
                    "(REGISTRY.counter(..)), not module state",
                )

    def _check_raw_launches(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        impls = project.impls_by_path.get(ctx.relpath, set())
        for node in ast.walk(ctx.tree):
            what = raw_launch(node)
            if what is None:
                continue
            fn = ctx.enclosing_function(node)
            fn_name = fn.name if fn is not None else "<module>"
            if _HOPPER_DIR not in ctx.relpath or fn_name not in impls:
                yield ctx.finding(
                    self.id,
                    node,
                    f"{what} in {fn_name}() outside a dispatch-registered "
                    "impl — every kernel must launch through "
                    "backend.cuda.hopper.dispatch.launch",
                )

    def _check_faults_chokepoint(self, ctx: FileContext) -> Iterator[Finding]:
        if not _assigned_from_counter(ctx, "FAULT_SITE_HITS"):
            yield Finding(
                self.id,
                ctx.relpath,
                1,
                0,
                "FAULT_SITE_HITS is not a registry counter — fault-site "
                "telemetry must be served by the unified obs registry",
            )
        fp = _func(ctx, "fault_point")
        if fp is None or not _calls_inc_on(ctx, fp, "FAULT_SITE_HITS"):
            yield Finding(
                self.id,
                ctx.relpath,
                fp.lineno if fp is not None else 1,
                0,
                "fault_point must count every site invocation through the "
                "obs registry (FAULT_SITE_HITS.inc(..))",
            )

    def _check_dispatch_chokepoint(
        self, ctx: FileContext
    ) -> Iterator[Finding]:
        if not _assigned_from_counter(ctx, "KERNEL_LAUNCH"):
            yield Finding(
                self.id,
                ctx.relpath,
                1,
                0,
                "KERNEL_LAUNCH is not a registry counter — kernel-tier "
                "telemetry must be served by the unified obs registry",
            )
        launch = _func(ctx, "launch")
        if launch is None or not _calls_inc_on(ctx, launch, "KERNEL_LAUNCH"):
            yield Finding(
                self.id,
                ctx.relpath,
                launch.lineno if launch is not None else 1,
                0,
                "dispatch.launch must feed KERNEL_LAUNCH.inc(..) — every "
                "launch outcome is a registry series",
            )
        opens_span = launch is not None and any(
            isinstance(c.func, ast.Attribute) and c.func.attr == "span"
            for c in ctx.calls_under(launch)
        )
        if not opens_span:
            yield Finding(
                self.id,
                ctx.relpath,
                launch.lineno if launch is not None else 1,
                0,
                "dispatch.launch must open a kernel trace span "
                "(obs.trace.span) so kernel tiers appear in profiles",
            )
