"""Cross-file facts rules need: the config registry's declared env vars and
dispatch's registered kernel impls.

The port's counterpart of ``tpu_cypher/analysis/project.py``; the impls
come from the port's ``dispatch.register(name, site, ..., impls=(..))``
(``backend/cuda/hopper/dispatch.py``).

Both are extracted STATICALLY from the already-parsed ``FileContext``s (no
engine import, no runtime registry): the analyzer must be able to lint a
broken tree, and the fixture corpus must be lintable without being
importable as the real package.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set, Tuple

from .core import FileContext, dotted_name

CONFIG_MODULE_SUFFIX = "utils/config.py"
_DECLARE_FUNCS = ("declare", "declare_flag", "ConfigOption", "ConfigFlag")


class ProjectContext:
    """Facts visible only across files.

    ``declared_env_vars`` — env var names declared in the typed registry
    (``utils/config.py``); ``None`` when no config module is among the
    analyzed files (fixture corpora), in which case declaration-existence
    checks are skipped but raw-read checks still apply.

    ``dispatch_impls`` — function names registered as kernel impls via
    ``dispatch.register(name, site, ..., impls=(..))`` anywhere in the
    analyzed set; ``impls_by_path`` keeps them per registering file (the
    allowlist for raw ``_build.lib`` / ``*_launch`` sites in that file)
    and ``dispatch_kernels`` per kernel name (what the runtime
    ``dispatch.registry()`` must equal).

    The interprocedural substrate — ``callgraph``, ``device_taint``,
    ``blocking`` — is built LAZILY on first access and shared by every
    rule in the run: rules that stay per-file never pay for it, and the
    fixpoints run at most once per analysis invocation.
    """

    def __init__(self, contexts: Iterable[FileContext]):
        self.contexts = list(contexts)
        self.declared_env_vars: Optional[Set[str]] = None
        self.dispatch_impls: Set[str] = set()
        self.impls_by_path: Dict[str, Set[str]] = {}
        self.dispatch_kernels: Dict[str, Tuple[str, ...]] = {}
        self.by_relpath: Dict[str, FileContext] = {}
        self._callgraph = None
        self._device_taint = None
        self._blocking = None
        self._shapes = None
        self.shape_summary_cache_hit = False
        for ctx in self.contexts:
            self.by_relpath[ctx.relpath] = ctx
            if ctx.relpath.endswith(CONFIG_MODULE_SUFFIX):
                declared = self._collect_declared(ctx)
                if self.declared_env_vars is None:
                    self.declared_env_vars = set()
                self.declared_env_vars |= declared
            kernels = self._collect_impls(ctx)
            for name, impls in kernels.items():
                self.dispatch_kernels[name] = impls
                self.impls_by_path.setdefault(ctx.relpath, set()).update(impls)
                self.dispatch_impls.update(impls)

    # -- the interprocedural substrate (lazy, shared across rules) ----------

    @property
    def callgraph(self):
        if self._callgraph is None:
            from .callgraph import CallGraph

            self._callgraph = CallGraph(
                self.contexts, self.dispatch_impls, self.impls_by_path
            )
        return self._callgraph

    @property
    def device_taint(self):
        if self._device_taint is None:
            from .dataflow import DeviceTaint

            self._device_taint = DeviceTaint(self.callgraph)
        return self._device_taint

    @property
    def blocking(self):
        if self._blocking is None:
            from .dataflow import BlockingSummaries

            self._blocking = BlockingSummaries(self.callgraph, self.device_taint)
        return self._blocking

    @property
    def shapes(self):
        if self._shapes is None:
            from .shapes import analysis_for

            self._shapes, self.shape_summary_cache_hit = analysis_for(self)
        return self._shapes

    @staticmethod
    def _collect_declared(ctx: FileContext) -> Set[str]:
        out: Set[str] = set()
        for call in ctx.calls:
            name = dotted_name(call.func).split(".")[-1]
            if name not in _DECLARE_FUNCS:
                continue
            for arg in list(call.args[:1]) + [
                kw.value for kw in call.keywords if kw.arg == "name"
            ]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    out.add(arg.value)
        return out

    @staticmethod
    def _collect_impls(ctx: FileContext) -> Dict[str, Tuple[str, ...]]:
        """{kernel name: impl names} of every ``register(..)`` call in
        ``ctx`` that names its kernel as a string literal and its impls
        as a tuple or list of string literals under ``impls=``."""
        out: Dict[str, Tuple[str, ...]] = {}
        for call in ctx.calls:
            if dotted_name(call.func).split(".")[-1] != "register":
                continue
            impl_args = [kw.value for kw in call.keywords if kw.arg == "impls"]
            if not impl_args or not call.args:
                continue
            name = call.args[0]
            node = impl_args[0]
            if not (
                isinstance(name, ast.Constant)
                and isinstance(name.value, str)
                and isinstance(node, (ast.Tuple, ast.List))
            ):
                continue
            out[name.value] = tuple(
                el.value
                for el in node.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)
            )
        return out
