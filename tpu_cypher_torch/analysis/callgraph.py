"""Project-wide call graph: who can call whom, across files.

The port's copy of ``tpu_cypher/analysis/callgraph.py``.

Per-file rules let a device sync one helper call away, or a blocking
dispatch two modules from the ``async def`` that reaches it, pass
silently. The call graph is the substrate that makes those rules
semantic. It is built STATICALLY from the already-parsed ``FileContext``s
(like ``ProjectContext`` — no engine import, no runtime registry), so a
broken tree and the fixture corpora both resolve.

Resolution covers the shapes this codebase actually uses:

* module-level defs, called bare (``helper(x)``) or through an import
  alias (``G.check_deadline`` after ``from ..runtime import guard as G``);
* methods, through ``self.meth()``, ``ClassName.meth``, instances bound in
  the same scope (``s = CypherSession(); s.cypher(..)``), module-level
  singletons (``REGISTRY = MetricsRegistry(); REGISTRY.counter(..)`` —
  also through an imported alias), and class-attribute chasing
  (``self.pool.run`` resolves through ``self.pool = SessionPool(..)`` in
  ``__init__``);
* relative and absolute imports, matched against the analyzed file set by
  dotted-path suffix, so the graph is exact whether the analyzer runs from
  the repo root or on a fixture corpus that mirrors the package layout;
* the dispatch-registry indirection ``ProjectContext`` already indexes: a
  ``dispatch.launch(..)`` call fans out to every statically registered
  kernel impl.

Unresolvable calls (builtins, third-party, higher-order params) resolve to
the empty tuple — every consumer must treat "no edge" as UNKNOWN, never as
safe/clean, or as definitely-blocking. The graph also records, per call
site, whether the call sits inside a ``lambda`` (a deferred body is not
executed by its lexical encloser — the async-blocking and shared-state
rules need exactly that distinction).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext, dotted_name

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# callable-argument sinks that move execution onto a worker lane (a thread
# or a fresh contextvars.Context) — the roots of "lane code" for the
# shared-state-race rule, and the sanctioned escape hatch for the
# async-blocking rule
LANE_SINKS = ("run_in_executor", "to_thread", "submit", "run")


def module_path(relpath: str) -> str:
    """``tpu_cypher_torch/serve/server.py`` -> ``tpu_cypher_torch.serve.server``;
    ``pkg/__init__.py`` -> ``pkg``. Leading path junk survives as extra
    dotted segments — resolution matches by SUFFIX, so it never matters."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [x for x in p.split("/") if x and x != "."]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass(frozen=True)
class FunctionInfo:
    """One function or method in the analyzed set."""

    ctx: FileContext
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    module: str
    qualname: str  # "func" | "Class.method" | "outer.<nested>"
    cls: Optional[str] = None  # owning class name, if a method

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)

    def __repr__(self) -> str:  # compact for finding messages
        return f"{self.module}.{self.qualname}"


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    ctx: FileContext
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    bases: Tuple[str, ...] = ()
    # self.<attr> = <expr> bindings collected from every method
    attr_exprs: Dict[str, List[ast.expr]] = field(default_factory=dict)


@dataclass
class ModuleIndex:
    path: str
    ctx: FileContext
    defs: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    # local binding -> (target module dotted path, symbol | None)
    imports: Dict[str, Tuple[str, Optional[str]]] = field(default_factory=dict)
    # module-level NAME = <expr> (singleton instances, aliases)
    globals: Dict[str, List[ast.expr]] = field(default_factory=dict)


@dataclass(frozen=True)
class CallSite:
    caller: Optional[FunctionInfo]  # None at module scope
    call: ast.Call
    ctx: FileContext
    in_lambda: bool  # lexically inside a lambda: deferred, not executed here


class CallGraph:
    """The resolved graph over one analyzed file set."""

    def __init__(
        self,
        contexts: Sequence[FileContext],
        dispatch_impls: Set[str],
        impls_by_path: Optional[Dict[str, Set[str]]] = None,
    ):
        self.modules: Dict[str, ModuleIndex] = {}
        self.infos: Dict[ast.AST, FunctionInfo] = {}
        self._by_suffix: Dict[str, List[str]] = {}
        for ctx in contexts:
            self._index_module(ctx)
        for mod in self.modules.values():
            for seg_start in range(len(mod.path.split("."))):
                suffix = ".".join(mod.path.split(".")[seg_start:])
                self._by_suffix.setdefault(suffix, []).append(mod.path)
        # dispatch indirection targets: registered impl names -> infos; with
        # ``impls_by_path`` only the registering file's functions of those
        # names (the port's impls are module-private names such as _lib)
        self._dispatch_targets: Tuple[FunctionInfo, ...] = tuple(
            info
            for info in self.infos.values()
            if info.name in dispatch_impls
            and (
                impls_by_path is None
                or info.name in impls_by_path.get(info.ctx.relpath, ())
            )
        )
        # resolved edges
        self._callees: Dict[ast.AST, List[Tuple[CallSite, Tuple[FunctionInfo, ...]]]] = {}
        self._callers: Dict[ast.AST, List[CallSite]] = {}
        self._build_edges()

    # -- indexing -----------------------------------------------------------

    def _index_module(self, ctx: FileContext) -> None:
        mod = ModuleIndex(module_path(ctx.relpath), ctx)
        self.modules[mod.path] = mod
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = (
                        a.name,
                        None,
                    )
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(
                    mod.path, node, ctx.relpath.endswith("__init__.py")
                )
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = (base, a.name)
        for stmt in ctx.tree.body:
            if isinstance(stmt, _FUNC_NODES):
                info = FunctionInfo(ctx, stmt, mod.path, stmt.name)
                mod.defs[stmt.name] = info
                self.infos[stmt] = info
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(mod, stmt)
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        mod.globals.setdefault(t.id, []).append(stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    mod.globals.setdefault(stmt.target.id, []).append(
                        stmt.value
                    )
        # nested defs: resolvable by bare name from their encloser only
        for fn in ctx.functions:
            if fn in self.infos:
                continue
            encl = ctx.enclosing_function(fn)
            qual = (
                f"{encl.name}.<{fn.name}>" if encl is not None else fn.name
            )
            self.infos[fn] = FunctionInfo(ctx, fn, mod.path, qual)

    def _index_class(self, mod: ModuleIndex, node: ast.ClassDef) -> None:
        ci = ClassInfo(
            node.name,
            node,
            mod.ctx,
            bases=tuple(
                dotted_name(b) for b in node.bases if dotted_name(b)
            ),
        )
        mod.classes[node.name] = ci
        for stmt in node.body:
            if isinstance(stmt, _FUNC_NODES):
                info = FunctionInfo(
                    mod.ctx, stmt, mod.path,
                    f"{node.name}.{stmt.name}", cls=node.name,
                )
                ci.methods[stmt.name] = info
                self.infos[stmt] = info
        # self.<attr> = <expr> anywhere in the class: attribute chasing
        for meth in ci.methods.values():
            for sub in ast.walk(meth.node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (
                    sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                )
                value = sub.value
                if value is None:
                    continue
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        ci.attr_exprs.setdefault(t.attr, []).append(value)

    @staticmethod
    def _import_base(
        importer: str, node: ast.ImportFrom, is_package: bool = False
    ) -> str:
        if not node.level:
            return node.module or ""
        parts = importer.split(".")
        # a module's package is its path minus the leaf (a package's
        # __init__ is its own package); each extra level climbs one more
        base = parts[: max(len(parts) - node.level + is_package, 0)]
        if node.module:
            base.append(node.module)
        return ".".join(base)

    # -- module / class resolution ------------------------------------------

    def _find_module(self, dotted: str) -> Optional[ModuleIndex]:
        if not dotted:
            return None
        if dotted in self.modules:
            return self.modules[dotted]
        hits = self._by_suffix.get(dotted)
        if hits:
            return self.modules[sorted(hits)[0]]
        return None

    def _resolve_symbol(
        self, mod: ModuleIndex, name: str, _depth: int = 0
    ):
        """A bare name in ``mod``'s namespace -> FunctionInfo | ClassInfo |
        ModuleIndex | ('global', exprs, mod) | None."""
        if _depth > 4:
            return None
        if name in mod.defs:
            return mod.defs[name]
        if name in mod.classes:
            return mod.classes[name]
        if name in mod.imports:
            target_mod, symbol = mod.imports[name]
            target = self._find_module(
                f"{target_mod}.{symbol}" if symbol else target_mod
            )
            if target is not None and symbol:
                # `from pkg import submodule` where submodule is a module
                return target
            target = self._find_module(target_mod)
            if target is None:
                return None
            if symbol is None:
                return target
            return self._resolve_symbol(target, symbol, _depth + 1)
        if name in mod.globals:
            return ("global", mod.globals[name], mod)
        return None

    def _class_of_expr(
        self, mod: ModuleIndex, expr: ast.expr, _depth: int = 0
    ) -> Optional[ClassInfo]:
        """The class an expression instantiates, if statically evident:
        ``ClassName(..)``, an alias of one, or a name bound to one."""
        if _depth > 4:
            return None
        if isinstance(expr, ast.Call):
            resolved = self._resolve_symbol(mod, dotted_name(expr.func))
            if resolved is None and isinstance(expr.func, ast.Attribute):
                # Mod.Class(..) through an import alias
                owner = self._resolve_symbol(
                    mod, dotted_name(expr.func.value)
                )
                if isinstance(owner, ModuleIndex):
                    resolved = owner.classes.get(expr.func.attr)
            if isinstance(resolved, ClassInfo):
                return resolved
        elif isinstance(expr, ast.Name):
            resolved = self._resolve_symbol(mod, expr.id)
            if isinstance(resolved, tuple) and resolved[0] == "global":
                for v in resolved[1]:
                    ci = self._class_of_expr(resolved[2], v, _depth + 1)
                    if ci is not None:
                        return ci
        return None

    def class_methods(self, ci: ClassInfo) -> Dict[str, FunctionInfo]:
        """``ci``'s methods, including ones inherited from project-local
        bases (single chase per base, no MRO subtleties needed here)."""
        out: Dict[str, FunctionInfo] = {}
        mod = self.modules.get(module_path(ci.ctx.relpath))
        for base in ci.bases:
            resolved = (
                self._resolve_symbol(mod, base) if mod is not None else None
            )
            if isinstance(resolved, ClassInfo) and resolved is not ci:
                out.update(resolved.methods)
        out.update(ci.methods)
        return out

    # -- call resolution ----------------------------------------------------

    def resolve_call(
        self, ctx: FileContext, call: ast.Call
    ) -> Tuple[FunctionInfo, ...]:
        """Every project function this call site can enter (empty = UNKNOWN,
        never 'safe'). Memoized per call node — the graph is immutable once
        built and several passes (taint, blocking, shapes) resolve the same
        sites."""
        memo = getattr(self, "_resolve_memo", None)
        if memo is None:
            memo = self._resolve_memo = {}
        hit = memo.get(call)
        if hit is not None:
            return hit
        out = self._resolve_call_uncached(ctx, call)
        memo[call] = out
        return out

    def _resolve_call_uncached(
        self, ctx: FileContext, call: ast.Call
    ) -> Tuple[FunctionInfo, ...]:
        mod = self.modules.get(module_path(ctx.relpath))
        if mod is None:
            return ()
        name = dotted_name(call.func)
        if not name:
            return ()
        # the dispatch-registry indirection: launch(name, ..) enters every
        # registered kernel impl
        if name in ("dispatch.launch", "launch") and self._dispatch_targets:
            direct = self._resolve_dotted(mod, ctx, call, name)
            return tuple(direct) + self._dispatch_targets
        return tuple(self._resolve_dotted(mod, ctx, call, name))

    def _resolve_dotted(
        self, mod: ModuleIndex, ctx: FileContext, call: ast.Call, name: str
    ) -> List[FunctionInfo]:
        parts = name.split(".")
        fn = ctx.enclosing_function(call)
        if len(parts) == 1:
            # nested def in the same scope shadows module names
            if fn is not None:
                for cand in ctx.functions:
                    if (
                        cand.name == parts[0]
                        and ctx.enclosing_function(cand) is fn
                    ):
                        return [self.infos[cand]]
            resolved = self._resolve_symbol(mod, parts[0])
            if isinstance(resolved, FunctionInfo):
                return [resolved]
            if isinstance(resolved, ClassInfo):
                init = self.class_methods(resolved).get("__init__")
                return [init] if init is not None else []
            return []
        head, rest = parts[0], parts[1:]
        if head == "self" and fn is not None:
            ci = self._enclosing_class(ctx, fn)
            if ci is None:
                return []
            if len(rest) == 1:
                meth = self.class_methods(ci).get(rest[0])
                return [meth] if meth is not None else []
            # self.attr.meth(): chase the attribute's bound class
            attr_ci = self._attr_class(mod, ci, rest[0])
            if attr_ci is not None and len(rest) == 2:
                meth = self.class_methods(attr_ci).get(rest[1])
                return [meth] if meth is not None else []
            return []
        resolved = self._resolve_symbol(mod, head)
        # obj.meth() where obj is bound in this scope: chase the binding
        if resolved is None or isinstance(resolved, tuple):
            exprs: List[ast.expr] = []
            if fn is not None:
                exprs.extend(ctx.assignments(fn, head))
            if isinstance(resolved, tuple):
                exprs.extend(resolved[1])
            for v in exprs:
                ci = self._class_of_expr(mod, v)
                if ci is not None and len(rest) == 1:
                    meth = self.class_methods(ci).get(rest[0])
                    return [meth] if meth is not None else []
            return []
        for seg in rest[:-1]:
            if isinstance(resolved, ModuleIndex):
                resolved = self._resolve_symbol(resolved, seg)
            elif isinstance(resolved, ClassInfo):
                resolved = self.class_methods(resolved).get(seg)
            else:
                return []
            if resolved is None:
                return []
        leaf = rest[-1]
        if isinstance(resolved, ModuleIndex):
            final = self._resolve_symbol(resolved, leaf)
            if isinstance(final, FunctionInfo):
                return [final]
            if isinstance(final, ClassInfo):
                init = self.class_methods(final).get("__init__")
                return [init] if init is not None else []
            if isinstance(final, tuple):
                # imported singleton instance: its class's methods? no —
                # leaf IS the global; a call on a global is handled below
                pass
            return []
        if isinstance(resolved, ClassInfo):
            meth = self.class_methods(resolved).get(leaf)
            return [meth] if meth is not None else []
        return []

    def _enclosing_class(
        self, ctx: FileContext, fn: ast.AST
    ) -> Optional[ClassInfo]:
        mod = self.modules.get(module_path(ctx.relpath))
        if mod is None:
            return None
        node = ctx.parent.get(fn)
        while node is not None:
            if isinstance(node, ast.ClassDef):
                return mod.classes.get(node.name)
            node = ctx.parent.get(node)
        return None

    def _attr_class(
        self, mod: ModuleIndex, ci: ClassInfo, attr: str
    ) -> Optional[ClassInfo]:
        for expr in ci.attr_exprs.get(attr, []):
            found = self._class_of_expr(mod, expr)
            if found is not None:
                return found
        return None

    # -- edges --------------------------------------------------------------

    def _build_edges(self) -> None:
        for info in list(self.infos.values()):
            ctx = info.ctx
            sites: List[Tuple[CallSite, Tuple[FunctionInfo, ...]]] = []
            for call in ctx.calls_in(info.node):
                site = CallSite(
                    info, call, ctx, self._in_lambda(ctx, call, info.node)
                )
                targets = self.resolve_call(ctx, call)
                sites.append((site, targets))
                for tgt in targets:
                    self._callers.setdefault(tgt.node, []).append(site)
            self._callees[info.node] = sites

    @staticmethod
    def _in_lambda(ctx: FileContext, node: ast.AST, stop: ast.AST) -> bool:
        cur = ctx.parent.get(node)
        while cur is not None and cur is not stop:
            if isinstance(cur, ast.Lambda):
                return True
            cur = ctx.parent.get(cur)
        return False

    def callees(
        self, info: FunctionInfo
    ) -> List[Tuple[CallSite, Tuple[FunctionInfo, ...]]]:
        return self._callees.get(info.node, [])

    def callers(self, info: FunctionInfo) -> List[CallSite]:
        return self._callers.get(info.node, [])

    def info_for(self, node: ast.AST) -> Optional[FunctionInfo]:
        return self.infos.get(node)

    # -- lane analysis ------------------------------------------------------

    def lane_roots(self) -> Set[ast.AST]:
        """Function nodes handed to a worker lane by reference: arguments
        of ``run_in_executor`` / ``to_thread`` / ``submit`` /
        ``Context().run`` / ``Thread(target=..)`` / ``Process(target=..)``
        sinks, plus the call targets inside lambdas passed to those sinks
        (the lambda body runs ON the lane). A ``multiprocessing.Process``
        target is a lane like any other for race purposes: bound-method
        targets drag ``self`` across the spawn boundary, so loop-affine
        state reached from one is just as suspect as from a thread.
        Cached — the graph is immutable once built."""
        cached = getattr(self, "_lane_roots", None)
        if cached is not None:
            return cached
        roots: Set[ast.AST] = set()
        for mod in self.modules.values():
            ctx = mod.ctx
            for call in ctx.calls:
                name = dotted_name(call.func)
                leaf = name.split(".")[-1] if name else ""
                cand_args: List[ast.expr] = []
                if leaf in LANE_SINKS:
                    cand_args = list(call.args) + [
                        kw.value for kw in call.keywords
                    ]
                elif leaf in ("Thread", "Process"):
                    cand_args = [
                        kw.value for kw in call.keywords if kw.arg == "target"
                    ]
                for arg in cand_args:
                    roots.update(self._callable_targets(ctx, call, arg))
        self._lane_roots = roots
        return roots

    def _callable_targets(
        self, ctx: FileContext, call: ast.Call, arg: ast.expr
    ) -> Set[ast.AST]:
        out: Set[ast.AST] = set()
        if isinstance(arg, ast.Lambda):
            for sub in ast.walk(arg.body):
                if isinstance(sub, ast.Call):
                    for tgt in self.resolve_call(ctx, sub):
                        out.add(tgt.node)
            return out
        name = dotted_name(arg)
        if not name:
            return out
        # a bare function/method REFERENCE: resolve it like a call to it
        fake = ast.Call(func=arg, args=[], keywords=[])
        ast.copy_location(fake, call)
        # reuse the enclosing-function index of the sink call
        ctx._enclosing[fake] = ctx.enclosing_function(call)  # noqa: SLF001
        for tgt in self.resolve_call(ctx, fake):
            out.add(tgt.node)
        return out

    def lane_reachable(self) -> Set[ast.AST]:
        """Closure of ``lane_roots`` over call edges: every function that
        can execute on a worker lane (thread / fresh context), as opposed
        to the asyncio event loop. Cached — the graph is immutable."""
        cached = getattr(self, "_lane_reachable", None)
        if cached is not None:
            return cached
        seen: Set[ast.AST] = set()
        frontier = list(self.lane_roots())
        while frontier:
            node = frontier.pop()
            if node in seen:
                continue
            seen.add(node)
            info = self.infos.get(node)
            if info is None:
                continue
            for _site, targets in self.callees(info):
                for tgt in targets:
                    if tgt.node not in seen:
                        frontier.append(tgt.node)
        self._lane_reachable = seen
        return seen
