"""recompile-hazard: nothing on the query path may build or trace anew
per call.

The port's counterpart of the reference's rule. The port compiles its
kernels once, with ``nvcc``, at first use (``hopper/_build.py``), and
loads each library once behind a memoized loader (``_build.lib``, the
``lru_cache``'d ``_lib()`` of every ``hopper/*`` module). That win dies
quietly if someone

(a) builds, loads or wraps per call: a ``torch.compile`` /
    ``torch.jit.script`` / ``torch.jit.trace`` wrapper, a
    ``ctypes.CDLL``, ``_build.lib(..)`` or
    ``torch.utils.cpp_extension.load*`` made inside a function that is
    not memoized (``functools.lru_cache``/``cache``) and stores the result
    neither into a module-level ALL_CAPS cache (``_LIBS[name] = lib``)
    nor into a ``global`` slot (``native.get_lib``);
(b) reads ``os.environ`` or a config option (``OPTION.get()``) inside a
    registered kernel impl (the functions a ``dispatch.register(..,
    impls=(..))`` names): the value would key the build or the launch
    below the gate, out of the caller's sight, and change per call;
(c) gives a memoized function an unhashable default (a list, dict or
    set): the cache hashes its arguments, so a caller that passes such a
    value explicitly raises ``TypeError`` inside the cache.

The reference's clause on ``static_argnames`` parameters has no
counterpart — the port has no jit and no static arguments — so (c) is
judged on the memoized functions instead, and the fixture pair keeps one
case for it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext

_ENV_READS = ("os.environ.get", "os.getenv", "os.environ.setdefault")
_WRAPPERS = (
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.graphs.make_graphed_callables",
)
_LOADERS = ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "_build.lib")
_LOADER_PREFIXES = ("torch.utils.cpp_extension.load", "cpp_extension.load")
_MEMO_DECORATORS = ("lru_cache", "cache", "cached_property")


def _built_per_call(call: ast.Call) -> str:
    """What ``call`` builds or wraps ('' when nothing)."""
    name = dotted_name(call.func)
    if name in _WRAPPERS or name in _LOADERS or name.startswith(_LOADER_PREFIXES):
        return name
    return ""


def _memoized(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(target).split(".")[-1] in _MEMO_DECORATORS:
            return True
    return False


def _stores_into_global(fn: ast.AST) -> bool:
    """``global _lib`` then ``_lib = ..``: a module-level memo slot."""
    names = {n for g in ast.walk(fn) if isinstance(g, ast.Global) for n in g.names}
    return bool(names) and any(
        isinstance(t, ast.Name) and t.id in names
        for a in ast.walk(fn) if isinstance(a, ast.Assign)
        for t in a.targets
    )


class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    title = "no per-call builds or wrappers, impl env reads, or unhashable memo keys"
    rationale = (
        "a kernel build, library load or torch.compile wrapper made per "
        "call repeats the work the one memoized loader exists to do; an "
        "env or config read inside a kernel impl keys the launch out of "
        "the caller's sight; an unhashable memoized default breaks the cache"
    )

    @staticmethod
    def _stores_into_cache(fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id.isupper()
                ):
                    return True
        return False

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        # (a) a build/load/wrapper made inside a function body — EXCEPT
        # the memoized-loader idiom (an lru_cache'd function, or one that
        # stores into a module-level ALL_CAPS cache): those run once per key
        for call in ctx.calls:
            what = _built_per_call(call)
            if not what:
                continue
            fn = ctx.enclosing_function(call)
            if fn is None or _memoized(fn) or self._stores_into_cache(fn) or (
                _stores_into_global(fn)
            ):
                continue
            yield ctx.finding(
                self.id,
                call,
                f"{what} made inside {fn.name}() — a fresh build, load or "
                "wrapper per call; hoist to module scope or memoize in a "
                "module-level cache",
            )

        impls = project.impls_by_path.get(ctx.relpath, set())
        for fn in ctx.functions:
            # (c) unhashable defaults on memoized functions
            if _memoized(fn):
                args = fn.args
                pos = args.posonlyargs + args.args
                for name_node, default in list(
                    zip(pos[len(pos) - len(args.defaults):], args.defaults)
                ) + [
                    (a, d)
                    for a, d in zip(args.kwonlyargs, args.kw_defaults)
                    if d is not None
                ]:
                    if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                        yield ctx.finding(
                            self.id,
                            default,
                            f"argument {name_node.arg!r} of memoized "
                            f"{fn.name}() has an unhashable default — the "
                            "cache hashes its arguments; use a tuple or None",
                        )
            if fn.name not in impls:
                continue
            # (b) value-varying reads inside a registered kernel impl
            for call in ctx.calls_under(fn):
                name = dotted_name(call.func)
                if name in _ENV_READS:
                    yield ctx.finding(
                        self.id,
                        call,
                        f"os.environ read inside kernel impl {fn.name}() — "
                        "the value keys the launch below the gate; read it "
                        "in the caller and pass it in",
                    )
                elif (
                    isinstance(call.func, ast.Attribute)
                    and call.func.attr == "get"
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id.isupper()
                    and not call.args
                ):
                    yield ctx.finding(
                        self.id,
                        call,
                        f"config option {call.func.value.id}.get() inside "
                        f"kernel impl {fn.name}() — the flag keys the "
                        "launch below the gate; resolve it at the call site",
                    )
            for node in ast.walk(fn):
                if isinstance(node, ast.Subscript) and dotted_name(
                    node.value
                ) == "os.environ":
                    yield ctx.finding(
                        self.id,
                        node,
                        f"os.environ subscript inside kernel impl "
                        f"{fn.name}() — the value keys the launch below "
                        "the gate",
                    )
