"""Interprocedural dataflow: the torch device-value taint lattice and the
blocking-call summaries.

The port's counterpart of ``tpu_cypher/analysis/dataflow.py``, with the
device model retargeted to torch. Two analyses share the call
graph, both computed as fixpoints over per-function summaries (classic
bottom-up summary propagation — each function is summarized once, call
sites consume summaries, iteration continues until nothing changes):

**Device taint** — "does this expression hold a CUDA tensor?" The
lattice is ``device > unknown > host`` with one refinement: a function
whose return value depends only on its parameters gets a PASSTHROUGH
summary naming them, so call sites classify the actual arguments
(``helper(x)`` is device-valued exactly when ``x`` is). Taint enters at
torch's tensor ops and factories (a factory with no device, or the
CPU's, allocates on the host), at ``J.``/``jit_ops.`` and at
``dispatch.launch`` (so the hopper wrappers, which return what the gate
returns, are device-valued through their return summaries). It flows
through assignments (tuple unpacking included), arithmetic, subscripts,
returns, and call sites (both directions: returns flow OUT to callers,
argument taint flows IN to parameters), and dies at host metadata: the
``torch.cuda`` namespace (allocator statistics, streams, events, device
counts), ``torch.device``/``iinfo``/``finfo``, numpy, ``.shape``,
``.numel()``, ``.dim()``, ``.dtype``, ``.device``, ``.is_cuda``,
``.element_size()``, and the results of the syncs themselves. This is
what makes the ``host-sync`` rule semantic: ``int(helper(x))`` flags when
``helper`` returns a CUDA tensor from two files away, and a helper that
syncs its own parameter flags when ANY caller passes it a device value.

**Blocking summaries** — "can a call to this function block the thread?"
Seeded at the blocking intrinsics (``time.sleep``, socket/subprocess
ops, ``session.cypher``, device syncs — which reuse the device taint
through ``sync_kind``), propagated along call edges, with each summary
carrying the CHAIN of calls that reaches the intrinsic so the
``async-blocking`` finding can say *why* (``handler -> helper ->
time.sleep``). Calls inside lambdas do not propagate (a deferred body is
not executed by its lexical encloser); callables handed to
``run_in_executor``/``to_thread`` are the sanctioned escape hatch and
never taint the async def that awaits them.

Everything is conservative in the direction that avoids false positives:
an unresolvable call is UNKNOWN (not device, not blocking), a parameter
with no resolved caller is UNKNOWN, and UNKNOWN never fires a rule (but
``.item()``, which exists only on arrays and tensors, syncs unless its
receiver is proven host).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from .callgraph import CallGraph, FunctionInfo
from .core import FileContext, dotted_name

# -- the taint lattice -------------------------------------------------------

DEVICE = "device"
HOST = "host"
UNKNOWN = "unknown"

# a summary is a fixed verdict or ("passthrough", frozenset(param names)):
# the return taint equals the join of those arguments' taints at the site
Summary = Union[str, Tuple[str, frozenset]]

# dotted-prefix spelling of "this call returns a device value" in the
# port: torch's tensor ops and factories (minus the host namespaces below),
# J / jit_ops (the torch-op library), and the kernel gate
_DEVICE_PREFIXES = ("torch.", "J.", "jit_ops.")
_DEVICE_EXACT = ("dispatch.launch", "launch")
# torch namespaces and names whose calls return host objects: allocator
# statistics, streams and events, devices, dtype and type introspection,
# process groups, profiler and autograd switches
_HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.utils.",
    "torch.profiler.", "torch.testing.", "torch.version.", "torch.library.",
    "torch.multiprocessing.", "torch.autograd.", "torch.jit.", "torch._C.",
)
_HOST_TORCH = (
    "torch.device", "torch.dtype", "torch.iinfo", "torch.finfo", "torch.Size",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.manual_seed", "torch.seed", "torch.initial_seed", "torch.Generator",
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
    "torch.set_grad_enabled", "torch.is_grad_enabled", "torch.get_num_threads",
    "torch.set_num_threads", "torch.use_deterministic_algorithms",
    "torch.typename", "torch.set_printoptions", "torch.from_numpy",
)
# factories that allocate on the CPU unless given a device
_TORCH_FACTORIES = (
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "rand", "randn", "randint", "randperm", "eye",
)
# host libraries: their results live in host memory (numpy arrays, ints)
_HOST_PREFIXES = ("np.", "numpy.", "_np.", "math.", "ctypes.", "os.", "time.")
# dtype/shape introspection: host-side metadata, not device values; and
# the results of the syncs themselves, which are host values
_METADATA_FUNCS = (
    "iinfo", "finfo", "dtype", "result_type", "ndim", "shape", "numel",
    "dim", "size", "element_size", "data_ptr", "stride", "is_contiguous",
    "nelement", "ndimension", "get_device", "storage_offset",
    "is_floating_point", "is_complex",
)
_SYNC_RESULTS = ("item", "tolist", "cpu", "numpy")
_HOST_ATTRS = (
    "shape", "ndim", "size", "dtype", "device", "is_cuda", "layout",
    "itemsize", "nbytes", "requires_grad",
)
_HOST_BUILTINS = ("len", "range", "enumerate", "zip", "sorted", "repr", "str")


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")``: a literal host device."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


# isinstance() narrowing: inside `if isinstance(x, T):` x is a device
# value for a torch tensor type, a host value for these
_DEVICE_TYPES = ("torch.Tensor",)
_HOST_TYPES = (
    "np.ndarray", "numpy.ndarray", "np.generic", "numpy.generic", "int",
    "float", "bool", "str", "list", "tuple", "dict",
)


def _narrowed(ctx: FileContext, fn: Optional[ast.AST], name: ast.Name) -> Optional[str]:
    """DEVICE or HOST when ``name`` sits in the body of an enclosing
    ``if isinstance(<name>, T):`` of its own function, else None."""
    child: ast.AST = name
    node = ctx.parent.get(name)
    while node is not None and node is not fn:
        if isinstance(node, ast.If) and child in node.body:
            test = node.test
            if (
                isinstance(test, ast.Call)
                and dotted_name(test.func) == "isinstance"
                and len(test.args) == 2
                and isinstance(test.args[0], ast.Name)
                and test.args[0].id == name.id
            ):
                kinds = test.args[1]
                names = [
                    dotted_name(k)
                    for k in (kinds.elts if isinstance(kinds, ast.Tuple) else [kinds])
                ]
                if names and all(n in _DEVICE_TYPES for n in names):
                    return DEVICE
                if names and all(n in _HOST_TYPES for n in names):
                    return HOST
        child, node = node, ctx.parent.get(node)
    return None


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: a copy to host memory."""
    dev = call.args[0] if call.args else _device_kw(call)
    return dev is not None and _is_cpu(dev)


def is_host_intrinsic(name: str, call: Optional[ast.Call] = None) -> bool:
    """A call whose result lives on the host whatever its arguments: the
    host torch namespaces, numpy, and a torch factory with no device or the
    CPU's."""
    if not name:
        return False
    if name in _HOST_TORCH or name.startswith(_HOST_TORCH_PREFIXES):
        return True
    if name.startswith(_HOST_PREFIXES):
        return True
    if call is not None and name.startswith("torch.") and (
        name.split(".", 1)[1] in _TORCH_FACTORIES
    ):
        dev = _device_kw(call)
        return dev is None or _is_cpu(dev)
    return False


def is_device_intrinsic(name: str) -> bool:
    if not name:
        return False
    if name in _DEVICE_EXACT:
        return True
    if ".shape" in name or is_host_intrinsic(name):
        return False
    if name.split(".")[-1] in _METADATA_FUNCS:
        return False
    return name.startswith(_DEVICE_PREFIXES)


def _join(verdicts) -> str:
    out = HOST
    saw = False
    for v in verdicts:
        saw = True
        if v == DEVICE:
            return DEVICE
        if v != HOST:
            out = UNKNOWN
    return out if saw else UNKNOWN


class DeviceTaint:
    """Per-function return summaries + per-parameter taints, to fixpoint."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.returns: Dict[ast.AST, Summary] = {}
        self.params: Dict[Tuple[ast.AST, str], str] = {}
        # per-round inputs precomputed once: re-walking every function AST
        # and re-resolving every call site each fixpoint round dominated
        # the analyzer's runtime before being hoisted here
        self._returns_of: Dict[ast.AST, List[ast.AST]] = {}
        self._callee_sites: Dict[ast.AST, list] = {}
        for info in graph.infos.values():
            self._returns_of[info.node] = [
                n.value
                for n in ast.walk(info.node)
                if isinstance(n, ast.Return)
                and n.value is not None
                and info.ctx.enclosing_function(n) is info.node
            ]
            sites = [
                (site, targets)
                for site, targets in graph.callees(info)
                if targets
            ]
            if sites:
                self._callee_sites[info.node] = sites
        self._solve()

    # -- public -------------------------------------------------------------

    def classify(
        self, ctx: FileContext, fn: Optional[ast.AST], expr: ast.AST
    ) -> str:
        """'device' | 'host' | 'unknown' for an expression at a rule's
        query site, with parameters resolved through the computed
        cross-call taints."""
        v = self._classify(ctx, fn, expr, 0, symbolic=False)
        return v if isinstance(v, str) else UNKNOWN

    def return_summary(self, node: ast.AST) -> Summary:
        return self.returns.get(node, UNKNOWN)

    # -- fixpoint -----------------------------------------------------------

    def _solve(self, max_rounds: int = 8) -> None:
        infos = list(self.graph.infos.values())
        for _ in range(max_rounds):
            changed = False
            for info in infos:
                new = self._summarize(info)
                if self.returns.get(info.node) != new:
                    self.returns[info.node] = new
                    changed = True
            changed |= self._flow_params(infos)
            if not changed:
                return

    def _summarize(self, info: FunctionInfo) -> Summary:
        ctx, fn = info.ctx, info.node
        verdicts: List[str] = []
        passthrough: Set[str] = set()
        for ret in self._returns_of.get(fn, ()):
            v = self._classify(ctx, fn, ret, 0, symbolic=True)
            if isinstance(v, tuple) and v[0] == "param":
                passthrough.add(v[1])
            else:
                verdicts.append(v)
        if DEVICE in verdicts:
            return DEVICE
        if passthrough:
            # host-valued alternate returns don't break passthrough — the
            # call site join handles them
            if all(v == HOST for v in verdicts) or not verdicts:
                return ("passthrough", frozenset(passthrough))
            return UNKNOWN
        if verdicts and all(v == HOST for v in verdicts):
            return HOST
        return UNKNOWN

    def _flow_params(self, infos: Sequence[FunctionInfo]) -> bool:
        """Argument taint -> parameter taint, joined over every resolved
        call site. A parameter nobody is seen calling stays UNKNOWN."""
        incoming: Dict[Tuple[ast.AST, str], List[str]] = {}
        for info in infos:
            for site, targets in self._callee_sites.get(info.node, ()):
                arg_taints = [
                    self._arg_taint(site.ctx, info.node, a)
                    for a in site.call.args
                ]
                kw_taints = {
                    kw.arg: self._arg_taint(site.ctx, info.node, kw.value)
                    for kw in site.call.keywords
                    if kw.arg is not None
                }
                for tgt in targets:
                    names = tgt.ctx.param_names(tgt.node)
                    if names and names[0] == "self":
                        names = names[1:]
                    for i, t in enumerate(arg_taints):
                        if i < len(names):
                            incoming.setdefault(
                                (tgt.node, names[i]), []
                            ).append(t)
                    for k, t in kw_taints.items():
                        if k in names:
                            incoming.setdefault((tgt.node, k), []).append(t)
        changed = False
        for key, taints in incoming.items():
            new = _join(taints)
            if self.params.get(key, UNKNOWN) != new:
                self.params[key] = new
                changed = True
        return changed

    def _arg_taint(
        self, ctx: FileContext, fn: Optional[ast.AST], expr: ast.AST
    ) -> str:
        v = self._classify(ctx, fn, expr, 0, symbolic=False)
        return v if isinstance(v, str) else UNKNOWN

    # -- the expression classifier ------------------------------------------

    def _classify(
        self,
        ctx: FileContext,
        fn: Optional[ast.AST],
        expr: ast.AST,
        depth: int,
        symbolic: bool,
    ):
        """-> DEVICE | HOST | UNKNOWN | ("param", name) (symbolic mode
        keeps parameters symbolic for passthrough summaries; query mode
        resolves them through the cross-call taints)."""
        if depth > 6:
            return UNKNOWN
        if isinstance(expr, ast.Constant):
            return HOST
        if isinstance(expr, (ast.JoinedStr, ast.FormattedValue, ast.Dict,
                             ast.DictComp, ast.Lambda)):
            return HOST
        if isinstance(expr, ast.Attribute):
            if expr.attr in _HOST_ATTRS:
                return HOST
            return self._classify(ctx, fn, expr.value, depth + 1, symbolic)
        if isinstance(expr, ast.Subscript):
            return self._classify(ctx, fn, expr.value, depth + 1, symbolic)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            vs = [
                self._classify(ctx, fn, e, depth + 1, symbolic)
                for e in expr.elts
            ]
            if DEVICE in vs:
                return DEVICE  # a container OF device values syncs too
            return HOST
        if isinstance(expr, ast.Call):
            return self._classify_call(ctx, fn, expr, depth, symbolic)
        if isinstance(expr, (ast.BinOp, ast.BoolOp, ast.Compare, ast.UnaryOp)):
            if isinstance(expr, ast.BinOp):
                sides = [expr.left, expr.right]
            elif isinstance(expr, ast.BoolOp):
                sides = list(expr.values)
            elif isinstance(expr, ast.Compare):
                sides = [expr.left] + list(expr.comparators)
            else:
                sides = [expr.operand]
            vs = [
                self._classify(ctx, fn, s, depth + 1, symbolic)
                for s in sides
            ]
            if DEVICE in vs:
                return DEVICE
            if any(isinstance(v, tuple) for v in vs):
                # arithmetic ON a param is still param-shaped
                name = next(v[1] for v in vs if isinstance(v, tuple))
                return ("param", name)
            return _join(v for v in vs if isinstance(v, str))
        if isinstance(expr, ast.IfExp):
            vs = [
                self._classify(ctx, fn, s, depth + 1, symbolic)
                for s in (expr.body, expr.orelse)
            ]
            if DEVICE in vs:
                return DEVICE
            return _join(v if isinstance(v, str) else UNKNOWN for v in vs)
        if isinstance(expr, ast.Name):
            narrowed = _narrowed(ctx, fn, expr)
            if narrowed is not None:
                return narrowed
            return self._classify_name(ctx, fn, expr.id, depth, symbolic)
        return UNKNOWN

    def _classify_name(
        self,
        ctx: FileContext,
        fn: Optional[ast.AST],
        name: str,
        depth: int,
        symbolic: bool,
    ):
        if fn is not None and name in ctx.param_names(fn):
            # parameter: symbolic for summaries, cross-call taint for rules
            assigns = ctx.assignments(fn, name)
            if not assigns and not ctx.unpacks(fn, name):
                if symbolic:
                    return ("param", name)
                return self.params.get((fn, name), UNKNOWN)
        verdicts = []
        for v in ctx.assignments(fn, name):
            verdicts.append(self._classify(ctx, fn, v, depth + 1, symbolic))
        for v, i in ctx.unpacks(fn, name):
            # `a, b = x, y` binds element-wise; `a, b = f(..)` binds the
            # same element of every tuple f returns, or else f's verdict
            got = None
            if i is not None and isinstance(v, (ast.Tuple, ast.List)):
                v = v.elts[i]
            elif i is not None and isinstance(v, ast.Call):
                got = self._unpacked_element(ctx, v, i, depth)
            if got is None:
                got = self._classify(ctx, fn, v, depth + 1, symbolic)
            verdicts.append(UNKNOWN if isinstance(got, tuple) else got)
        if DEVICE in verdicts:
            return DEVICE
        params = [v for v in verdicts if isinstance(v, tuple)]
        if params:
            return params[0]
        if verdicts:
            return _join(verdicts)
        return UNKNOWN

    def _unpacked_element(
        self, ctx: FileContext, call: ast.Call, i: int, depth: int
    ) -> Optional[str]:
        """Element ``i`` of what ``call`` returns, when every resolved
        target returns only tuple literals that long (``return idx,
        int(n)``): each element classified in its callee, parameters
        through the cross-call taints. None when that does not hold."""
        targets = self.graph.resolve_call(ctx, call)
        if not targets:
            return None
        vs: List[str] = []
        for tgt in targets:
            rets = self._returns_of.get(tgt.node, ())
            if not rets or not all(
                isinstance(r, ast.Tuple) and len(r.elts) > i for r in rets
            ):
                return None
            for r in rets:
                v = self._classify(
                    tgt.ctx, tgt.node, r.elts[i], depth + 1, symbolic=False
                )
                vs.append(v if isinstance(v, str) else UNKNOWN)
        if DEVICE in vs:
            return DEVICE
        return _join(vs)

    def _classify_call(
        self,
        ctx: FileContext,
        fn: Optional[ast.AST],
        call: ast.Call,
        depth: int,
        symbolic: bool,
    ):
        name = dotted_name(call.func)
        if name in _HOST_BUILTINS or ".shape" in name:
            return HOST
        if is_host_intrinsic(name, call):
            return HOST
        if is_device_intrinsic(name):
            return DEVICE
        if name in ("int", "float", "bool"):
            return HOST  # the sync itself produces a host scalar
        # metadata calls and the syncs (.item(), .tolist(), .cpu(),
        # .numpy(), .to("cpu")) RETURN host values regardless of the
        # receiver (the host-sync rule looks at their receivers itself)
        if isinstance(call.func, ast.Attribute):
            leaf = call.func.attr
            if leaf in _METADATA_FUNCS or leaf in _SYNC_RESULTS:
                return HOST
            if leaf == "to" and _to_cpu(call):
                return HOST
        targets = self.graph.resolve_call(ctx, call)
        if targets:
            vs: List[str] = []
            for tgt in targets:
                summary = self.returns.get(tgt.node, UNKNOWN)
                if isinstance(summary, tuple):
                    vs.append(
                        self._passthrough_at_site(
                            ctx, fn, call, tgt, summary[1], depth, symbolic
                        )
                    )
                else:
                    vs.append(summary)
            if DEVICE in vs:
                return DEVICE
            return _join(vs)
        if isinstance(call.func, ast.Attribute):
            recv = self._classify(
                ctx, fn, call.func.value, depth + 1, symbolic
            )
            if recv == DEVICE:
                return DEVICE
        return UNKNOWN

    def _passthrough_at_site(
        self,
        ctx: FileContext,
        fn: Optional[ast.AST],
        call: ast.Call,
        tgt: FunctionInfo,
        param_names: frozenset,
        depth: int,
        symbolic: bool,
    ) -> str:
        names = tgt.ctx.param_names(tgt.node)
        if names and names[0] == "self":
            names = names[1:]
        taints: List[str] = []
        for i, arg in enumerate(call.args):
            if i < len(names) and names[i] in param_names:
                v = self._classify(ctx, fn, arg, depth + 1, symbolic)
                taints.append(v if isinstance(v, str) else UNKNOWN)
        for kw in call.keywords:
            if kw.arg in param_names:
                v = self._classify(ctx, fn, kw.value, depth + 1, symbolic)
                taints.append(v if isinstance(v, str) else UNKNOWN)
        if DEVICE in taints:
            return DEVICE
        return _join(taints) if taints else UNKNOWN


# -- blocking summaries ------------------------------------------------------

# calls that block the calling thread outright, by dotted name or prefix
_BLOCKING_EXACT = {
    "time.sleep": "time.sleep",
    "os.system": "os.system",
    "socket.create_connection": "socket.create_connection",
}
_BLOCKING_PREFIXES = (
    ("subprocess.", "subprocess"),
    ("requests.", "requests network I/O"),
    ("urllib.request.", "urllib network I/O"),
)
# attribute leaves that block when called on anything: the engine's own
# synchronous query entry and warm-up
_BLOCKING_ATTRS = {
    "cypher": "session.cypher (synchronous engine execution)",
    "warmup": "warmup (compiles synchronously)",
}

_SYNC_BUILTINS = ("int", "float", "bool")
_SYNC_ASARRAY = ("np.asarray", "numpy.asarray", "np.array", "numpy.array")


def sync_shape(call: ast.Call) -> Optional[Tuple[str, Optional[ast.AST], bool]]:
    """The sync kind this call's shape names, whatever its operand holds:
    (kind, operand, strict), or None. ``operand`` None: the call always
    syncs; ``strict``: it syncs when the operand is a device value, else
    unless the operand is proven host (``.item()``, ``.cpu()``,
    ``.numpy()`` and ``.to("cpu")`` exist only on arrays and tensors;
    ``int``, ``float``, ``bool``, ``np.asarray`` and ``.tolist()`` also
    take host containers)."""
    name = dotted_name(call.func)
    if name == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()", None, False
    if name in _SYNC_BUILTINS and len(call.args) == 1:
        return f"{name}(<device value>)", call.args[0], True
    if name in _SYNC_ASARRAY and call.args:
        return f"{name}(<device value>)", call.args[0], True
    if not isinstance(call.func, ast.Attribute):
        return None
    leaf, recv = call.func.attr, call.func.value
    if leaf in ("item", "cpu", "numpy") and not call.args:
        return f".{leaf}()", recv, False
    if leaf == "tolist" and not call.args:
        return ".tolist()", recv, True
    if leaf == "to" and _to_cpu(call):
        return '.to("cpu")', recv, False
    if leaf == "synchronize" and not call.args:
        return ".synchronize()", None, False
    if leaf == "elapsed_time":
        return ".elapsed_time()", None, False
    return None


def sync_kind(
    taint: "DeviceTaint", ctx: FileContext, fn: Optional[ast.AST], call: ast.Call
) -> Optional[str]:
    """The device->host sync this call forces, or None: ``int``/``float``/
    ``bool``, ``.tolist()`` and ``np.asarray`` of a device value,
    ``.item()``/``.cpu()``/``.numpy()``/``.to("cpu")`` of anything not
    proven host, ``torch.cuda.synchronize()``, and an event's or stream's
    ``.synchronize()``/``.elapsed_time()``. Shared by the host-sync rule
    and the blocking summaries, so both agree on what a sync is."""
    shape = sync_shape(call)
    if shape is None:
        return None
    kind, operand, strict = shape
    if operand is None:
        return kind
    verdict = taint.classify(ctx, fn, operand)
    if verdict == DEVICE or (not strict and verdict != HOST):
        return kind
    return None


class BlockingInfo:
    """Why a function blocks: the call chain down to the intrinsic."""

    __slots__ = ("chain",)

    def __init__(self, chain: Tuple[str, ...]):
        self.chain = chain

    def via(self, hop: str) -> "BlockingInfo":
        return BlockingInfo((hop,) + self.chain)

    def render(self) -> str:
        return " -> ".join(self.chain)


def blocking_intrinsic(call: ast.Call) -> Optional[str]:
    """The human-readable reason this call blocks the thread, or None."""
    name = dotted_name(call.func)
    if name in _BLOCKING_EXACT:
        return _BLOCKING_EXACT[name]
    for prefix, why in _BLOCKING_PREFIXES:
        if name.startswith(prefix):
            return why
    if isinstance(call.func, ast.Attribute):
        leaf = call.func.attr
        if leaf in _BLOCKING_ATTRS:
            return _BLOCKING_ATTRS[leaf]
        # sock.recv/accept/connect: only when the receiver LOOKS like a
        # socket (named sock/socket/conn_sock) — keeps asyncio writers out
        if leaf in ("recv", "accept", "connect", "sendall"):
            recv_name = dotted_name(call.func.value)
            if "sock" in recv_name.split(".")[-1]:
                return f"socket.{leaf}"
    return None


class BlockingSummaries:
    """Transitive can-block verdicts for every project function."""

    def __init__(self, graph: CallGraph, taint: DeviceTaint):
        self.graph = graph
        self.taint = taint
        self.blocks: Dict[ast.AST, BlockingInfo] = {}
        self._solve()

    def direct_reason(
        self, info: FunctionInfo, site_call: ast.Call
    ) -> Optional[str]:
        """The reason this ONE call blocks the calling thread (an intrinsic
        or a taint-resolved device sync), or None. Shared with the
        async-blocking rule so both agree on what 'blocking' means."""
        reason = blocking_intrinsic(site_call)
        if reason is not None:
            return reason
        # a device sync blocks on the device stream
        sync = sync_kind(self.taint, info.ctx, info.node, site_call)
        return None if sync is None else f"{sync} (device sync)"

    def _solve(self, max_rounds: int = 12) -> None:
        infos = list(self.graph.infos.values())
        # seed: direct intrinsics (never through a lambda — deferred)
        for info in infos:
            for site, _targets in self.graph.callees(info):
                if site.in_lambda:
                    continue
                reason = self.direct_reason(info, site.call)
                if reason is not None and info.node not in self.blocks:
                    self.blocks[info.node] = BlockingInfo((reason,))
        for _ in range(max_rounds):
            changed = False
            for info in infos:
                if info.node in self.blocks or info.is_async:
                    # an async def never blocks its CALLER by being called
                    # (calling it just builds a coroutine)
                    continue
                for site, targets in self.graph.callees(info):
                    if site.in_lambda:
                        continue
                    for tgt in targets:
                        if tgt.is_async:
                            continue
                        sub = self.blocks.get(tgt.node)
                        if sub is not None:
                            self.blocks[info.node] = sub.via(
                                f"{tgt.qualname}()"
                            )
                            changed = True
                            break
                    if info.node in self.blocks:
                        break
            if not changed:
                return

    def blocking_reason(self, node: ast.AST) -> Optional[BlockingInfo]:
        return self.blocks.get(node)
