"""Abstract shape interpretation: the semantic layer under the shape rules.

The port's counterpart of ``tpu_cypher/analysis/shapes.py`` (it imports
nothing of it), retargeted from ``jnp.f(x)`` to the port's torch idiom:
torch functions (``torch.f(x)``), tensor methods (``x.cumsum(0)``,
``x.new_zeros(n)``), subscript gathers (``x[idx]``) and the torch-op
library (``J.f``). It interprets the tensor code of ``backend/cuda/``,
``parallel/`` and ``relational/`` over an abstract shape lattice:

* ``STATIC(n)`` — a fixed extent (a literal, the shape of an already
  padded tensor, a parameter the caller sizes);
* ``BUCKETED(lattice, origin)`` — an extent that routes through one of the
  ``bucketing`` rounding helpers, so it takes at most a bounded number of
  distinct values (one launch shape per lattice rung, not per count).
  ``masked`` additionally records that the pad lanes past the true count
  have been proven neutral (a 3-arg ``torch.where`` or ``masked_fill``, a
  comparison against a ``torch.arange`` iota, ``jit_ops._live_lanes``);
* ``DATA_DEPENDENT`` — an unrounded data-dependent count (a synced
  reduction, an unsized ``torch.nonzero``, a boolean-mask index): one
  launch shape per distinct value if it reaches the kernel gate;
* ``UNKNOWN`` — the conservative top. UNKNOWN never fires a rule: every
  sharp verdict requires positive evidence.

PyTorch runs eagerly, so no extent compiles a program; what the lattice
still buys in the port is a bounded set of launch shapes at the kernel
gate (``hopper/dispatch.launch`` and the ``size=`` of the ``hopper/*``
gates) — the number a later captured launch per shape would cost — and
what the pad-mask discipline guards is still every answer computed over
padded lanes.

Two classification *facets* share one recursive evaluator: the SIZE facet
("what count does this integer expression hold?") and the ARRAY facet
("what is the leading-dim extent of this tensor expression?"). A
reduction is a STATIC scalar as an array but a DATA_DEPENDENT value as a
size. A function whose every return is a tuple literal keeps one summary
per position, so ``idx, n = helper(mask)`` classifies ``idx`` and ``n``
apart.

Function boundaries use the port's call graph (``callgraph.py``):
per-function return summaries (a fixed verdict or a parameter
passthrough) solved to a fixpoint, with argument shape classes flowing
into parameter shape classes across every resolved call site.

``collect_facts`` exports what the interpreter knows as a
schema-versioned JSON artifact: the per-operator padded-shape catalog plus
every classified site where the lattice acts or could act (sized
materializes, the rounding calls themselves, helper calls that hand back
padded lanes, and the extents bound at the kernel gates).
``predict_padded`` is the pure (engine-import-free) re-derivation of
``bucketing.round_size`` that makes static predictions comparable with
the (true, padded) pairs trace spans stamp at run time; a test pins the
two equal so they cannot drift.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple, Union

from .core import FileContext, dotted_name

# directories whose tensor code the interpreter covers
SCOPE_DIRS = ("backend/cuda/", "parallel/", "relational/")
_BUCKETING_SUFFIX = "backend/cuda/bucketing.py"

FACTS_SCHEMA_VERSION = 1

# the smallest nonzero bucket — mirrors bucketing._BUCKET_FLOOR; pinned
# equal by tests/test_torch_shapes.py so the pure predictor cannot drift
BUCKET_FLOOR = 32

# ---------------------------------------------------------------------------
# the abstract domain
# ---------------------------------------------------------------------------

STATIC_KIND = "static"
BUCKETED_KIND = "bucketed"
DATA_KIND = "data"
UNKNOWN_KIND = "unknown"

_RANK = {STATIC_KIND: 0, BUCKETED_KIND: 1, DATA_KIND: 2, UNKNOWN_KIND: 3}

# static upper bound on distinct lattice rungs a bucketed size can take
# (counts up to 2^40 rows): the bucket-cardinality bound exported per site
BUCKET_BOUNDS = {
    "pow2": 36,       # pow2 rungs from the floor to 2^40
    "1.25": 112,      # 1.25-ratio rungs over the same range
    "mode": 112,      # round_size: whichever lattice MODE selects
    "multiple": 64,   # round_up_multiple: bounded by the padded axis cap
    "derived": 160,   # concatenations/sums of bucketed extents
}


@dataclass(frozen=True)
class ShapeVal:
    """One point of the abstract shape lattice."""

    kind: str
    n: Optional[int] = None       # known extent (STATIC only)
    lattice: Optional[str] = None  # pow2 | 1.25 | mode | multiple | derived
    origin: str = ""              # where the class was introduced
    masked: bool = False          # pad lanes proven neutral (BUCKETED)
    iota: bool = False            # an arange over the axis (compare => mask)
    # per-position classes of a tuple value (a function's tuple return,
    # the expand gate's (row, nbr, orig, live)): what an unpacking target
    # at that position takes; the fields above are their join
    parts: Optional[Tuple["ShapeVal", ...]] = None

    def render(self) -> str:
        if self.kind == STATIC_KIND:
            return f"static({self.n})" if self.n is not None else "static"
        if self.kind == BUCKETED_KIND:
            m = ", masked" if self.masked else ""
            return f"bucketed({self.lattice}{m})"
        if self.kind == DATA_KIND:
            o = f": {self.origin}" if self.origin else ""
            return f"data-dependent{o}"
        return "unknown"


def STATIC(n: Optional[int] = None, **kw) -> ShapeVal:
    return ShapeVal(STATIC_KIND, n=n, **kw)


def BUCKETED(lattice: str, origin: str = "", masked: bool = False) -> ShapeVal:
    return ShapeVal(BUCKETED_KIND, lattice=lattice, origin=origin, masked=masked)


def DATA(origin: str = "") -> ShapeVal:
    return ShapeVal(DATA_KIND, origin=origin)


UNKNOWN_SHAPE = ShapeVal(UNKNOWN_KIND)


def join(vals: Iterable[ShapeVal], masked_any: bool = False) -> ShapeVal:
    """Lattice join. UNKNOWN absorbs everything (a rule never fires on a
    join it did not fully understand); DATA absorbs BUCKETED absorbs
    STATIC. ``masked_any`` selects the mask-combining policy: AND over the
    bucketed contributors by default (every padded one must be proven
    neutral; a static extent has no pad lanes), OR for operators that
    force pads dead when ANY operand does (``x & live``, ``x * live``).
    Tuple values of one width join position by position."""
    vals = list(vals)
    if not vals:
        return UNKNOWN_SHAPE
    if len(vals) == 1:
        return vals[0]
    out = _join_flat(vals, masked_any)
    widths = {len(v.parts) if v.parts is not None else -1 for v in vals}
    if out.kind != UNKNOWN_KIND and len(widths) == 1 and -1 not in widths:
        out = replace(out, parts=tuple(
            join([v.parts[i] for v in vals]) for i in range(widths.pop())
        ))
    return out


def _join_flat(vals: List[ShapeVal], masked_any: bool) -> ShapeVal:
    top = max(vals, key=lambda v: _RANK[v.kind])
    if top.kind == UNKNOWN_KIND:
        return UNKNOWN_SHAPE
    if top.kind == DATA_KIND:
        return replace(top, parts=None)
    if top.kind == BUCKETED_KIND:
        bucketed = [v for v in vals if v.kind == BUCKETED_KIND]
        lattices = {v.lattice for v in bucketed}
        lattice = lattices.pop() if len(lattices) == 1 else "derived"
        if masked_any:
            masked = any(v.masked for v in vals)
        else:
            masked = all(v.masked for v in bucketed)
        return BUCKETED(lattice, origin=bucketed[0].origin, masked=masked)
    ns = {v.n for v in vals}
    return STATIC(ns.pop() if len(ns) == 1 else None,
                  iota=any(v.iota for v in vals))


def tuple_val(vals: List[ShapeVal]) -> ShapeVal:
    """A tuple value: the join of its elements, with each kept at its
    position."""
    out = join(vals) if len(vals) != 1 else replace(vals[0], parts=None)
    if out.kind == UNKNOWN_KIND:
        return out
    return replace(out, parts=tuple(vals))


def pick(v: ShapeVal, pos: Optional[int]) -> ShapeVal:
    """Position ``pos`` of a tuple value (the whole value when it has no
    positions)."""
    if pos is not None and v.parts is not None and pos < len(v.parts):
        return v.parts[pos]
    return v


# ---------------------------------------------------------------------------
# the pure padded-shape predictor (no engine import: the agreement test
# pins it equal to bucketing.round_size so the two can never drift)
# ---------------------------------------------------------------------------


def predict_padded(n: int, mode: str = "pow2") -> int:
    """The padded extent ``bucketing.round_size`` produces for a true
    count ``n`` under lattice ``mode`` — re-derived from the lattice
    definition alone. ``n <= 0`` stays 0; ``off`` is identity."""
    n = int(n)
    if n <= 0:
        return 0
    if mode == "off":
        return n
    if mode == "1.25":
        rung = BUCKET_FLOOR
        while rung < n:
            rung = max(rung + 1, int(rung * 1.25))
        return rung
    # pow2: smallest power of two >= max(n, floor)
    m = max(n, BUCKET_FLOOR)
    return 1 << (m - 1).bit_length() if m > 1 else 1


# ---------------------------------------------------------------------------
# the transfer catalog: how each torch operation the port uses maps input
# shape classes to its padded output shape. This table IS the per-operator
# facts payload; the evaluator's call transfer consults the same leaf sets.
# ---------------------------------------------------------------------------

# keyword arguments that fix a materialize's output extent
SIZE_KWARGS = ("size", "output_size", "minlength")

_REDUCERS = frozenset(
    "sum prod mean min max amin amax aminmax any all argmin argmax "
    "count_nonzero nansum nanmean median nanmedian logsumexp std var "
    "mask_sum".split()
)
_SORTS = frozenset("sort argsort msort _lexsort".split())
_ELEMENTWISE = frozenset(
    "abs clamp clip minimum maximum logical_and logical_or logical_not "
    "logical_xor isnan isfinite isinf sign neg negative add sub subtract mul "
    "multiply div divide true_divide floor_divide remainder fmod eq ne lt le "
    "gt ge bitwise_and bitwise_or bitwise_xor bitwise_not bitwise_left_shift "
    "bitwise_right_shift exp log log2 sqrt floor ceil round trunc isin "
    "signbit square pow".split()
)
# tensor methods / functions that keep the leading extent of their source
_PRESERVING = frozenset(
    "reshape view view_as ravel flatten contiguous clone detach to type long "
    "int short bool float double half byte char squeeze unsqueeze cpu cuda "
    "abs_ clamp_ neg_ add_ sub_ mul_ div_ fill_ zero_ copy_ masked_fill_ "
    "index_add_ index_add scatter_add_ scatter_add scatter_reduce_ "
    "scatter_reduce scatter_ scatter index_put_ index_put index_copy_ "
    "index_fill_ index_fill".split()
)
# method-form receivers whose extent is a parameter's, not the receiver's
_ALLOC_LIKE = frozenset("zeros_like ones_like empty_like full_like rand_like "
                        "randn_like".split())
_ALLOC = frozenset("zeros ones empty full rand randn randint".split())
_NEW_ALLOC = frozenset("new_zeros new_ones new_empty new_full".split())
_GATHERS = frozenset("index_select gather take take_along_dim".split())
_UNSIZED = frozenset("nonzero argwhere unique unique_consecutive "
                     "masked_select".split())
# calls that produce a liveness mask over their first argument's lanes
_LIVE_MASKS = frozenset(("_live_lanes", "row_tail_mask"))
_ROUNDER_LATTICE = {
    "round_size": "mode",
    "round_up_pow2": "pow2",
    "round_up_multiple": "multiple",
    "bucket_pad_host": "mode",
}
# the expand_rows gate (and its plain version) returns (row, nbr, orig,
# live): ``live`` is lane < nvalid, written by the kernel
_LIVE_OUTPUT = {"expand_materialize_counted": 3}
# ``bucketing.exact_size``: the rounder's records without the lattice
_IDENTITY_SIZE = ("exact_size",)
# dotted prefixes of module-level (function-form) tensor calls
_DEVICE_PREFIXES = ("torch.", "J.", "jit_ops.", "F.", "np.", "numpy.")
_LAUNCH_NAMES = ("dispatch.launch", "launch")

# the exported per-operator padded-shape formulas, as functions of the
# abstract inputs. ``padded_shape`` is the leading-dim extent of the
# result; ``class`` names the transfer family the evaluator applies.
OPERATOR_FORMULAS: List[Dict[str, str]] = [
    {"op": "torch.nonzero|x.nonzero|argwhere|masked_select",
     "class": "sized_materialize",
     "padded_shape": "DATA_DEPENDENT (torch has no size= form; the sized "
                     "form is J.mask_nonzero)"},
    {"op": "J.mask_nonzero", "class": "sized_materialize",
     "padded_shape": "size"},
    {"op": "torch.repeat_interleave|x.repeat_interleave",
     "class": "sized_materialize",
     "padded_shape": "output_size (DATA_DEPENDENT when absent and repeats "
                     "is a tensor)"},
    {"op": "torch.unique|x.unique|unique_consecutive",
     "class": "sized_materialize", "padded_shape": "DATA_DEPENDENT"},
    {"op": "torch.bincount|x.bincount", "class": "sized_materialize",
     "padded_shape": "minlength (DATA_DEPENDENT when absent)"},
    {"op": "x.index_add_|scatter_add_|scatter_reduce|index_put_",
     "class": "segment",
     "padded_shape": "the receiver's extent (the segment table allocated "
                     "beforehand)"},
    {"op": "torch.where", "class": "select",
     "padded_shape": "join(x, y); masked=True (3-arg form); "
                     "DATA_DEPENDENT (1-arg form)"},
    {"op": "x.masked_fill", "class": "select",
     "padded_shape": "the receiver's extent; masked=True (the method form "
                     "of a 3-arg where)"},
    {"op": "torch.arange|J._arange", "class": "iota",
     "padded_shape": "end; iota=True (a compare against it is a liveness "
                     "mask)"},
    {"op": "J._live_lanes|J.row_tail_mask", "class": "iota",
     "padded_shape": "the lane extent; masked=True (lane < nvalid)"},
    {"op": "torch.zeros|ones|full|empty|x.new_zeros|new_ones|new_full|"
           "new_empty",
     "class": "alloc", "padded_shape": "shape[0]"},
    {"op": "torch.zeros_like|ones_like|empty_like|full_like",
     "class": "alloc", "padded_shape": "the template's extent"},
    {"op": "torch.cat|stack|hstack|J.concat_pair", "class": "concat",
     "padded_shape": "sum(parts) -> bucketed(derived) when any part is "
                     "bucketed"},
    {"op": "x.reshape|view|flatten|contiguous|clone|to|squeeze|unsqueeze",
     "class": "preserve", "padded_shape": "input (leading extent kept)"},
    {"op": "F.pad", "class": "pad",
     "padded_shape": "input + pad; masked=False (fresh pad lanes are live "
                     "garbage until masked)"},
    {"op": "torch.sort|argsort|x.sort|x.argsort|J._lexsort", "class": "sort",
     "padded_shape": "input (pad-sensitive consumer: pads must sort last "
                     "via the ID_SENTINEL discipline)"},
    {"op": "torch.searchsorted", "class": "search",
     "padded_shape": "shape(v); the sorted operand is the pad-sensitive "
                     "side"},
    {"op": "torch.cumsum|x.cumsum|cummax", "class": "scan",
     "padded_shape": "input; masked=False (pad lanes absorb the running "
                     "total)"},
    {"op": "x[idx]|index_select|gather|take", "class": "gather",
     "padded_shape": "shape(idx); masked=False (pad lanes gather "
                     "duplicate payload); x[mask] is DATA_DEPENDENT"},
    {"op": "torch.sum|amin|amax|any|all|argmin|argmax|count_nonzero|x.sum",
     "class": "reduction",
     "padded_shape": "scalar as a tensor; DATA_DEPENDENT as a size"},
    {"op": "torch.topk|x.topk", "class": "sized_materialize",
     "padded_shape": "k"},
    {"op": "x.narrow|torch.narrow", "class": "sized_materialize",
     "padded_shape": "length"},
    {"op": "torch.mm|matmul|a @ b", "class": "contraction",
     "padded_shape": "shape(lhs)[0]"},
    {"op": "bucketing.round_size", "class": "rounder",
     "padded_shape": "bucketed(mode): next rung of the active lattice "
                     "(pow2 floor 32 | 1.25 ratio from 32)"},
    {"op": "bucketing.round_up_pow2", "class": "rounder",
     "padded_shape": "bucketed(pow2): 1 << ceil(log2(max(n, floor)))"},
    {"op": "bucketing.round_up_multiple", "class": "rounder",
     "padded_shape": "bucketed(multiple): ceil(n / m) * m"},
    {"op": "bucketing.bucket_pad_host", "class": "rounder",
     "padded_shape": "bucketed(mode): host tail-pad up to round_size"},
    {"op": "bucketing.exact_size", "class": "identity",
     "padded_shape": "n (the rounder's records with padded == true: a "
                     "declared exact-size site)"},
    {"op": "int|float|bool|x.item|x.tolist", "class": "sync",
     "padded_shape": "preserves the size class of the synced operand "
                     "(a synced DATA_DEPENDENT count stays DATA_DEPENDENT)"},
    # the reference's factorized run-decompress family (_runs_weights,
    # _decode_runs, _gather_decoded) has one counterpart in the port: the
    # decode sizes every chunk exactly and runs the lane search on the
    # expand_rows gate, so no run prefix is padded and no sentinel mask
    # is needed (backend/cuda/factorized.py)
    {"op": "factorized.decode_lanes", "class": "run_decode",
     "padded_shape": "hi - lo (the chunk's flat rows, exact: "
                     "bucketing.exact_size on the expand_rows gate's "
                     "size=); lanes gathered at the decoded extent"},
    {"op": "hopper.expand_materialize_counted", "class": "gate",
     "padded_shape": "size (the lanes the expand_rows kernel writes; "
                     "lanes past nvalid come out dead)"},
    {"op": "hopper.segment_aggregate", "class": "gate",
     "padded_shape": "k (one output row per group)"},
    {"op": "hopper.join_probe|intersect_range_count|"
           "csr_frontier_degree_sum",
     "class": "gate",
     "padded_shape": "the probe operand's extent (a count for the "
                     "frontier sum)"},
]


def in_scope(relpath: str) -> bool:
    if relpath.endswith(_BUCKETING_SUFFIX):
        return False  # the lattice itself
    return any(d in relpath for d in SCOPE_DIRS)


def call_leaf(call: ast.Call) -> str:
    """The called name's last segment: ``torch.sum`` and ``x[i].sum``
    both give ``sum``."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def is_function_form(call: ast.Call) -> bool:
    """``torch.f(x)`` / ``J.f(x)`` rather than the method ``x.f()``."""
    return dotted_name(call.func).startswith(_DEVICE_PREFIXES)


def launches(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    return name in _LAUNCH_NAMES or name.endswith(".dispatch.launch")


def host_numpy(call: ast.Call) -> bool:
    """``np.bincount(.., minlength=)``: a host array, not device lanes."""
    return dotted_name(call.func).startswith(("np.", "numpy."))


def size_kwarg(call: ast.Call) -> Optional[ast.keyword]:
    """The ``size=``/``output_size=``/``minlength=`` of a device
    materialize (host numpy calls have none)."""
    if host_numpy(call):
        return None
    return next((kw for kw in call.keywords if kw.arg in SIZE_KWARGS), None)


# ---------------------------------------------------------------------------
# the kernel boundary: gates and registered impls
# ---------------------------------------------------------------------------


def _bound_args(call: ast.Call, names: List[str]) -> List[Tuple[str, ast.AST]]:
    """(parameter name, argument expression) for each argument of ``call``
    bound to a named parameter of the target (``self`` already dropped)."""
    out = []
    for i, a in enumerate(call.args):
        if isinstance(a, ast.Starred):
            break
        if i < len(names):
            out.append((names[i], a))
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in names:
            out.append((kw.arg, kw.value))
    return out


def target_params(tgt) -> List[str]:
    """A target's parameter names, ``self`` dropped."""
    names = tgt.ctx.param_names(tgt.node)
    if names and names[0] == "self":
        names = names[1:]
    return names


class KernelBoundary:
    """Where the port's tensors meet its hand-written kernels.

    * a **gate** is a function that calls ``dispatch.launch`` itself (the
      ``hopper/*`` wrappers: ``expand_materialize_counted``,
      ``segment_aggregate``, ...);
    * a **registered impl** is a function a ``dispatch.register(..,
      impls=(..))`` of its own file names (the ctypes loaders and launch
      functions);
    * a gate's **extent parameters** are those that size what the launch
      writes: a parameter passed whole as a ``size=``/``output_size=``/
      ``minlength=`` or as the shape of an allocation under the function
      (lambdas included), or bound to an extent parameter of a function
      it calls — solved to a fixpoint over the call graph. Each distinct
      value of one is one distinct launch shape: they are what the
      reference's ``static_argnames`` were to its compile cache.
    """

    def __init__(self, project):
        graph = project.callgraph
        self.gates: Set[ast.AST] = set()
        self.impls: Set[ast.AST] = set()
        ext: Dict[ast.AST, Set[str]] = {}
        params_of: Dict[ast.AST, Set[str]] = {}
        edges: List[Tuple[ast.AST, ast.Call, Tuple]] = []
        for info in graph.infos.values():
            if info.node.name in project.impls_by_path.get(info.ctx.relpath, ()):
                self.impls.add(info.node)
            params = params_of[info.node] = set(target_params(info))
            mine = ext[info.node] = set()
            # calls_in counts a lambda's calls as the function's own: a
            # lambda handed to the gate runs on the function's arguments
            for call in info.ctx.calls_in(info.node):
                if launches(call):
                    self.gates.add(info.node)
                kw = size_kwarg(call)
                for e in (kw.value if kw is not None else None, _alloc_shape_arg(call)):
                    if isinstance(e, ast.Name) and e.id in params:
                        mine.add(e.id)
                tgts = graph.resolve_call(info.ctx, call)
                if tgts and params:
                    edges.append((info.node, call, tgts))
        for _ in range(8):
            changed = False
            for node, call, tgts in edges:
                for tgt in tgts:
                    tex = ext.get(tgt.node)
                    if not tex:
                        continue
                    for pname, arg in _bound_args(call, target_params(tgt)):
                        if (
                            pname in tex
                            and isinstance(arg, ast.Name)
                            and arg.id in params_of[node]
                            and arg.id not in ext[node]
                        ):
                            ext[node].add(arg.id)
                            changed = True
            if not changed:
                break
        self.extents: Dict[ast.AST, FrozenSet[str]] = {
            k: frozenset(v) for k, v in ext.items() if v
        }

    def gate_extents(self, tgt) -> FrozenSet[str]:
        if tgt.node not in self.gates:
            return frozenset()
        return self.extents.get(tgt.node, frozenset())


def _alloc_shape_arg(call: ast.Call) -> Optional[ast.AST]:
    """The leading-extent argument of an allocation (``torch.empty(n,
    ..)``, ``torch.zeros((n, 2))``, ``x.new_zeros(n)``), or None."""
    leaf = call_leaf(call)
    if (leaf in _ALLOC and is_function_form(call)) or leaf in _NEW_ALLOC:
        if not call.args:
            return None
        a = call.args[0]
        if isinstance(a, (ast.Tuple, ast.List)) and a.elts:
            return a.elts[0]
        return a
    return None


# ---------------------------------------------------------------------------
# the interprocedural analysis
# ---------------------------------------------------------------------------

SIZE = "size"
ARRAY = "array"

# per-(function, facet) return summary: a verdict, a passthrough, or one
# of those per position when every return is a tuple literal
Summary = Union[ShapeVal, Tuple]


_TUPLE_OPS = frozenset(
    "sort topk unique unique_consecutive kthvalue aminmax mode median "
    "nanmedian cummax cummin".split()
)


def _tuple_op(expr: ast.AST) -> bool:
    """A torch call that returns a tuple of tensors of one extent:
    ``nonzero(.., as_tuple=True)``, ``sort``, ``topk``, ``max(x, dim)``."""
    if not isinstance(expr, ast.Call):
        return False
    leaf = call_leaf(expr)
    if any(
        kw.arg == "as_tuple" and isinstance(kw.value, ast.Constant) and kw.value.value
        for kw in expr.keywords
    ):
        return True
    if leaf in _TUPLE_OPS:
        return True
    method = isinstance(expr.func, ast.Attribute) and not is_function_form(expr)
    ops = ([expr.func.value] if method else []) + list(expr.args)
    return leaf in ("max", "min") and (
        len(ops) >= 2 and isinstance(ops[1], ast.Constant)
        or any(kw.arg == "dim" for kw in expr.keywords)
    )


def _is_mask_expr(ctx: FileContext, fn, expr: ast.AST, depth: int = 0) -> bool:
    """Is ``expr`` (syntactically) a boolean mask? Indexing with one
    compacts: the result's extent is data-dependent."""
    if depth > 4:
        return False
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, (ast.Invert, ast.Not)):
        return _is_mask_expr(ctx, fn, expr.operand, depth + 1)
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _is_mask_expr(ctx, fn, expr.left, depth + 1) or _is_mask_expr(
            ctx, fn, expr.right, depth + 1
        )
    if isinstance(expr, ast.Call):
        leaf = call_leaf(expr)
        return leaf in (
            "isnan", "isfinite", "isinf", "isin", "logical_and", "logical_or",
            "logical_not", "eq", "ne", "lt", "le", "gt", "ge", "_live_lanes",
        ) or leaf.endswith("_mask")
    if isinstance(expr, ast.Name):
        return any(
            _is_mask_expr(ctx, fn, v, depth + 1)
            for v in ctx.assignments(fn, expr.id)
        )
    return False


class ShapeAnalysis:
    """Per-function shape summaries + parameter shape classes, solved to
    fixpoint over the call graph, with ShapeVal as the lattice and two
    facets per function."""

    def __init__(self, project):
        graph = project.callgraph
        self.graph = graph
        self.boundary = KernelBoundary(project)
        self.infos = [
            info for info in graph.infos.values() if in_scope(info.ctx.relpath)
        ]
        self._scope_nodes = {info.node for info in self.infos}
        # (fn node, facet) -> Summary; (fn node, param, facet) -> ShapeVal
        self.returns: Dict[Tuple[ast.AST, str], Summary] = {}
        self.params: Dict[Tuple[ast.AST, str, str], ShapeVal] = {}
        # post-fixpoint query memo: (expr node, facet) -> ShapeVal
        self._memo: Dict[Tuple[ast.AST, str], ShapeVal] = {}
        self._calls: Dict[ast.AST, Tuple[str, str, bool, bool]] = {}
        self._params: Dict[ast.AST, List[str]] = {}
        self._returns_of: Dict[ast.AST, List[ast.AST]] = {}
        for info in self.infos:
            self._returns_of[info.node] = [
                n.value
                for n in ast.walk(info.node)
                if isinstance(n, ast.Return)
                and n.value is not None
                and info.ctx.enclosing_function(n) is info.node
            ]
        self._callee_sites = {}
        for info in self.infos:
            sites = []
            for site, targets in graph.callees(info):
                if launches(site.call):
                    continue  # the gate's fan-out to every registered impl
                tgts = [t for t in targets if t.node in self._scope_nodes]
                if tgts:
                    sites.append((site, tgts))
            if sites:
                self._callee_sites[info.node] = sites
        self._solve()

    # -- public --------------------------------------------------------------

    def classify_size(
        self, ctx: FileContext, fn: Optional[ast.AST], expr: ast.AST
    ) -> ShapeVal:
        """The abstract class of an integer count expression."""
        return self._query(ctx, fn, expr, SIZE)

    def classify_array(
        self, ctx: FileContext, fn: Optional[ast.AST], expr: ast.AST
    ) -> ShapeVal:
        """The abstract leading-dim extent of a tensor expression."""
        return self._query(ctx, fn, expr, ARRAY)

    def _query(self, ctx, fn, expr, facet) -> ShapeVal:
        key = (expr, facet)
        hit = self._memo.get(key)
        if hit is None:
            v = self._eval(ctx, fn, expr, facet, 0, symbolic=False)
            hit = v if isinstance(v, ShapeVal) else UNKNOWN_SHAPE
            self._memo[key] = hit
        return hit

    # -- fixpoint ------------------------------------------------------------

    def _solve(self, max_rounds: int = 8) -> None:
        for _ in range(max_rounds):
            changed = False
            for info in self.infos:
                for facet in (SIZE, ARRAY):
                    new = self._summarize(info, facet)
                    key = (info.node, facet)
                    if self.returns.get(key) != new:
                        self.returns[key] = new
                        changed = True
            changed |= self._flow_params()
            if not changed:
                return

    def _summarize(self, info, facet: str) -> Summary:
        ctx, fn = info.ctx, info.node
        rets = self._returns_of.get(fn, ())
        if rets and all(isinstance(r, (ast.Tuple, ast.List)) for r in rets):
            width = {len(r.elts) for r in rets}
            if len(width) == 1 and not any(
                isinstance(e, ast.Starred) for r in rets for e in r.elts
            ):
                return ("tuple", tuple(
                    self._summarize_values(
                        [self._eval(ctx, fn, r.elts[i], facet, 0, True) for r in rets]
                    )
                    for i in range(width.pop())
                ))
        return self._summarize_values(
            [self._eval(ctx, fn, r, facet, 0, True) for r in rets]
        )

    @staticmethod
    def _summarize_values(vals) -> Summary:
        verdicts: List[ShapeVal] = []
        passthrough: set = set()
        masked_through = False
        for v in vals:
            if isinstance(v, tuple):
                passthrough.add(v[1])
                masked_through |= v[2]
            else:
                verdicts.append(v)
        sharp = [v for v in verdicts if v.kind in (DATA_KIND, BUCKETED_KIND)]
        if sharp:
            # any data/bucketed return dominates: report the join of the
            # sharp returns (a mixed passthrough demotes masked)
            out = join(sharp)
            if passthrough and out.kind == BUCKETED_KIND and not masked_through:
                out = replace(out, masked=False)
            return out
        if passthrough:
            return ("passthrough", frozenset(passthrough), masked_through)
        if verdicts:
            return join(verdicts)
        return UNKNOWN_SHAPE

    def _flow_params(self) -> bool:
        incoming: Dict[Tuple[ast.AST, str, str], List[ShapeVal]] = {}
        for info in self.infos:
            for site, targets in self._callee_sites.get(info.node, ()):
                for facet in (SIZE, ARRAY):
                    vals: Dict[ast.AST, ShapeVal] = {}
                    for tgt in targets:
                        for pname, a in _bound_args(site.call, self._params_of(tgt)):
                            v = vals.get(a)
                            if v is None:
                                v = vals[a] = self._arg_val(site.ctx, info.node, a, facet)
                            incoming.setdefault((tgt.node, pname, facet), []).append(v)
        changed = False
        for key, vals in incoming.items():
            new = join(vals)
            if self.params.get(key, UNKNOWN_SHAPE) != new:
                self.params[key] = new
                changed = True
        return changed

    def _arg_val(self, ctx, fn, expr, facet) -> ShapeVal:
        v = self._eval(ctx, fn, expr, facet, 0, symbolic=False)
        return v if isinstance(v, ShapeVal) else UNKNOWN_SHAPE

    # -- the evaluator -------------------------------------------------------

    def _eval(self, ctx, fn, expr, facet, depth, symbolic, pos=None):
        """-> ShapeVal | ("param", name, masked_through). Depth-capped,
        UNKNOWN on anything not understood. ``pos``: the tuple position
        an unpacking target takes from a call's result."""
        if depth > 7:
            return UNKNOWN_SHAPE
        if isinstance(expr, ast.Constant):
            if facet == SIZE and isinstance(expr.value, int):
                return STATIC(int(expr.value))
            return STATIC()
        if isinstance(expr, ast.Name):
            v = self._eval_name(ctx, fn, expr.id, facet, depth, symbolic)
            return pick(v, pos) if isinstance(v, ShapeVal) else v
        if isinstance(expr, ast.Call):
            return self._eval_call(ctx, fn, expr, facet, depth, symbolic, pos)
        if isinstance(expr, ast.Subscript):
            return self._eval_subscript(ctx, fn, expr, facet, depth, symbolic)
        if isinstance(expr, ast.Attribute):
            if expr.attr in ("shape",):
                return self._eval(ctx, fn, expr.value, ARRAY, depth + 1, symbolic)
            if expr.attr in ("indices", "values", "T", "data", "real"):
                # torch.sort(x).indices: the result's own extent
                return self._eval(ctx, fn, expr.value, ARRAY, depth + 1, symbolic)
            # other attributes (self._cap, table.nrows): precomputed state,
            # already padded/static by the time it is an attribute — but not
            # provably, so stay at the non-firing top
            return UNKNOWN_SHAPE
        if isinstance(expr, ast.BinOp):
            vs = [
                self._eval(ctx, fn, s, facet, depth + 1, symbolic)
                for s in (expr.left, expr.right)
            ]
            if isinstance(expr.op, ast.MatMult):
                return self._unmask(vs[0])
            return self._combine(
                vs, masked_any=isinstance(expr.op, (ast.Mult, ast.BitAnd))
            )
        if isinstance(expr, ast.Compare):
            sides = [expr.left] + list(expr.comparators)
            vs = [
                self._eval(ctx, fn, s, ARRAY, depth + 1, symbolic)
                for s in sides
            ]
            iota = any(isinstance(v, ShapeVal) and v.iota for v in vs)
            out = self._combine(vs, masked_any=iota)
            if iota and isinstance(out, ShapeVal):
                # lane < nvalid over an iota: THE liveness-mask idiom — pad
                # lanes are False by construction
                out = replace(out, masked=True, iota=False)
            return out
        if isinstance(expr, ast.BoolOp):
            vs = [
                self._eval(ctx, fn, s, facet, depth + 1, symbolic)
                for s in expr.values
            ]
            return self._combine(vs, masked_any=isinstance(expr.op, ast.And))
        if isinstance(expr, ast.UnaryOp):
            v = self._eval(ctx, fn, expr.operand, facet, depth + 1, symbolic)
            if isinstance(v, ShapeVal) and isinstance(expr.op, ast.Not):
                # `not live` flips pad lanes True: the mask proof does not
                # survive
                return replace(v, masked=False)
            return v
        if isinstance(expr, ast.IfExp):
            vs = [
                self._eval(ctx, fn, s, facet, depth + 1, symbolic)
                for s in (expr.body, expr.orelse)
            ]
            return self._combine(vs)
        if isinstance(expr, (ast.Tuple, ast.List)):
            if pos is not None and pos < len(expr.elts):
                return self._eval(ctx, fn, expr.elts[pos], facet, depth + 1, symbolic)
            vs = [
                self._eval(ctx, fn, e, facet, depth + 1, symbolic)
                for e in expr.elts
            ]
            if vs and all(isinstance(v, ShapeVal) for v in vs) and not any(
                isinstance(e, ast.Starred) for e in expr.elts
            ):
                return tuple_val(vs)
            return self._combine(vs)
        if isinstance(expr, ast.Starred):
            return self._eval(ctx, fn, expr.value, facet, depth + 1, symbolic)
        return UNKNOWN_SHAPE

    @staticmethod
    def _unmask(v):
        if isinstance(v, ShapeVal):
            return replace(v, masked=False, iota=False, parts=None)
        return ("param", v[1], False)

    def _combine(self, vs, masked_any: bool = False):
        params = [v for v in vs if isinstance(v, tuple)]
        shapes = [v for v in vs if isinstance(v, ShapeVal)]
        if params:
            # an op OVER a param is still param-shaped for the summary;
            # record whether a mask-forcing op was part of the chain
            masked = any(p[2] for p in params) or (
                masked_any and any(s.masked for s in shapes)
            )
            return ("param", params[0][1], masked)
        return join(shapes, masked_any=masked_any)

    def _eval_name(self, ctx, fn, name, facet, depth, symbolic):
        assigns = ctx.assignments(fn, name)
        unpacks = ctx.unpacks(fn, name)
        if fn is not None and name in ctx.param_names(fn):
            if not assigns and not unpacks:
                if symbolic:
                    return ("param", name, False)
                return self.params.get((fn, name, facet), UNKNOWN_SHAPE)
        vals = [
            self._eval(ctx, fn, v, facet, depth + 1, symbolic)
            for v in assigns
        ]
        for value, i in unpacks:
            vals.append(self._eval(ctx, fn, value, facet, depth + 1, symbolic, pos=i))
        if not vals:
            return UNKNOWN_SHAPE
        return self._combine(vals)

    def _eval_subscript(self, ctx, fn, expr, facet, depth, symbolic):
        base = expr.value
        # x.shape[0] / x.shape[axis]: the array facet of x, as a size
        if isinstance(base, ast.Attribute) and base.attr == "shape":
            return self._eval(ctx, fn, base.value, ARRAY, depth + 1, symbolic)
        index = expr.slice
        if isinstance(index, ast.Tuple) and index.elts:
            index = index.elts[0]  # the leading axis decides the extent
        if isinstance(index, ast.Slice):
            if index.upper is not None and index.lower is None and index.step is None:
                # x[:n]: n lanes
                up = self._eval(ctx, fn, index.upper, SIZE, depth + 1, symbolic)
                if isinstance(up, ShapeVal) and up.kind == STATIC_KIND:
                    if isinstance(index.upper, ast.UnaryOp):
                        # x[:-1]: one lane off the base, the base's class
                        return self._eval(ctx, fn, base, facet, depth + 1, symbolic)
                return up
            # x[a:], x[a:b]: approximately the base's class
            return self._eval(ctx, fn, base, facet, depth + 1, symbolic)
        if isinstance(index, ast.Constant) or (
            isinstance(index, ast.UnaryOp) and isinstance(index.operand, ast.Constant)
        ):
            if facet == SIZE:
                return self._eval(ctx, fn, base, facet, depth + 1, symbolic)
            if isinstance(index, ast.Constant) and isinstance(index.value, int):
                # an element of a tuple value: torch.nonzero(m,
                # as_tuple=True)[0], torch.sort(x)[1], helper(x)[0]
                if _tuple_op(base):
                    return self._eval(ctx, fn, base, ARRAY, depth + 1, symbolic)
                if isinstance(base, ast.Call) and self._tuple_call(ctx, base):
                    return self._eval(ctx, fn, base, ARRAY, depth + 1, symbolic,
                                      pos=index.value)
                if isinstance(base, ast.Name):
                    v = self._eval(ctx, fn, base, ARRAY, depth + 1, symbolic)
                    if isinstance(v, ShapeVal) and v.parts is not None:
                        return pick(v, index.value)
            return STATIC()  # one row: no leading extent of its own
        if facet == ARRAY:
            if _is_mask_expr(ctx, fn, index):
                return DATA(f"boolean index@{ctx.relpath}:{expr.lineno}")
            # x[idx]: a gather at the index's extent; pad lanes gather
            # duplicate payload
            v = self._eval(ctx, fn, index, ARRAY, depth + 1, symbolic)
            return self._unmask(v)
        return self._eval(ctx, fn, base, facet, depth + 1, symbolic)

    def _params_of(self, tgt) -> List[str]:
        names = self._params.get(tgt.node)
        if names is None:
            names = self._params[tgt.node] = target_params(tgt)
        return names

    def _call_info(self, call):
        """(dotted name, leaf, method form?, function form?) of a call,
        computed once per call node."""
        got = self._calls.get(call)
        if got is None:
            name = dotted_name(call.func)
            fn_form = name.startswith(_DEVICE_PREFIXES)
            got = self._calls[call] = (
                name, call_leaf(call),
                isinstance(call.func, ast.Attribute) and not fn_form, fn_form,
            )
        return got

    def _eval_call(self, ctx, fn, call, facet, depth, symbolic, pos=None):
        name, leaf, method, fn_form = self._call_info(call)
        line = getattr(call, "lineno", 0)

        # -- rounders: the lattice entry points -----------------------------
        if leaf in _ROUNDER_LATTICE:
            return BUCKETED(
                _ROUNDER_LATTICE[leaf], origin=f"{leaf}@{ctx.relpath}:{line}"
            )
        if leaf in _IDENTITY_SIZE and call.args:
            return self._eval(ctx, fn, call.args[0], SIZE, depth + 1, symbolic)

        # -- host syncs / casts preserve the size class ---------------------
        if name in ("int", "float", "bool") and len(call.args) == 1:
            if facet == SIZE:
                return self._eval(ctx, fn, call.args[0], SIZE, depth + 1, symbolic)
            return STATIC()  # a synced scalar has no leading dim
        if name == "len" and len(call.args) == 1:
            return self._eval(ctx, fn, call.args[0], ARRAY, depth + 1, symbolic)
        if name in ("min", "max", "abs") and call.args:
            vs = [
                self._eval(ctx, fn, a, facet, depth + 1, symbolic)
                for a in call.args
            ]
            return self._combine(vs)

        # -- .item(), .tolist(), sizes and reductions -----------------------
        if method and leaf in ("item", "tolist") and not call.args:
            if facet == SIZE:
                return self._eval(ctx, fn, call.func.value, SIZE, depth + 1, symbolic)
            return STATIC() if leaf == "item" else self._eval(
                ctx, fn, call.func.value, ARRAY, depth + 1, symbolic
            )
        if method and leaf in ("numel", "size", "nelement") and len(call.args) <= 1:
            return self._eval(ctx, fn, call.func.value, ARRAY, depth + 1, symbolic)
        if leaf in _REDUCERS and (fn_form or method):
            if leaf in ("max", "min") and self._elementwise_minmax(call, method):
                return self._combine([
                    self._eval(ctx, fn, a, ARRAY, depth + 1, symbolic)
                    for a in self._operands(call, method)[:2]
                ])
            if facet == SIZE:
                return DATA(f"{name or leaf}@{ctx.relpath}:{line}")
            return STATIC()  # reduced away: scalar (or trailing-axes) result

        # -- the tensor-op transfer catalog ---------------------------------
        if fn_form or method:
            v = self._transfer(ctx, fn, call, leaf, method, facet, depth, symbolic)
            if v is not None:
                return v

        # -- project calls: consume the fixpoint summaries ------------------
        if name in _LAUNCH_NAMES or name.endswith(".dispatch.launch"):
            return UNKNOWN_SHAPE  # the tier decides; the gate's caller sizes it
        targets = self.graph.resolve_call(ctx, call)
        scope_targets = [t for t in targets if t.node in self._scope_nodes]
        if scope_targets:
            # the *_counted discipline: a function with a ``size``
            # parameter writes that many lanes
            sized = self._sized_param(call, scope_targets)
            if sized is not None:
                v = self._eval(ctx, fn, sized, SIZE, depth + 1, symbolic)
                live = _LIVE_OUTPUT.get(leaf)
                if live is None or not isinstance(v, ShapeVal) or v.kind == UNKNOWN_KIND:
                    return v
                lanes = [replace(v, masked=False, parts=None)] * live
                return pick(tuple_val(lanes + [replace(v, masked=True, parts=None)]), pos)
            vs = []
            for tgt in scope_targets:
                summary = self.returns.get((tgt.node, facet), UNKNOWN_SHAPE)
                if isinstance(summary, tuple) and summary[0] == "tuple":
                    parts = summary[1]
                    if pos is not None and pos < len(parts):
                        parts = (parts[pos],)
                    got = [
                        self._resolve_summary(
                            ctx, fn, call, tgt, part, facet, depth, symbolic
                        )
                        for part in parts
                    ]
                    if len(got) > 1 and all(isinstance(g, ShapeVal) for g in got):
                        vs.append(tuple_val(got))
                    else:
                        vs.extend(got)
                else:
                    vs.append(self._resolve_summary(
                        ctx, fn, call, tgt, summary, facet, depth, symbolic
                    ))
            return self._combine(vs)
        return UNKNOWN_SHAPE

    def _resolve_summary(self, ctx, fn, call, tgt, summary, facet, depth, symbolic):
        if isinstance(summary, tuple):
            return self._passthrough_at_site(
                ctx, fn, call, tgt, summary, facet, depth, symbolic
            )
        return summary

    def _tuple_call(self, ctx, call) -> bool:
        """A project call whose return summary keeps tuple positions."""
        for tgt in self.graph.resolve_call(ctx, call):
            summary = self.returns.get((tgt.node, ARRAY))
            if isinstance(summary, tuple) and summary[0] == "tuple":
                return True
        return False

    def _sized_param(self, call, targets) -> Optional[ast.AST]:
        kw = next((k for k in call.keywords if k.arg == "size"), None)
        if kw is not None:
            return kw.value
        for tgt in targets:
            for pname, arg in _bound_args(call, self._params_of(tgt)):
                if pname == "size":
                    return arg
        return None

    @staticmethod
    def _operands(call: ast.Call, method: bool) -> List[ast.AST]:
        """The tensor operands in order: the receiver first for a method."""
        return ([call.func.value] if method else []) + list(call.args)

    @staticmethod
    def _elementwise_minmax(call: ast.Call, method: bool) -> bool:
        """``torch.max(a, b)`` / ``a.max(b)`` (elementwise) rather than a
        reduction over a dim: a second tensor operand that is no literal."""
        ops = ShapeAnalysis._operands(call, method)
        return len(ops) >= 2 and not isinstance(ops[1], (ast.Constant, ast.UnaryOp))

    def _transfer(self, ctx, fn, call, leaf, method, facet, depth, symbolic):
        """The torch transfer functions, function form and method form.
        Returns None for ops the catalog does not model (the caller falls
        through to project resolution, then UNKNOWN)."""
        ops = self._operands(call, method)
        size_kw = size_kwarg(call)
        line = getattr(call, "lineno", 0)

        def arr(e):
            return self._eval(ctx, fn, e, ARRAY, depth + 1, symbolic)

        def size(e):
            return self._eval(ctx, fn, e, SIZE, depth + 1, symbolic)

        if size_kw is not None and leaf not in _ALLOC and leaf not in _NEW_ALLOC:
            # J.mask_nonzero(size=), repeat_interleave(output_size=),
            # bincount(minlength=): the kwarg IS the leading extent
            return size(size_kw.value)
        if leaf in _UNSIZED or leaf == "bincount":
            return DATA(f"{leaf} (unsized)@{ctx.relpath}:{line}")
        if leaf == "repeat_interleave":
            if len(ops) >= 2 and isinstance(ops[1], ast.Constant):
                return arr(ops[0])  # a literal repeat scales the extent
            return DATA(f"repeat_interleave (unsized)@{ctx.relpath}:{line}")
        if leaf == "where" and not method:
            if len(ops) == 1:
                return DATA(f"torch.where (1-arg)@{ctx.relpath}:{line}")
            if len(ops) == 3:
                out = self._combine([arr(a) for a in ops[1:3]])
                if isinstance(out, ShapeVal):
                    return replace(out, masked=True, parts=None)
                return ("param", out[1], True)
            return UNKNOWN_SHAPE
        if leaf in ("masked_fill", "where") and method:
            out = arr(ops[0])
            if isinstance(out, ShapeVal):
                return replace(out, masked=True, parts=None)
            return ("param", out[1], True)
        if leaf in ("arange", "_arange"):
            if not call.args:
                return UNKNOWN_SHAPE
            end = call.args[1] if leaf == "arange" and len(call.args) >= 2 else call.args[0]
            v = size(end)
            if isinstance(v, ShapeVal):
                return replace(v, iota=True)
            return v
        if leaf in _LIVE_MASKS:
            if not call.args:
                return UNKNOWN_SHAPE
            v = size(call.args[0]) if leaf == "_live_lanes" else arr(call.args[0])
            if isinstance(v, ShapeVal):
                return replace(v, masked=True, iota=False, parts=None)
            return ("param", v[1], True)
        if (leaf in _ALLOC and not method) or leaf in _NEW_ALLOC:
            shape_arg = _alloc_shape_arg(call)
            if shape_arg is None:
                kw = next((k for k in call.keywords if k.arg == "size"), None)
                shape_arg = kw.value if kw is not None else None
                if isinstance(shape_arg, (ast.Tuple, ast.List)) and shape_arg.elts:
                    shape_arg = shape_arg.elts[0]
            return size(shape_arg) if shape_arg is not None else UNKNOWN_SHAPE
        if leaf in _ALLOC_LIKE:
            return self._unmask(arr(ops[0])) if ops else UNKNOWN_SHAPE
        if leaf in ("tensor", "as_tensor") and not method and call.args:
            a = call.args[0]
            if isinstance(a, (ast.List, ast.Tuple)):
                return STATIC(len(a.elts))
            return arr(a)
        if leaf in ("randperm",) and call.args:
            return size(call.args[0])
        if leaf in ("cat", "concat", "concatenate", "hstack", "vstack", "stack",
                    "concat_pair"):
            if method:
                return None
            parts = call.args[0].elts if (
                call.args and isinstance(call.args[0], (ast.Tuple, ast.List))
            ) else call.args
            out = self._combine([arr(p) for p in parts])
            if isinstance(out, ShapeVal) and out.kind == BUCKETED_KIND:
                # a concat of bucketed extents leaves the source lattice
                return replace(out, lattice="derived")
            return out
        if leaf == "pad" and not method:
            v = arr(ops[0]) if ops else UNKNOWN_SHAPE
            if isinstance(v, ShapeVal):
                # fresh pad lanes are live garbage until masked
                return replace(v, masked=False,
                               lattice="derived" if v.kind == BUCKETED_KIND
                               else v.lattice)
            return v
        if leaf in _SORTS:
            return self._combine([arr(o) for o in ops[:1]]) if ops else UNKNOWN_SHAPE
        if leaf == "searchsorted":
            return arr(ops[1]) if len(ops) >= 2 else UNKNOWN_SHAPE
        if leaf in ("cumsum", "cummax", "cummin", "cumprod"):
            return self._unmask(arr(ops[0])) if ops else UNKNOWN_SHAPE
        if leaf in _GATHERS:
            idx = None
            if leaf in ("take",) and len(ops) >= 2:
                idx = ops[1]
            elif len(ops) >= 3:
                idx = ops[2]  # index_select(x, dim, idx) / gather(x, dim, idx)
            idx = next((kw.value for kw in call.keywords if kw.arg == "index"), idx)
            return self._unmask(arr(idx)) if idx is not None else UNKNOWN_SHAPE
        if leaf == "topk" and len(ops) >= 2:
            return size(ops[1])
        if leaf == "narrow" and len(ops) >= 4:
            return size(ops[3])
        if leaf in ("mm", "matmul", "bmm"):
            return self._unmask(arr(ops[0])) if ops else UNKNOWN_SHAPE
        if leaf in _PRESERVING or leaf in _ELEMENTWISE:
            return arr(ops[0]) if ops else UNKNOWN_SHAPE
        return None

    def _passthrough_at_site(
        self, ctx, fn, call, tgt, summary, facet, depth, symbolic
    ):
        _tag, param_names, masked_through = summary
        vals = [
            self._eval(ctx, fn, arg, facet, depth + 1, symbolic)
            for pname, arg in _bound_args(call, self._params_of(tgt))
            if pname in param_names
        ]
        out = self._combine(vals) if vals else UNKNOWN_SHAPE
        if masked_through and isinstance(out, ShapeVal):
            out = replace(out, masked=True)
        return out


# ---------------------------------------------------------------------------
# the process-wide summary cache
# ---------------------------------------------------------------------------

# [(contexts tuple, ShapeAnalysis)] — identity-keyed: the runner's parse
# cache hands back the SAME FileContext objects for unchanged files, so
# repeated engine runs in one process solve the fixpoint once. Strong
# refs, tiny LRU.
_SUMMARY_CACHE: List[Tuple[Tuple[FileContext, ...], ShapeAnalysis]] = []
_SUMMARY_CACHE_MAX = 4


def analysis_for(project) -> Tuple[ShapeAnalysis, bool]:
    """The ShapeAnalysis for a ProjectContext, cached by the identity of
    the analyzed file set. Returns ``(analysis, cache_hit)`` so the runner
    can report per-run cache traffic."""
    key = tuple(project.contexts)
    for i, (ctxs, ana) in enumerate(_SUMMARY_CACHE):
        if len(ctxs) == len(key) and all(a is b for a, b in zip(ctxs, key)):
            if i != 0:
                _SUMMARY_CACHE.insert(0, _SUMMARY_CACHE.pop(i))
            return ana, True
    ana = ShapeAnalysis(project)
    _SUMMARY_CACHE.insert(0, (key, ana))
    del _SUMMARY_CACHE[_SUMMARY_CACHE_MAX:]
    return ana, False


# ---------------------------------------------------------------------------
# facts export
# ---------------------------------------------------------------------------


def _bucket_bound(v: ShapeVal) -> Optional[int]:
    if v.kind == STATIC_KIND:
        return 1
    if v.kind == BUCKETED_KIND:
        return BUCKET_BOUNDS.get(v.lattice or "derived", BUCKET_BOUNDS["derived"])
    return None  # data-dependent: unbounded; unknown: no claim


def _arg_fact(name: str, v: ShapeVal) -> Dict[str, object]:
    return {"name": name, "shape": v.render(), "bucket_bound": _bucket_bound(v)}


def site_args(project, ctx: FileContext, call: ast.Call) -> List[Dict[str, object]]:
    """The classified arguments that make ``call`` a facts site, or []:

    * ``size=``/``output_size=``/``minlength=`` — a sized materialize;
    * ``rounded`` — a call of a lattice rounder (the site where a count
      becomes a padded extent);
    * ``result`` — a project helper call whose result is lattice-padded
      lanes (``_mask_to_idx_bucketed``);
    * each extent parameter bound at a kernel gate call (its ``size``,
      its ``k``): one launch shape per distinct value.
    """
    shapes = project.shapes
    fn = ctx.enclosing_function(call)
    args: List[Dict[str, object]] = []
    seen: Set[str] = set()
    kw = size_kwarg(call)
    if kw is not None:
        args.append(_arg_fact(kw.arg, shapes.classify_size(ctx, fn, kw.value)))
        seen.add(kw.arg)
    leaf = call_leaf(call)
    if leaf in _ROUNDER_LATTICE:
        args.append(_arg_fact("rounded", shapes.classify_size(ctx, fn, call)))
        return args
    targets = project.callgraph.resolve_call(ctx, call)
    for tgt in targets:
        extents = shapes.boundary.gate_extents(tgt)
        for pname, arg in _bound_args(call, target_params(tgt)):
            if pname in extents and pname not in seen:
                args.append(_arg_fact(pname, shapes.classify_size(ctx, fn, arg)))
                seen.add(pname)
    if not args and targets and not is_function_form(call):
        v = shapes.classify_array(ctx, fn, call)
        if v.kind == BUCKETED_KIND:
            args.append(_arg_fact("result", v))
    return args


def collect_facts(project) -> Dict[str, object]:
    """Everything the interpreter statically knows, as one JSON-stable
    artifact: the lattice definition, the per-operator padded-shape
    catalog, and every classified site (see ``site_args``) with its
    abstract class and bucket-signature bound."""
    sites: List[Dict[str, object]] = []
    for ctx in project.contexts:
        if not in_scope(ctx.relpath):
            continue
        for call in ctx.calls:
            args = site_args(project, ctx, call)
            if not args:
                continue
            bounds = [a["bucket_bound"] for a in args]
            verdict = (
                "unbounded"
                if any(str(a["shape"]).startswith("data") for a in args)
                else ("bounded" if all(b is not None for b in bounds) else "unknown")
            )
            sites.append(
                {
                    "path": ctx.relpath,
                    "line": getattr(call, "lineno", 0),
                    "op": dotted_name(call.func) or call_leaf(call) or "<call>",
                    "args": args,
                    "verdict": verdict,
                }
            )
    sites.sort(key=lambda s: (s["path"], s["line"], s["op"]))
    data_sites = sum(1 for s in sites if s["verdict"] == "unbounded")
    bucketed_sites = sum(
        1
        for s in sites
        if any(str(a["shape"]).startswith("bucketed") for a in s["args"])
    )
    return {
        "schema_version": FACTS_SCHEMA_VERSION,
        "lattice": {
            "floor": BUCKET_FLOOR,
            "modes": {
                "off": "n (identity)",
                "pow2": "1 << ceil(log2(max(n, floor))) for n > 0; 0 stays 0",
                "1.25": "first rung >= n of [floor, max(prev+1, "
                        "int(prev*1.25)), ...]; 0 stays 0",
            },
            "bounds": dict(BUCKET_BOUNDS),
        },
        "operators": [dict(f) for f in OPERATOR_FORMULAS],
        "sites": sites,
        "summary": {
            "facts_emitted": len(OPERATOR_FORMULAS) + len(sites),
            "data_dependent_sites": data_sites,
            "bucketed_sites": bucketed_sites,
        },
    }


def engine_shape_summary() -> Dict[str, object]:
    """A ``shape_facts`` payload: the facts summary over the port. Never
    raises — a crash reports itself in the payload."""
    try:
        from .runner import ENGINE_ROOT, run_paths

        report = run_paths([ENGINE_ROOT], rules=[])
        facts = collect_facts(report.project)
        return dict(facts["summary"])
    except Exception as exc:  # fault-ok: a facts crash must not fail the caller's result line
        return {
            "facts_emitted": 0,
            "data_dependent_sites": -1,
            "bucketed_sites": -1,
            "error": str(exc)[:200],
        }
