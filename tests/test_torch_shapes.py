"""The port's shape pack (``tpu_cypher_torch/analysis/shapes.py`` and its
five rules) against the reference's (``tpu_cypher/analysis``), on the CPU.

(i) One lattice predictor: ``shapes.predict_padded`` equals the
reference's, ``bucketing.predict_padded``, ``bucketing.round_size`` and
the optimizer's ``padded_rows`` in every mode, and the lattice constants
equal the reference's. (ii) The facts over the port: schema, operator
catalog, site list, the lattice's rounding sites classified BUCKETED, and
every data-dependent site a declared exact-size site. (iii) The rules on
``tests/torch_lint_fixtures``, which mirror the reference's cases one for
one in torch idiom: findings pinned exactly (rule, line, message), as
many per file as the reference's rules give on its own fixtures, clean
cases silent. (iv) The interpreter on the torch idiom itself (methods,
subscript gathers, tuple positions), so that a retarget that leaves the
port UNKNOWN shows here. (v) The lattice at run time: under ``pow2`` and
``1.25`` every (true, padded) pair the trace spans stamp equals the
prediction, and every answer equals the ``off`` run's and the
reference's. The whole-port analysis runs once per module.
"""

import os
from collections import Counter

import pytest

from tpu_cypher.analysis import runner as ref_runner
from tpu_cypher.analysis import shapes as ref_shapes
from tpu_cypher_torch.analysis import runner, shapes
from tpu_cypher_torch.backend.cuda import bucketing
from tpu_cypher_torch.utils import config as PCFG

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_lint_fixtures")
REF_FIXTURES = os.path.join(HERE, "lint_fixtures")

MODES = ("off", "pow2", "1.25")
NS = (0, 1, 31, 32, 33, 63, 64, 100, 1000, 12345, 19_853_591, 197_148_177, 2**40)


@pytest.fixture(scope="module")
def engine():
    """One whole-port run with every rule and the committed baseline."""
    return runner.check_engine()


@pytest.fixture(scope="module")
def facts(engine):
    return shapes.collect_facts(engine.project)


@pytest.fixture
def lattice():
    """Set ``TPU_CYPHER_BUCKET`` in the process; always reset."""
    yield PCFG.BUCKET_MODE.set
    PCFG.BUCKET_MODE.reset()


# ---------------------------------------------------------------------------
# (i) one lattice predictor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_predict_padded_is_one_predictor(mode, lattice):
    from tpu_cypher_torch.optimizer.cost import padded_rows

    lattice(mode)
    for n in NS + tuple(range(0, 300)):
        want = ref_shapes.predict_padded(n, mode)
        assert shapes.predict_padded(n, mode) == want, (mode, n)
        assert bucketing.predict_padded(n, mode) == want, (mode, n)
        assert bucketing.round_size(n) == want, (mode, n)
        assert padded_rows(n) == want, (mode, n)


def test_predict_padded_is_monotone_and_covering():
    for mode in ("pow2", "1.25"):
        prev = 0
        for n in range(0, 300):
            p = shapes.predict_padded(n, mode)
            assert p >= n and p >= prev, (mode, n)
            prev = p
        assert shapes.predict_padded(197_148_177, mode) <= (
            2 if mode == "pow2" else 1.25
        ) * 197_148_177


def test_lattice_constants_equal_the_references():
    assert shapes.BUCKET_FLOOR == bucketing._BUCKET_FLOOR == ref_shapes.BUCKET_FLOOR
    assert shapes.BUCKET_BOUNDS == ref_shapes.BUCKET_BOUNDS
    assert (shapes.BUCKET_BOUNDS["pow2"], shapes.BUCKET_BOUNDS["1.25"]) == (36, 112)
    assert shapes.FACTS_SCHEMA_VERSION == ref_shapes.FACTS_SCHEMA_VERSION == 1
    assert shapes.predict_padded(197_148_177, "pow2") == 268_435_456
    assert shapes.predict_padded(19_853_591, "pow2") == 33_554_432


# ---------------------------------------------------------------------------
# (ii) the facts over the port
# ---------------------------------------------------------------------------


def test_facts_lattice_block_equals_the_references(facts, tmp_path):
    (tmp_path / "one.py").write_text("def f(x):\n    return x\n")
    ref = ref_runner.run_paths([str(tmp_path)], rules=[])
    assert facts["lattice"] == ref_shapes.collect_facts(ref.project)["lattice"]


def test_facts_schema_and_operators(facts):
    assert set(facts) == {"schema_version", "lattice", "operators", "sites", "summary"}
    assert facts["schema_version"] == 1
    assert facts["lattice"]["floor"] == 32
    assert set(facts["lattice"]["modes"]) == {"off", "pow2", "1.25"}
    ops = {o["op"]: o for o in facts["operators"]}
    assert len(ops) == len(facts["operators"]) >= 20
    for o in ops.values():
        assert o["padded_shape"] and o["class"], o
    assert "size" in ops["J.mask_nonzero"]["padded_shape"]
    assert "output_size" in ops["torch.repeat_interleave|x.repeat_interleave"]["padded_shape"]
    assert "minlength" in ops["torch.bincount|x.bincount"]["padded_shape"]
    assert ops["factorized.decode_lanes"]["class"] == "run_decode"
    assert ops["hopper.expand_materialize_counted"]["class"] == "gate"


def test_facts_sites_and_summary(engine, facts):
    sites = facts["sites"]
    for s in sites:
        assert set(s) == {"path", "line", "op", "args", "verdict"}
        assert s["verdict"] in ("bounded", "unbounded", "unknown")
        assert not os.path.isabs(s["path"]) and shapes.in_scope(s["path"])
        for a in s["args"]:
            assert set(a) == {"name", "shape", "bucket_bound"}
    summary = facts["summary"]
    assert summary["facts_emitted"] == len(sites) + len(facts["operators"])
    assert summary["data_dependent_sites"] == sum(s["verdict"] == "unbounded" for s in sites)
    assert summary["bucketed_sites"] >= 20
    # the retarget classifies most sites: UNKNOWN never fires, so a port
    # left UNKNOWN would lint clean without checking anything
    verdicts = Counter(s["verdict"] for s in sites)
    assert verdicts["bounded"] + verdicts["unbounded"] > 2 * verdicts["unknown"], verdicts
    # every unbounded site is a DECLARED exact-size site: its call line
    # carries an allow[pad-invariant] with a reason
    declared = {
        (e["path"], e["line"] + 1)
        for e in engine.suppression_entries
        if "pad-invariant" in e["rules"]
    }
    unbounded = [(s["path"], s["line"]) for s in sites if s["verdict"] == "unbounded"]
    assert unbounded and set(unbounded) <= declared, set(unbounded) - declared


# (file, enclosing function's qualname, op leaf) of each site where the
# lattice rounds
ROUNDING_SITES = [
    ("expand_op.py", "_fused_chain_walk", "round_size"),
    ("expand_op.py", "_FusedExpandBase._apply_enforced_pairs", "_mask_to_idx_bucketed"),
    ("expand_op.py", "CsrExpandOp._expand_half", "round_size"),
    ("expand_op.py", "CsrExpandOp._expand_half", "_mask_to_idx_bucketed"),
    ("expand_op.py", "CsrExpandOp._fused_table", "mask_nonzero"),
    ("expand_op.py", "CsrExpandOp._fused_table", "round_size"),
    ("expand_op.py", "CsrExpandOp._fused_table", "_mask_to_idx_bucketed"),
    ("expand_op.py", "CsrVarExpandOp._fused_table", "round_size"),
    ("column.py", "mask_to_idx_bucketed", "mask_nonzero"),
]


def _sites_by_function(engine, facts):
    graph = engine.project.callgraph
    out = {}
    for s in facts["sites"]:
        ctx = engine.project.by_relpath[s["path"]]
        call = next(
            c for c in ctx.calls
            if c.lineno == s["line"]
            and (shapes.dotted_name(c.func) or shapes.call_leaf(c)) == s["op"]
        )
        fn = ctx.enclosing_function(call)
        key = (os.path.basename(s["path"]), graph.info_for(fn).qualname,
               s["op"].split(".")[-1])
        out.setdefault(key, []).append(s)
    return out


@pytest.mark.parametrize("where", ROUNDING_SITES, ids=lambda w: ":".join(w))
def test_rounding_sites_are_bucketed(engine, facts, where):
    got = _sites_by_function(engine, facts).get(where)
    assert got, f"no facts site {where}"
    for s in got:
        assert all(a["shape"].startswith("bucketed") for a in s["args"]), (where, s)


def test_engine_shape_summary_never_raises():
    s = shapes.engine_shape_summary()
    assert set(s) == {"facts_emitted", "data_dependent_sites", "bucketed_sites"}, s
    assert s["facts_emitted"] > 0 and s["bucketed_sites"] > 0


def test_engine_shape_summary_reports_a_crash(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("analyzer down")

    monkeypatch.setattr(runner, "run_paths", boom)
    s = shapes.engine_shape_summary()
    assert s["facts_emitted"] == 0 and s["bucketed_sites"] == -1
    assert "analyzer down" in s["error"]


# ---------------------------------------------------------------------------
# (iii) the rules on the torch fixtures, pinned
# ---------------------------------------------------------------------------

_SIZE_MSG = (
    "{op}({kw}=..) with a size that neither routes through "
    "bucketing.round_size/round_up_* nor is a parameter of the enclosing "
    "primitive — every data-dependent materialize size must round the bucket "
    "lattice or declare itself exact"
)
_UNSIZED = (
    "unsized torch.nonzero — value-dependent output shape; use the sized form "
    "with a bucketed size (jit_ops.mask_nonzero / column.mask_to_idx_bucketed)"
)
_DATA_KW = (
    "J.mask_nonzero(size=...) receives a data-dependent count (data-dependent: "
    "{origin}): one launch shape per distinct value. Round it via "
    "bucketing.round_size first."
)
_REDUCE = (
    "{op} reduces a bucket-padded tensor (bucketed(mode)) with no mask against "
    "its true count: pad lanes pollute the result. Mask via torch.where(live, "
    "x, neutral) or pass mask=."
)
_SORT = (
    "{op} sorts a bucket-padded tensor (bucketed(mode)) whose pad lanes are not "
    "forced last: garbage keys interleave with live rows. Apply the ID_SENTINEL "
    "discipline (torch.where(live, keys, sentinel)) first."
)
_SEARCH = (
    "torch.searchsorted searches a bucket-padded table (bucketed(mode)) whose pad "
    "lanes were never masked to the sentinel: padded keys shift every rank. Mask "
    "pads to ID_SENTINEL before building the sorted table."
)
_EXTENT = (
    "extent {p}= of kernel gate {gate}() is data-dependent (data-dependent: "
    "{origin}): unbounded launch shapes at this call site. Round via "
    "bucketing.round_size to bound them."
)
_MAT = "backend/cuda/mat.py"

EXPECTED = {
    ("shape_stability", "shape-stability"): [
        (_MAT, 17, _DATA_KW.format(origin=f"torch.sum@{_MAT}:14")),
        (_MAT, 22, "unsized torch.nonzero inside kernel impl _launch(): the launch "
                   "extent is data-dependent. Size it (bucketed) before the gate."),
        (_MAT, 32, "tensor with data-dependent leading dim (data-dependent: nonzero "
                   f"(unsized)@{_MAT}:30) passed to kernel gate _consume(): one launch "
                   "shape per distinct extent. Pad to the bucket lattice before the gate."),
        (_MAT, 38, "tensor with data-dependent leading dim (data-dependent: nonzero "
                   f"(unsized)@{_MAT}:36) crosses the dispatch.launch boundary: every "
                   "distinct extent is a fresh launch shape. Pad to the bucket lattice "
                   "first."),
    ],
    ("pad_mask", "pad-mask-discipline"): [
        (_MAT, 12, _REDUCE.format(op="vals.sum")),
        (_MAT, 19, _SORT.format(op="torch.sort")),
        (_MAT, 26, _SEARCH),
    ],
    ("bucket_cardinality", "bucket-cardinality"): [
        (_MAT, 26, _EXTENT.format(p="size", gate="sized_gather", origin=f"torch.sum@{_MAT}:24")),
        (_MAT, 32, _EXTENT.format(p="total", gate="sized_repeat",
                                  origin=f"counts.sum@{_MAT}:30")),
    ],
    ("pad_invariant", "pad-invariant"): [
        ("backend/cuda/delta_overlay.py", 25, _SIZE_MSG.format(op="J.mask_nonzero", kw="size")),
        ("backend/cuda/delta_overlay.py", 31,
         _SIZE_MSG.format(op="torch.repeat_interleave", kw="output_size")),
        (_MAT, 10, _UNSIZED),
        (_MAT, 17, _SIZE_MSG.format(op="J.mask_nonzero", kw="size")),
        (_MAT, 23, _SIZE_MSG.format(op="expand_materialize_counted", kw="size")),
        (_MAT, 28, _SIZE_MSG.format(op="torch.repeat_interleave", kw="output_size")),
    ],
    ("recompile", "recompile-hazard"): [
        ("backend/cuda/jitty.py", 17, "torch.compile made inside fresh_compile_per_call() — "
         "a fresh build, load or wrapper per call; hoist to module scope or memoize in a "
         "module-level cache"),
        ("backend/cuda/jitty.py", 22, "os.environ read inside kernel impl _launch_env() — "
         "the value keys the launch below the gate; read it in the caller and pass it in"),
        ("backend/cuda/jitty.py", 29, "config option BUCKET_MODE.get() inside kernel impl "
         "_launch_flag() — the flag keys the launch below the gate; resolve it at the "
         "call site"),
        ("backend/cuda/jitty.py", 35, "argument 'sizes' of memoized unhashable_memo_default() "
         "has an unhashable default — the cache hashes its arguments; use a tuple or None"),
    ],
    # the per-shard closures of a sharded tier are judged like any body
    ("shard_map", "pad-mask-discipline"): [
        ("parallel/mat.py", 20, _REDUCE.format(op="torch.sum")),
        ("parallel/mat.py", 32, _SORT.format(op="keys.sort")),
    ],
    ("shard_map", "shape-stability"): [
        ("parallel/mat.py", 42, _DATA_KW.format(origin="mask.sum@parallel/mat.py:39")),
    ],
    # the factorized run layout: run-count prefixes, sentinel-masked
    # cumsums and the decode extent classify like any bucketed materialize
    ("factorized", "shape-stability"): [
        (_MAT, 12, _DATA_KW.format(origin=f"torch.sum@{_MAT}:11")),
    ],
    ("factorized", "pad-mask-discipline"): [
        (_MAT, 22, _SEARCH),
        (_MAT, 29, _REDUCE.format(op="cnts.sum")),
    ],
}


def _pinned(report, root):
    prefix = os.path.relpath(root).replace(os.sep, "/") + "/"
    return sorted(
        (os.path.relpath(f.path, os.path.relpath(root)).replace(os.sep, "/"), f.line,
         f.message.replace(prefix, ""))
        for f in report.blocking
    )


@pytest.mark.parametrize("fixture,rule_id", sorted(EXPECTED), ids=lambda v: str(v))
def test_shape_rule_findings_pinned_exactly(fixture, rule_id):
    root = os.path.join(FIXTURES, fixture, "bad")
    report = runner.run_paths([root], rules=[rule_id])
    assert all(f.rule == rule_id for f in report.blocking)
    assert _pinned(report, root) == sorted(EXPECTED[(fixture, rule_id)]), report.render_text()
    clean = runner.run_paths([os.path.join(FIXTURES, fixture, "clean")], rules=[rule_id])
    assert clean.clean and clean.files_checked >= 1, clean.render_text()


@pytest.mark.parametrize("fixture,rule_id", sorted(EXPECTED), ids=lambda v: str(v))
def test_fixture_counts_equal_the_references(fixture, rule_id):
    """The torch cases fire as many findings per file as the reference's
    rules fire on the reference's own cases."""
    def per_file(report):
        return Counter(os.path.basename(f.path) for f in report.blocking)

    for which in ("bad", "clean"):
        ref = ref_runner.run_paths([os.path.join(REF_FIXTURES, fixture, which)], rules=[rule_id])
        port = runner.run_paths([os.path.join(FIXTURES, fixture, which)], rules=[rule_id])
        assert per_file(port) == per_file(ref), (which, port.render_text(), ref.render_text())


_LOADERS = '''\
import ctypes
import functools

from backend.cuda.hopper import _build

_LIBS = {}
_lib = None


def load_per_call(path):
    return ctypes.CDLL(path)


def build_per_call():
    return _build.lib("expand_rows")


@functools.lru_cache(maxsize=None)
def memoized(path):
    return ctypes.CDLL(path)


def cached(path):
    got = _LIBS.get(path)
    if got is None:
        got = _LIBS[path] = ctypes.CDLL(path)
    return got


def global_slot(path):
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(path)
    return _lib
'''


def test_recompile_flags_a_kernel_load_per_call(tmp_path):
    """The port's own hazard beside the fixture's cases: a library load or
    a kernel build outside the memoized loaders."""
    (tmp_path / "loaders.py").write_text(_LOADERS)
    report = runner.run_paths([str(tmp_path)], rules=["recompile-hazard"])
    got = sorted((f.line, f.message.split(" — ")[0]) for f in report.blocking)
    assert got == [(11, "ctypes.CDLL made inside load_per_call()"),
                   (15, "_build.lib made inside build_per_call()")], report.render_text()


# ---------------------------------------------------------------------------
# (iv) the interpreter on the torch idiom
# ---------------------------------------------------------------------------

_IDIOM = '''\
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J
from backend.cuda.hopper import dispatch


def expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, *, size):
    # the expand_rows gate's shape: (row, nbr, orig, live) of size lanes
    return dispatch.launch(
        "expand_rows", lambda: None,
        lambda: J.expand_materialize_counted(rp, ci, eo, pos, deg, nvalid, size),
        device=pos.device,
    )


def pair(mask):
    n = int(mask.sum())
    return J.mask_nonzero(mask, size=bucketing.round_size(n)), n


def probe(rp, ci, eo, pos, deg, mask, x, count_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    row, nbr, orig, live = expand_materialize_counted(rp, ci, eo, pos, deg, n, size=size)
    idx, k = pair(mask)
    CUMSUM = nbr.cumsum(0)
    NEW = x.new_zeros(size)
    GATHER = x[idx]
    SELECT = x.index_select(0, idx)
    BOOL = x[mask & (x > 0)]
    FILLED = nbr.masked_fill(~live, 0)
    LIVE = live
    WHERE = torch.where(live, nbr, 0)
    IOTA = torch.arange(size, device=x.device) < n
    LANES = J._live_lanes(size, n, x)
    TUPLE0 = idx
    TUPLE1 = k
    NONZERO = torch.nonzero(mask, as_tuple=True)[0]
    ROW = x[0]
    SORTED = torch.sort(nbr).values
    REPEAT = torch.repeat_interleave(x, mask, output_size=size)
    UNIQUE = x.unique()
    return CUMSUM, NEW, GATHER, SELECT, BOOL, FILLED, LIVE, WHERE, IOTA, LANES, TUPLE0, \\
        TUPLE1, NONZERO, ROW, SORTED, REPEAT, UNIQUE
'''

IDIOM = {
    "CUMSUM": ("array", "bucketed(mode)"),
    "NEW": ("array", "bucketed(mode)"),
    "GATHER": ("array", "bucketed(mode)"),
    "SELECT": ("array", "bucketed(mode)"),
    "BOOL": ("array", "data-dependent"),
    "FILLED": ("array", "bucketed(mode, masked)"),
    "LIVE": ("array", "bucketed(mode, masked)"),
    "WHERE": ("array", "bucketed(mode, masked)"),
    "IOTA": ("array", "bucketed(mode, masked)"),
    "LANES": ("array", "bucketed(mode, masked)"),
    "TUPLE0": ("array", "bucketed(mode)"),
    "TUPLE1": ("size", "data-dependent"),
    "NONZERO": ("array", "data-dependent"),
    "ROW": ("array", "static"),
    "SORTED": ("array", "bucketed(mode)"),
    "REPEAT": ("array", "bucketed(mode)"),
    "UNIQUE": ("array", "data-dependent"),
}


@pytest.fixture(scope="module")
def idiom(tmp_path_factory):
    root = tmp_path_factory.mktemp("idiom")
    (root / "backend" / "cuda").mkdir(parents=True)
    (root / "backend" / "cuda" / "idiom.py").write_text(_IDIOM)
    report = runner.run_paths([str(root)], rules=[])
    [ctx] = report.project.contexts
    fn = next(f for f in ctx.functions if f.name == "probe")
    return report.project.shapes, ctx, fn


@pytest.mark.parametrize("name", sorted(IDIOM))
def test_interpreter_reads_the_torch_idiom(idiom, name):
    ana, ctx, fn = idiom
    facet, want = IDIOM[name]
    [expr] = ctx.assignments(fn, name)
    classify = ana.classify_size if facet == "size" else ana.classify_array
    assert classify(ctx, fn, expr).render().split(":")[0] == want


# ---------------------------------------------------------------------------
# (v) the lattice at run time
# ---------------------------------------------------------------------------


def _bag(rows):
    return Counter(repr(sorted(dict(r).items())) for r in rows)


def _pairs(result):
    return [
        (span.name, tuple(p))
        for span in result.profile().trace.spans()
        for p in span.attrs.get("rows_pairs", [])
    ]


def _phase11_queries():
    """chip_smoke.py phase 11's queries at a small size: Q1, Q5, Q11, the
    closing ExpandInto (counted and grouped), Q20 over a window and the
    loopy graph's uniqueness queries."""
    import chip_smoke as CS

    return [
        ("snb", CS.Q1, None), ("snb", CS.Q5, None), ("snb", CS.Q11, None),
        ("snb", CS.Q22, None), ("snb", CS.Q24, None),
        ("snb", CS.Q20, {"lo": 1, "hi": 141}), ("snb", CS.Q13, None),
        ("loopy", CS.Q4, None), ("loopy", CS.Q13, None),
        ("loopy", CS.LOOPY_FORBID, {"hi": 20}),
    ]


def _port_graphs():
    import chip_smoke as CS

    from tpu_cypher_torch import CypherSession, interop
    from tpu_cypher_torch.api.types import CTInteger
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    import test_bucketing as TB

    session = CypherSession.cuda(device="cpu")
    ids, src, dst = CS.loopy_arrays(100, 600)
    return {
        "corpus": session.create_graph_from_create_query(TB._create_query()),
        "snb": PropertyGraph(session, generate_snb(0.02, session, seed=7)),
        "loopy": interop.graph_from_arrays(session, ids, {}, {"id": CTInteger.nullable},
                                           src, dst),
    }


@pytest.fixture(scope="module")
def off_answers():
    import test_bucketing as TB

    PCFG.BUCKET_MODE.set("off")
    try:
        graphs = _port_graphs()
        queries = [("corpus", q, None) for q in TB.CORPUS] + _phase11_queries()
        return queries, [_bag(graphs[g].cypher(q, p).records.collect())
                         for g, q, p in queries]
    finally:
        PCFG.BUCKET_MODE.reset()


@pytest.mark.parametrize("mode", ["pow2", "1.25"])
def test_runtime_pairs_match_the_static_prediction(mode, lattice, off_answers):
    """Every (true, padded) pair on the spans equals ``predict_padded``,
    and every answer equals the ``off`` run's. The corpus alone gives
    the port fewer pairs than the reference (its filter, DISTINCT and
    UNWIND size exactly), so phase 11's queries run beside it."""
    queries, want = off_answers
    lattice(mode)
    graphs = _port_graphs()
    checked, corpus_pairs, padded, operators = 0, 0, 0, set()
    for (g, q, p), bag in zip(queries, want):
        result = graphs[g].cypher(q, p)
        assert _bag(result.records.collect()) == bag, (mode, q)
        for name, (true_rows, pad) in _pairs(result):
            assert shapes.predict_padded(true_rows, mode) == pad, (mode, name, q)
            operators.add(name)
            checked += 1
            corpus_pairs += g == "corpus"
            padded += pad > true_rows
    assert checked >= 20 and corpus_pairs > 0 and padded > 0, (checked, corpus_pairs, padded)
    assert {"CsrExpandOp", "CsrExpandIntoOp", "CsrVarExpandOp"} <= operators, operators


@pytest.mark.parametrize("mode", ["pow2", "1.25"])
def test_corpus_answers_equal_the_reference_under_the_lattice(mode, lattice):
    """The test_bucketing corpus under one lattice mode: the port's
    answers (lattice set by config) equal the reference's (its own
    ``force_mode``)."""
    import test_bucketing as TB

    from tpu_cypher import CypherSession as RefSession
    from tpu_cypher.backend.tpu import bucketing as ref_bucketing

    lattice(mode)
    port = _port_graphs()["corpus"]
    with ref_bucketing.force_mode(mode):
        ref = RefSession.tpu().create_graph_from_create_query(TB._create_query())
        for q in TB.CORPUS:
            want = _bag(ref.cypher(q).records.collect())
            assert _bag(port.cypher(q).records.collect()) == want, (mode, q)
