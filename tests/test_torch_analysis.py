"""The port's static analyzer (``tpu_cypher_torch/analysis``) against the
reference's (``tpu_cypher/analysis``), both run in-process on the CPU.

(i) The five rules the port copies give identical findings (rule, path,
line, column, message) on the reference's own fixture corpus
(``tests/lint_fixtures``), and the two analyzers treat suppressions and
the baseline alike on shared synthetic sources. (ii) The two retargeted
rules (``host-sync`` over the torch taint model, ``obs-emission`` over the
port's raw launches) fire on ``tests/torch_lint_fixtures/*/bad`` and stay
silent on ``*/clean``, which mirror the reference's cases one for one
(the shape pack's five rules are ``tests/test_torch_shapes.py``'s); so
does the port's own ``sync-span``, which has no counterpart there.
(iii) The port lints clean with all thirteen rules and an empty committed
baseline, and the kernels ``obs-emission`` collects equal
``dispatch.registry()``. (iv) The CLI's exit codes, in five subprocess
calls, ``--facts-out`` among them. (v) The fault sites the port's
first clean run added (``expr``, ``shuffle``) fire under the fault
matrix. The whole-port analysis runs once per module (a shared fixture);
nothing here is timed.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_cypher.analysis import baseline as ref_baseline
from tpu_cypher.analysis import runner as ref_runner
from tpu_cypher_torch.analysis import baseline, runner
from tpu_cypher_torch.analysis import synctrace as ST
from tpu_cypher_torch.analysis.core import FileContext
from tpu_cypher_torch.analysis.rules import ALL_RULES, RULES_BY_ID

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF_FIXTURES = os.path.join(HERE, "lint_fixtures")
FIXTURES = os.path.join(HERE, "torch_lint_fixtures")

# the rules the port copies, by the reference's fixture directory
SHARED = {
    "env-var-registry": "env_registry",
    "exception-hygiene": "exception_hygiene",
    "async-blocking": "async_blocking",
    "contextvar-discipline": "contextvar_discipline",
    "shared-state-race": "shared_state_race",
}
# the shape pack: its own fixtures and pins are tests/test_torch_shapes.py's
SHAPE_PACK = {
    "recompile-hazard", "pad-invariant", "shape-stability", "pad-mask-discipline",
    "bucket-cardinality",
}
# the port's own rules, after the reference's twelve
PORT_ONLY = ["sync-span"]
PORT_RULES = set(SHARED) | {"host-sync", "obs-emission"} | SHAPE_PACK | set(PORT_ONLY)


@pytest.fixture(scope="module")
def engine():
    """One whole-port run with every rule and the committed baseline."""
    return runner.check_engine()


def _findings(report):
    return sorted((f.rule, f.path, f.line, f.col, f.message) for f in report.blocking)


def _suppressed(report):
    return sorted(
        (f.rule, f.path, f.line, f.col, f.message, report.suppress_reasons[f])
        for f in report.suppressed
    )


def _same(ref, port):
    assert _findings(port) == _findings(ref)
    assert _suppressed(port) == _suppressed(ref)
    assert port.suppression_entries == ref.suppression_entries
    assert [f.to_json() for f in port.baselined] == [f.to_json() for f in ref.baselined]
    assert port.files_checked == ref.files_checked


# ---------------------------------------------------------------------------
# (i) differential against the reference
# ---------------------------------------------------------------------------


def test_registry_shape():
    from tpu_cypher.analysis.rules import ALL_RULES as REF_RULES

    ids = [r.id for r in ALL_RULES]
    assert len(ids) == len(set(ids)) == 13
    assert set(ids) == PORT_RULES == set(RULES_BY_ID)
    assert ids == [r.id for r in REF_RULES] + PORT_ONLY  # the reference's order, then the port's
    for r in ALL_RULES:
        assert r.id and r.title and r.rationale, r


@pytest.mark.parametrize("which", ["bad", "clean"])
@pytest.mark.parametrize("rule_id", sorted(SHARED))
def test_shared_rule_matches_reference(rule_id, which):
    path = os.path.join(REF_FIXTURES, SHARED[rule_id], which)
    ref = ref_runner.run_paths([path], rules=[rule_id])
    port = runner.run_paths([path], rules=[rule_id])
    _same(ref, port)
    hits = [f for f in port.blocking if f.rule == rule_id]
    assert bool(hits) == (which == "bad"), port.render_text()


_VIOLATION = (
    "import os\n"
    "\n"
    "\n"
    "def knob():\n"
    "    return os.environ.get('TPU_CYPHER_FIXTURE_KNOB')\n"
)
_READ = "    return os.environ.get('TPU_CYPHER_FIXTURE_KNOB')"
_RULE = "env-var-registry"

SUPPRESSION_CASES = {
    # name: (source, the blocking rules expected, suppressed count)
    "reason_next_line": (
        _VIOLATION.replace(
            _READ, f"    # tpulint: allow[{_RULE}] reason=fixture proves suppression\n" + _READ
        ),
        [], 1,
    ),
    "reason_same_line": (
        _VIOLATION.replace(_READ, _READ + f"  # tpulint: allow[{_RULE}] reason=same-line form"),
        [], 1,
    ),
    "reasonless": (
        _VIOLATION.replace(_READ, f"    # tpulint: allow[{_RULE}]\n" + _READ),
        [_RULE, "suppression"], 0,
    ),
    "wrong_rule": (
        _VIOLATION.replace(
            _READ, "    # tpulint: allow[exception-hygiene] reason=names the wrong rule\n" + _READ
        ),
        [_RULE], 0,
    ),
    "malformed": (_VIOLATION + f"# tpulint: alow[{_RULE}] reason=typo\n", [_RULE, "suppression"], 0),
    "stale": (
        "def fine(x):\n"
        f"    # tpulint: allow[{_RULE}] reason=site was fixed long ago\n"
        "    return x + 1\n",
        ["suppression"], 0,
    ),
    "stale_inactive_rule": (
        "def fine(x):\n"
        "    # tpulint: allow[host-sync] reason=judged when host-sync runs\n"
        "    return x + 1\n",
        [], 0,
    ),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppression_semantics_match_reference(tmp_path, case):
    source, rules, nsup = SUPPRESSION_CASES[case]
    (tmp_path / "knob.py").write_text(source)
    ref = ref_runner.run_paths([str(tmp_path)], rules=[_RULE])
    port = runner.run_paths([str(tmp_path)], rules=[_RULE])
    _same(ref, port)
    assert sorted(f.rule for f in port.blocking) == sorted(rules)
    assert len(port.suppressed) == nsup


@pytest.mark.parametrize("doubled", [False, True], ids=["grandfathers", "multiplicity"])
def test_baseline_semantics_match_reference(tmp_path, doubled):
    src = tmp_path / "src"
    src.mkdir()
    (src / "knob.py").write_text(_VIOLATION)
    first = runner.run_paths([str(src)], rules=[_RULE])
    port_file, ref_file = tmp_path / "port.json", tmp_path / "ref.json"
    baseline.save(str(port_file), first.blocking)
    ref_baseline.save(str(ref_file), ref_runner.run_paths([str(src)], rules=[_RULE]).blocking)
    assert port_file.read_text() == ref_file.read_text()
    if doubled:  # a second identical violation: multiplicity matters
        (src / "knob.py").write_text(
            _VIOLATION + "\n\ndef knob2():\n" + _READ + "\n"
        )
    ref = ref_runner.run_paths([str(src)], rules=[_RULE], baseline_path=str(ref_file))
    port = runner.run_paths([str(src)], rules=[_RULE], baseline_path=str(port_file))
    _same(ref, port)
    assert len(port.baselined) == 1 and len(port.blocking) == int(doubled)


def test_baseline_edge_files_match_reference(tmp_path):
    missing = str(tmp_path / "nope.json")
    assert baseline.load(missing) == ref_baseline.load(missing) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    for mod in (baseline, ref_baseline):
        with pytest.raises(ValueError):
            mod.load(str(bad))


# ---------------------------------------------------------------------------
# (ii) the retargeted rules on the torch fixtures
# ---------------------------------------------------------------------------


def _fixture(rule_id, which):
    name = rule_id.replace("-", "_")
    return runner.run_paths([os.path.join(FIXTURES, name, which)], rules=[rule_id])


@pytest.mark.parametrize("rule_id", ["host-sync", "obs-emission"])
def test_retargeted_rule_silent_on_clean(rule_id):
    report = _fixture(rule_id, "clean")
    assert report.clean and report.files_checked >= 1, report.render_text()


def test_host_sync_interprocedural_cross_module():
    """interproc.py has no torch-prefixed call: each sync there is a
    device value only through the cross-module return-summary taint
    (1-deep, 2-deep, and .item() on a helper value)."""
    report = _fixture("host-sync", "bad")
    lines = sorted(f.line for f in report.blocking if f.path.endswith("interproc.py"))
    assert lines == [11, 15, 20], report.render_text()


def test_host_sync_file_local_kinds():
    """sync.py mirrors the reference's four file-local syncs (int of a
    reduction, int through an assignment, .item(), and the device-wide
    sync in jax.device_get's place)."""
    report = _fixture("host-sync", "bad")
    got = sorted(
        (f.line, f.message.split(" forces")[0])
        for f in report.blocking if f.path.endswith("/sync.py")
    )
    assert got == [
        (7, "int(<device value>)"), (12, "int(<device value>)"), (18, ".item()"),
        (22, "torch.cuda.synchronize()"),
    ], report.render_text()


def test_host_sync_torch_kinds():
    report = _fixture("host-sync", "bad")
    got = sorted(
        f.message.split(" forces")[0] for f in report.blocking if f.path.endswith("kinds.py")
    )
    assert got == sorted([
        ".tolist()", ".cpu()", '.to("cpu")', "np.asarray(<device value>)",
        "bool(<device value>)", ".synchronize()", ".elapsed_time()",
    ]), report.render_text()


@pytest.mark.parametrize("which,want", [
    ("bad", [
        (9, "int(<device value>)"),         # no span at all
        (19, "int(<device value>)"),        # the span is the caller's
        (25, ".item()"),                    # a nested function's read
        (31, "bool(<device value>)"),       # another context manager
        (37, ".cpu()"),                     # after the span closed
        (42, "torch.cuda.synchronize()"),   # a plain span, not a sync span
    ]),
    ("clean", []),
])
def test_sync_span_flags_syncs_outside_a_sync_span(which, want):
    """spans.py: a sync must sit lexically inside ``with sync(..)`` in its
    own function, however the file imports ``obs.trace.sync``."""
    report = _fixture("sync-span", which)
    got = sorted((f.line, f.message.split(" forces")[0]) for f in report.blocking)
    assert got == want, report.render_text()
    assert report.files_checked == 1


def test_host_metadata_is_not_a_sync():
    """Allocator statistics, tensor metadata, CPU tensors and an
    isinstance-narrowed numpy array never flag (metadata.py is clean)."""
    report = _fixture("host-sync", "clean")
    assert not [f for f in report.blocking if f.path.endswith("metadata.py")]
    assert any(c.relpath.endswith("metadata.py") for c in report.project.contexts)


def test_obs_emission_flags_raw_launches_outside_registered_impls():
    report = _fixture("obs-emission", "bad")
    got = sorted((os.path.basename(f.path), f.line, f.message.split(" in ")[0])
                 for f in report.blocking)
    assert got == [
        ("elsewhere.py", 7, "_build.lib(..)"),
        ("rogue.py", 8, "module-global counter dict ROGUE_COUNTS — counters belong to the obs registry (REGISTRY.counter(..)), not module state"),
        ("rogue.py", 25, "_build.lib(..)"),
        ("rogue.py", 26, "ctypes rogue_launch"),
        ("rogue.py", 27, "ctypes rogue_launch"),
    ], report.render_text()


_FAULTS_BROKEN = (
    "FAULT_SITE_HITS = {}\n"
    "\n"
    "\n"
    "def fault_point(site):\n"
    "    return site\n"
)
_DISPATCH_BROKEN = (
    "KERNEL_LAUNCH = {}\n"
    "\n"
    "\n"
    "def launch(name, kernel_fn, plain_fn, *, device, eligible=True):\n"
    "    return kernel_fn()\n"
)
_DISPATCH_NO_SPAN = (
    "KERNEL_LAUNCH = REGISTRY.counter('k', 'k', labels=('kernel', 'tier'))\n"
    "\n"
    "\n"
    "def launch(name, kernel_fn, plain_fn, *, device, eligible=True):\n"
    "    KERNEL_LAUNCH.inc(kernel=name, tier='kernel')\n"
    "    return kernel_fn()\n"
)


@pytest.mark.parametrize("case,relpath,source,want", [
    ("faults", "runtime/faults.py", _FAULTS_BROKEN, 2),
    ("dispatch", "backend/cuda/hopper/dispatch.py", _DISPATCH_BROKEN, 3),
    ("dispatch_no_span", "backend/cuda/hopper/dispatch.py", _DISPATCH_NO_SPAN, 1),
])
def test_obs_emission_chokepoints(tmp_path, case, relpath, source, want):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True)
    p.write_text(source)
    report = runner.run_paths([str(tmp_path)], rules=["obs-emission"])
    assert len(report.blocking) == want, report.render_text()
    assert all(f.path.endswith(relpath) for f in report.blocking)


def test_file_context_tuple_unpacking():
    ctx = FileContext("mem.py", "mem.py", "def f(x):\n    a, (b, c), *d = x\n    return a\n")
    fn = ctx.functions[0]
    assert [i for _, i in ctx.unpacks(fn, "a")] == [None]  # after a starred target
    assert ctx.unpacks(fn, "b") == [] and ctx.assignments(fn, "a") == []


def test_unparsable_file_is_a_parse_finding(tmp_path):
    (tmp_path / "broken.py").write_text("def broken(:\n")
    report = runner.run_paths([str(tmp_path)])
    assert [f.rule for f in report.blocking] == ["parse"]


def test_restrict_to_checks_only_the_named_files():
    bad = os.path.join(FIXTURES, "host_sync", "bad")
    sync = os.path.join(bad, "backend", "cuda", "sync.py")
    report = runner.run_paths([bad], rules=["host-sync"], restrict_to=[sync])
    assert report.files_checked == 1 and len(report.blocking) == 4


# ---------------------------------------------------------------------------
# (iii) the port lints clean
# ---------------------------------------------------------------------------


def test_committed_baseline_is_empty():
    with open(runner.DEFAULT_BASELINE) as f:
        assert json.load(f) == {"version": 1, "findings": []}


def test_port_lints_clean(engine):
    assert engine.files_checked > 120, "port sweep looks truncated"
    assert engine.rules_run == 13
    assert engine.clean, engine.render_text()
    assert not engine.baselined
    for f in engine.suppressed:
        assert len(engine.suppress_reasons[f]) >= 10, f.location()
    assert engine.suppression_entries
    for entry in engine.suppression_entries:
        assert entry["active"] is True, f"stale suppression: {entry}"


def test_serve_has_no_inline_suppressions(engine):
    serve = [c for c in engine.project.contexts if "/serve/" in c.relpath]
    assert serve and not [c.relpath for c in serve if "tpulint" in c.source]


def test_allocator_statistics_do_not_block_the_loop(engine):
    """serve/worker.py reads torch.cuda.max_memory_allocated in an async
    path; it is host metadata, not a device sync."""
    worker = [c for c in engine.project.contexts if c.relpath.endswith("serve/worker.py")]
    assert worker and "max_memory_allocated" in worker[0].source
    assert not [f for f in engine.suppressed if f.path.endswith("serve/worker.py")]


def test_static_kernels_equal_the_runtime_registry(engine):
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    runtime = {n: s.impls for n, s in dispatch.registry().items()}
    assert engine.project.dispatch_kernels == runtime
    assert set(runtime) == {
        "expand_rows", "frontier_deg_sum", "segment_agg", "intersect", "join_probe"
    }


def test_sync_inventory_statuses(engine):
    sites = runner.sync_sites(engine)
    assert {v["status"] for v in sites.values()} <= {
        "accepted", "suppressed", "outside scope"
    }
    by_fn = {}
    for (path, line), v in sites.items():
        ctx = engine.project.by_relpath[path]
        fn = next(c for c in ctx.calls if c.lineno == line)
        name = getattr(ctx.enclosing_function(fn), "name", "")
        by_fn[(os.path.basename(path), name)] = v["status"]
    assert by_fn[("expand_op.py", "_expand_half")] == "accepted"
    assert by_fn[("column.py", "to_host")] == "suppressed"


def test_cpu_sync_rehearsal_has_no_missed_site(engine):
    """The CPU rehearsal of phase 10's sync trace: a grouped 1-hop query
    on a small graph records its would-be syncs, each attributed to a line
    of the port, and none escapes the taint model."""
    import torch

    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    smap = ST.SyncMap(engine, runner.ENGINE_ROOT)
    session = CypherSession.cuda(device="cpu")
    pg = PropertyGraph(session, generate_snb(0.02, session, seed=7))
    query = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.id < 400 "
             "RETURN a.id AS id, count(*) AS n, min(b.birthday) AS lo ORDER BY id")
    want = pg.cypher(query).records.collect()
    stacks = []
    with ST.emulated_sync_trace(torch, stacks):
        got = pg.cypher(query).records.collect()
    assert got == want and len(got) > 10
    assert torch.Tensor.item.__name__ == "item"  # the wrappers are gone
    summary = ST.summarize(smap, stacks)
    assert summary["syncs"] == len(stacks) > 0
    assert not ST.missed(summary), ST.render_sites(summary)
    assert set(summary["by_status"]) <= {"accepted", "suppressed", "outside scope", "implicit"}
    assert summary["by_status"].get("accepted", 0) > 0


# ---------------------------------------------------------------------------
# (iv) the CLI: five subprocess calls
# ---------------------------------------------------------------------------


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "tpu_cypher_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO,
    )


def test_cli_port_wide_exits_0_json(tmp_path):
    facts_out = tmp_path / "facts.json"
    proc = _cli("--format", "json", "--facts-out", str(facts_out))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = json.loads(proc.stdout)
    assert payload["clean"] is True and payload["rules_run"] == 13
    assert payload["findings"] == [] and payload["baselined"] == []
    sup = payload["suppressions"]
    assert sup["schema_version"] == 1 and sup["entries"]
    for entry in sup["entries"]:
        assert set(entry) == {"path", "line", "rules", "reason", "active"}
        assert entry["active"] is True
    assert payload["caches"]["parse_misses"] > 120 and payload["caches"]["parse_hits"] == 0
    assert payload["caches"]["summary_misses"] == 1 and payload["caches"]["summary_hits"] == 0
    facts = json.loads(facts_out.read_text())
    assert facts["schema_version"] == 1 and facts["sites"]
    assert facts["summary"]["facts_emitted"] == len(facts["sites"]) + len(facts["operators"])


def test_cli_bad_fixture_exits_1():
    bad = os.path.join(FIXTURES, "host_sync", "bad")
    proc = _cli(bad, "--rules", "host-sync", "--baseline", "")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "14 finding(s)" in proc.stdout


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 13 and {ln.split()[0] for ln in lines} == PORT_RULES


def test_cli_unknown_rule_exits_2():
    assert _cli("--rules", "not-a-rule").returncode == 2


def test_cli_write_baseline_ratchet(tmp_path):
    base = str(tmp_path / "base.json")
    bad = os.path.join(FIXTURES, "host_sync", "bad")
    proc = _cli(bad, "--rules", "host-sync", "--baseline", base, "--write-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # with the written baseline the same tree is green
    report = runner.run_paths([bad], rules=["host-sync"], baseline_path=base)
    assert report.clean and len(report.baselined) == 14


# ---------------------------------------------------------------------------
# (v) the fault sites the first clean run added: the matrix reaches them
# ---------------------------------------------------------------------------

_EXPR_GRAPH = (
    "CREATE (:P {x: 1.5, v: 2, d: date('2020-01-31')}), "
    "(:P {x: -2.5, v: 3, d: date('2021-03-01')})"
)


@pytest.mark.parametrize("query", [
    "MATCH (p:P) RETURN range(0, p.v) AS r",                 # compiler._range
    "MATCH (p:P) RETURN toInteger(p.x) AS i",                # compiler._to_integer
    "MATCH (p:P) RETURN [p.v] + [p.v, p.v] AS l",            # lists.concat_rows
    "MATCH (p:P) RETURN p.d + duration('P1M') AS d",         # compiler._shift
    "MATCH (p:P) RETURN [p.v, p.v] AS l ORDER BY l",         # values._seq_rank
])
def test_expr_site_fault_reaches_caller_typed(query):
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch import errors as ERR
    from tpu_cypher_torch.runtime import faults

    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(_EXPR_GRAPH)
    want = g.cypher(query).records.collect()
    result = g.cypher(query)
    with faults.scoped_spec("oom@expr:*"):
        with pytest.raises(ERR.DeviceOOM):
            result.records
    [entry] = result.execution_log
    assert entry["rung"] == "device" and entry["site"] == "expr" and not entry["ok"]
    assert want and g.cypher(query).records.collect() == want


def test_shuffle_site_fires_in_the_mesh_functions():
    import torch

    from tpu_cypher_torch.parallel import mesh as PM
    from tpu_cypher_torch.parallel import shuffle as PS
    from tpu_cypher_torch.runtime import faults

    keys = torch.arange(100, dtype=torch.int64) % 7
    with PM.use_mesh(PM.make_row_mesh(["cpu"] * 3)):
        assert PS.sharded_distinct_count(keys) == 7
        assert PS.hash_repartition_join(keys, None, keys, None) is not None
        for call in (lambda: PS.sharded_distinct_count(keys),
                     lambda: PS.hash_repartition_join(keys, None, keys, None)):
            with faults.scoped_spec("oom@shuffle:*"):
                with pytest.raises(faults.InjectedFault):
                    call()
