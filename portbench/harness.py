"""One run of one cell: generate, ingest, warm, measure, check.

Everything a cell is made of is found by name under ``portbench/``:
``BENCHMARK.json`` names the cell's configuration (its ``file``) and its
traffic mix (``traffic/<mix>.json``); the mix names its query kinds
(``queries/<kind>.py``); each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a mix, a query kind or a metric
adds files and entries and edits none. A metric named ``<base>.<group>`` is
``<base>`` under a name of its own for a group of cells (a bound of its own,
or the end-to-end metric it moves), read by ``metrics/<base>.py`` unless
``metrics/<base>.<group>.py`` is there.

A query kind module holds ``QUERY`` (the Cypher text), ``COLUMN`` (the
answer's column), ``params(ctx)`` (the parameter sets, drawn from the seed
at the run's start; set-up warms the first ``warm`` of each kind, by
default all), ``reference(ctx, p)`` and ``control(ctx, p)`` (the
answer worked out again from the edge arrays, and the same with one of the
configuration's guarantees broken) and ``work(ctx, p)`` (bytes each
hand-written kernel must move for the query, by kernel). A metric module
holds ``read(rec)``, which returns the metric's value from the run's
records, or None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from . import devtrace, snb
from .refctx import Context, seed_rng
from .roofline import KERNELS, bound_seconds

# top-level module names the run's process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_cypher")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.dir = self.root / "portbench"

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def mix(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def query(self, kind: str):
        return _load_module(self.dir / "queries" / f"{kind}.py", f"portbench_query_{kind}")

    def metric(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        if not path.is_file() and "." in name:
            path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
        return _load_module(path, f"portbench_metric_{name}")

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics, or with ``trace`` its per-layer ones. A metric with a
        ``workloads`` list belongs to the cells it names; one without, to
        every cell that reports the end-to-end metric it moves."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not there")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def schedule(kinds: list, params: dict, rng):
    """The closed loop's order: rounds in which each kind comes ``weight``
    times for every parameter set of the kind with the most, cycling
    through its own sets, each round shuffled by ``rng``."""
    most = max(len(params[k["query"]]) for k in kinds)
    rnd = [(k["query"], j % len(params[k["query"]]))
           for k in kinds for j in range(k["weight"] * most)]
    while True:
        for i in rng.permutation(len(rnd)):
            yield rnd[i]


def ingest(session, g: snb.Graph):
    """The graph into the program through its public table and graph API,
    as ``tpu_cypher_torch.io.ldbc._graph_from_arrays`` assembles it."""
    from tpu_cypher_torch.api import types as T
    from tpu_cypher_torch.api.mapping import NodeMapping, RelationshipMapping
    from tpu_cypher_torch.api.schema import PropertyGraphSchema
    from tpu_cypher_torch.relational.graphs import ElementTable, ScanGraph
    from tpu_cypher_torch.relational.session import PropertyGraph

    props = {"id": T.CTInteger.nullable, "birthday": T.CTInteger.nullable}
    nodes = session.table_cls.from_arrays({"id": g.ids, "birthday": g.birthday})
    rels = session.table_cls.from_arrays({
        "id": np.arange(g.e, dtype=np.int64) + (1 << 53),
        "source": g.ids[g.src], "target": g.ids[g.dst],
    })
    schema = (PropertyGraphSchema.empty()
              .with_node_combination(frozenset({"Person"}), props)
              .with_relationship_type("KNOWS", {}))
    return PropertyGraph(session, ScanGraph([
        ElementTable(NodeMapping(id_key="id", implied_labels=frozenset({"Person"}),
                                 property_mapping=tuple((k, k) for k in props)), nodes),
        ElementTable(RelationshipMapping(id_key="id", source_key="source", target_key="target",
                                         rel_type="KNOWS", property_mapping=()), rels),
    ], schema))


def ask(pg, mod, p):
    """One query through the program's public path, its one answer read on
    the host: (answer, result)."""
    res = pg.cypher(mod.QUERY, p)
    rows = res.records.collect()
    if len(rows) != 1:
        raise ValueError(f"{len(rows)} rows where one answer was due")
    return int(dict(rows[0])[mod.COLUMN]), res


def index_seconds(trace) -> float:
    """Seconds in the program's index spans (``csr_build``,
    ``edge_endpoints``) of one query's trace, nested ones once."""
    total, stack = 0.0, [trace.root]
    while stack:
        sp = stack.pop()
        if sp.name in ("csr_build", "edge_endpoints"):
            total += sp.seconds
        else:
            stack.extend(sp.children)
    return total


def host_spans(trace, offset_us: float) -> list:
    """(start_us, end_us, depth, name) of one query's spans on the trace
    clock."""
    out, stack = [], [(trace.root, 0)]
    while stack:
        sp, depth = stack.pop()
        if sp.t0 is not None:
            t0 = sp.t0 * 1e6 + offset_us
            out.append((t0, t0 + sp.seconds * 1e6, depth, sp.name))
        stack.extend((c, depth + 1) for c in sp.children)
    return out


def p95(xs: list) -> float:
    return statistics.quantiles(xs, n=20, method="inclusive")[18] if len(xs) > 1 else xs[0]


def run(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
        t_start_process: float, device=None, out=None, err=None) -> int:
    """One run; prints the result's line last on ``out`` and the compared
    numbers last on ``err``. ``device`` None means the card (and a run
    without one fails); tests pass ``"cpu"`` to drive the rest of a run
    through the program's plain tiers. Returns the exit code."""
    stages = {"python": time.perf_counter() - t_start_process}
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    import torch

    out, err = out or sys.stdout, err or sys.stderr
    cell = bench.cell(cell_name)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell_name} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=err)
            return 2
        device = "cuda:0"
    stage("cuda")
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    if mix["loop"] != "closed" or mix["clients"] != 1 or mix.get("think_ms", 0):
        raise ValueError("the harness drives one client in a closed loop with no think time")
    kinds = {k["query"]: bench.query(k["query"]) for k in mix["kinds"]}
    metric_specs = bench.metrics_of(cell_name, trace)

    from tpu_cypher_torch import CypherSession

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    stage("import")
    ctx = Context.for_run(config, mix, seed, device=device)
    graph = ctx.graph
    params = {k: m.params(ctx) for k, m in kinds.items()}
    warm = {k: v[:mix.get("warm") or len(v)] for k, v in params.items()}
    stage("generate")
    session = CypherSession.cuda() if on_card else CypherSession.cuda(device=device)
    sync()
    stage("session")
    pg = ingest(session, graph)
    sync()
    stage("ingest")
    ingest_s = stages["ingest"]

    # set-up: the first query builds the index; each warmed (kind, parameters) once
    csr_s = 0.0
    for kind, mod in kinds.items():
        for p in warm[kind]:
            _, res = ask(pg, mod, p)
            csr_s += index_seconds(res.profile().trace)
            del res
    stage("warm")
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts):  # the profiler's own first start
            torch.ones(8, device=device).sum().item()
    sync()
    stage("profiler")
    setup_s = time.perf_counter() - t_start_process
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f" (of which index builds {csr_s:.3f} s); setup_s {setup_s:.3f}", file=err)

    # the window: one client, closed loop
    order = schedule(mix["kinds"], params, seed_rng(seed, 0x0D3E))
    answers, lat, exec_s, marks, spans_by_q, failed, attempted = [], [], [], [], [], 0, 0
    prof = None
    if trace:
        prof = profile(activities=acts)
        prof.__enter__()
    t_win = time.perf_counter()
    deadline = t_win + seconds
    try:
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            kind, j = next(order)
            attempted += 1
            try:
                if trace:
                    marks.append(t0)
                    with record_function(devtrace.QUERY_REGION):
                        value, res = ask(pg, kinds[kind], params[kind][j])
                else:
                    value, res = ask(pg, kinds[kind], params[kind][j])
            except Exception:
                failed += 1
                if failed == 1:
                    traceback.print_exc(file=err)
                continue
            lat.append(time.perf_counter() - t0)
            answers.append((kind, j, value))
            qt = res.profile().trace
            exec_s.append(qt.phase_seconds().get("execute", 0.0))
            if trace:
                spans_by_q.append(qt)
            del res, qt
        t_end = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = t_end - t_win
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    rec = {
        "setup": {"ingest_s": ingest_s, "csr_build_s": csr_s},
        "queries": [{"kind": k, "execute_s": x} for (k, _, _), x in zip(answers, exec_s)],
        "syncs": None, "device": None, "work_s": {},
    }
    busy_s = None
    breakdown = None
    if trace:
        rec["device"], busy_s, breakdown = read_profile(prof, marks, spans_by_q, t_end, on_card)
        del prof, spans_by_q
        if on_card:
            rec["syncs"] = count_syncs(torch, pg, kinds, warm)
        work = {}
        for kind, j, _ in answers:
            for kernel, nbytes in kinds[kind].work(ctx, params[kind][j]).items():
                work[kernel] = work.get(kernel, 0.0) + bound_seconds(nbytes)
        rec["work_s"] = work

    # the program's state goes before the reference runs on the card
    del pg, session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    truth = {}
    for kind, j, _ in answers:
        if (kind, j) not in truth:
            truth[(kind, j)] = kinds[kind].reference(ctx, params[kind][j])
    wrong = sum(1 for kind, j, v in answers if v != truth[(kind, j)])
    correct = bool(answers) and failed == 0 and wrong == 0

    metrics = {}
    if not trace:
        values = {
            "queries_per_s": len(answers) / window_s,
            "latency_p95_ms": p95(lat) * 1e3 if lat else None,
            "peak_device_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        for m in metric_specs:
            v = values.get(m["name"].split(".")[0])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metric_specs:
            v = bench.metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = forbidden_modules()  # modules never unload: this covers the window too
    if found:
        print(f"portbench: the run's process holds {found}", file=err)
        return 3
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    if trace:
        dev["busy_s"] = busy_s
        dev["window_s"] = window_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {"wrong_answers": {"value": wrong, "limit": 0},
                       "answers_compared": {"value": len(answers), "limit": 1}}
    print(f"portbench: {cell_name} seed {seed}: {len(answers)} answers in {window_s:.3f} s, "
          f"{failed} failed; reference answers {sorted(set(truth.values()))}", file=err)
    print(f"check wrong_answers {wrong} limit 0 (at most)", file=err)
    print(f"check answers_compared {len(answers)} limit 1 (at least)", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def read_profile(prof, marks, traces, t_end, on_card):
    """(device records, busy_s, breakdown) of the traced window."""
    if not marks:
        return None, 0.0, None
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = devtrace.load(path)
    offset = devtrace.clock_offset_us(devtrace.region_starts(events), marks)
    w0, w1 = marks[0] * 1e6 + offset, t_end * 1e6 + offset
    dev = devtrace.device_events(events)
    del events
    busy_us, gaps = devtrace.busy_and_gaps(dev, w0, w1)
    kernels = {k: devtrace.kernel_seconds(dev, v["device_functions"], w0, w1)
               for k, v in KERNELS.items()}
    spans = [s for qt in traces for s in host_spans(qt, offset)]
    breakdown = {"device_ops": devtrace.top_device_ops(dev, w0, w1),
                 "idle_gaps": devtrace.name_gaps(gaps, spans)}
    rec = {"kernel_s": kernels, "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6}
    return (rec if on_card and dev else None), busy_us / 1e6, breakdown


def count_syncs(torch, pg, kinds, params) -> dict:
    """Syncs per query in a sub-window of its own, after the timed one:
    each warmed (kind, parameters) of the mix once under torch's sync debug
    mode."""
    from .syncs import cuda_sync_count

    sink, n = [], 0
    with cuda_sync_count(torch, sink):
        for kind, mod in kinds.items():
            for p in params[kind]:
                ask(pg, mod, p)
                n += 1
    return {"count": len(sink), "queries": n}
