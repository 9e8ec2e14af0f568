"""A new query kind, traffic mix, configuration and per-layer metric are
new files, and a new cell one entry in BENCHMARK.json: the harness finds
them by name, with no edit to a file that is already there."""

import hashlib
import json

DUMMY_QUERY = '''
QUERY = "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN count(*) AS c"
COLUMN = "c"


def params(ctx):
    return [None]


def reference(ctx, p):
    return ctx.graph.e


def control(ctx, p):
    return ctx.graph.e - 1


def work(ctx, p):
    return {}
'''

DUMMY_METRIC = '''
def read(rec):
    return float(len(rec["queries"]))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_one_entry_make_a_cell(tiny_root, run_cpu):
    before = _digests(tiny_root)
    pb = tiny_root / "portbench"
    (pb / "queries" / "dummy_count.py").write_text(DUMMY_QUERY)
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "think_ms": 0, "params": {},
         "kinds": [{"query": "dummy_count", "weight": 1}]}))
    cfg = json.loads((pb / "configs" / "snb_tiny.json").read_text())
    cfg["generator"].update(persons=1000, knows=12000)
    (pb / "metrics" / "dummy.queries_seen.py").write_text(DUMMY_METRIC)
    spec_path = tiny_root / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cfg["name"] = "dummy_cfg"
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "dummy_cfg", "source": "tests", "reduced": ["persons", "knows"],
                            "file": "portbench/configs/dummy_cfg.json", "why": "tests"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "tests"})
    spec["per_layer"].append({"name": "dummy.queries_seen", "unit": "queries", "better": "higher",
                              "source": "host_clock", "layer": "tests",
                              "moves": "queries_per_s", "workloads": ["dummy.cell"]})
    spec_path.write_text(json.dumps(spec))
    after = _digests(tiny_root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {spec_path.relative_to(tiny_root)}

    rc, res, err = run_cpu("dummy.cell", seed=41)
    assert rc == 0 and res["correct"] is True, err
    rc, res, err = run_cpu("dummy.cell", seed=42, trace=True)
    assert rc == 0 and res["correct"] is True, err
    assert res["metrics"]["dummy.queries_seen"]["value"] >= 1
    assert "expand_rows_roofline" not in res["metrics"]


def test_a_missing_file_is_named(run_cpu, tiny_root):
    import pytest

    spec_path = tiny_root / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "nowhere.cell", "config": "snb_tiny",
                              "traffic": "no_such_mix", "chips": 1, "why": "tests"})
    spec_path.write_text(json.dumps(spec))
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        run_cpu("nowhere.cell")
