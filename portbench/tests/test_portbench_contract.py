"""BENCHMARK.json against the limits the benchmark is held to, and every
file it names by name present."""

import json
import re

import pytest

from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                 and not p.startswith("/") for p in SPEC["paths"])
    cmd = SPEC["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if (REPO / w).is_file()]
    assert files and all(any(f.startswith(p + "/") for p in SPEC["paths"]) for f in files)
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24  # a full check of 24 cells
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files and (REPO / c["file"]).is_file()
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def test_workloads():
    ws = SPEC["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        for k in mix["kinds"]:
            assert (REPO / "portbench" / "queries" / f"{k['query']}.py").is_file()


def test_metrics():
    e2e, layer = SPEC["end_to_end"], SPEC["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in layer:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert _line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        assert set(m.get("workloads", [])) <= cells
        reporting = {w for w in cells if w in next(x for x in e2e if x["name"] == m["moves"])
                     .get("workloads", [w])}
        assert set(m.get("workloads", reporting)) <= reporting
        metrics = REPO / "portbench" / "metrics"
        assert (metrics / f"{m['name']}.py").is_file() or (
            metrics / f"{m['name'].split('.')[0]}.py").is_file()
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough(cell):
    from portbench.harness import Bench

    bench = Bench(REPO)
    e2e = {m["name"] for m in bench.metrics_of(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics_of(cell, True)
