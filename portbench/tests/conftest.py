"""Fixtures of the benchmark's own tests: a copy of the benchmark with a
tiny configuration (2,000 persons, 30,000 KNOWS) and cells over it, which the
harness drives through the program's plain tiers on the CPU.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips without one; the check runs inside the fixture, never
while a module is imported.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.refctx import find_walk_windows  # noqa: E402
from portbench.snb import graph_of  # noqa: E402

TINY_GRAPH = {"persons": 2000, "knows": 30000}
TINY_CELLS = {"tiny.fof_distinct": "fof_distinct", "tiny.close": "close",
              "tiny.varlen": "varlen_tiny"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card (python3 -m pytest portbench/tests -m card)")
    return "cuda:0"


def make_tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` as committed,
    plus the tiny configuration, a var-length mix sized to it and the tiny
    cells, all as new files and entries."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dest / "portbench"
    cfg = json.loads((pb / "configs" / "snb_sf1.json").read_text())
    cfg.update(name="snb_tiny", reduced=["persons", "knows"])
    cfg["generator"].update(TINY_GRAPH)
    (pb / "configs" / "snb_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "varlen.json").read_text())
    mix["params"].update(walk_budget=2_000_000, count=4)
    mix["params"]["windows"] = {"snb_tiny": find_walk_windows(graph_of(cfg["generator"]),
                                                              mix["params"])}
    (pb / "traffic" / "varlen_tiny.json").write_text(json.dumps(mix))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "snb_tiny", "source": "tests", "reduced": ["persons", "knows"],
                            "file": "portbench/configs/snb_tiny.json", "why": "tests"})
    for cell, traffic in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": "snb_tiny", "traffic": traffic,
                                  "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "." not in m["name"]:
            m["workloads"] += list(TINY_CELLS)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def run_cpu(tiny_root):
    """run_cpu(cell, seed, seconds=1.0, trace=False) -> (rc, result, stderr)
    of one harness run over the tiny root on the CPU."""
    import io
    import time

    from portbench.harness import Bench, run

    def go(cell, seed=20241018, seconds=1.0, trace=False, root=None):
        out, err = io.StringIO(), io.StringIO()
        rc = run(Bench(root or tiny_root), cell, seed, seconds, trace, time.perf_counter(),
                 device="cpu", out=out, err=err)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

    return go
