"""The multi-process path of the port (``tpu_cypher_torch/parallel/
multihost.py``) on the CPU.

The counterparts of ``tests/test_multihost.py``: the single-process
degenerate form (no process group, the global mesh is the local one,
collecting is the identity, ``dryrun_multihost`` on an 8-shard virtual
mesh), the sharded engine paths on the 8-shard global mesh in one
process held to the single-device run with the tier counters advancing,
and a real two-process run: two OS processes, 4 virtual CPU shards each,
joined over ``gloo`` on a free localhost port, one global mesh of 8. The
reference skips its two-process test on the CPU (JAX's CPU backend has no
cross-process collectives); ``torch.distributed``'s ``gloo`` has them, so
the port's runs here and asserts what the reference's asserts.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.obs.metrics import REGISTRY as POBS
from tpu_cypher_torch.parallel import mesh as PM
from tpu_cypher_torch.parallel import multihost as MH
from tpu_cypher_torch.utils.config import WCOJ_MODE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _reset():
    yield
    PM.activate_mesh(None)
    WCOJ_MODE.reset()
    PDEV.use("cpu")


def test_initialize_degenerate_no_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert MH.initialize_distributed() is False
    assert MH.process_count() == 1
    assert MH.is_host0() is True
    assert MH.backend() is None
    # one process named by the environment is still no group
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert MH.initialize_distributed() is False


def test_global_mesh_spans_all_devices():
    mesh = MH.global_row_mesh(CPU8)
    assert mesh.axis_names == (PM.ROW_AXIS,)
    assert mesh.size == 8 and not mesh.spans_processes
    assert mesh.local_shards() == list(range(8))


def test_collect_on_host0_identity_single_process():
    got = MH.collect_on_host0(torch.arange(10))
    assert got is not None and (got == np.arange(10)).all()


def test_dryrun_multihost_engine_query():
    report = MH.dryrun_multihost(CPU8)
    assert report["processes"] == 1
    assert report["devices"] == 8
    assert report["host0"] is True
    assert report["two_hop"] > 0
    assert report["backend"] is None
    assert PM.current_mesh() is None  # the session's mesh ends with the block


def _bag(result):
    return Counter(tuple(sorted(dict(r).items())) for r in result.records.collect())


def test_virtual_mesh_engine_paths():
    """The engine paths (the count chain, grouped integer aggregates, the
    WCOJ range count, DISTINCT) on the 8-shard global mesh in one process,
    bag-identical to the single-device run, with the tier counters showing
    that the sharded tiers answered."""
    rng = np.random.default_rng(9)
    n, e = 61, 240
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    parts = [f"(n{i}:Person {{id:{i * 3 + 1}, age:{i % 50 + 18}}})" for i in range(n)]
    parts += [f"(n{s})-[:KNOWS]->(n{d})" for s, d in zip(src, dst)]
    create = "CREATE " + ", ".join(parts)
    queries = [
        "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) RETURN count(*) AS c",
        "MATCH (a:Person)-[:KNOWS]->(b) RETURN b.age AS k, count(*) AS c, "
        "sum(a.age) AS s, avg(a.age) AS m ORDER BY k LIMIT 5",
        "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) RETURN count(*) AS t",
        "MATCH (a:Person)-[:KNOWS]->(b) WITH DISTINCT a.age AS x RETURN count(*) AS n",
    ]
    g1 = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
    WCOJ_MODE.set("force")
    single = [_bag(g1.cypher(q)) for q in queries]
    counters = ("tpu_cypher_mesh_agg_total", "tpu_cypher_mesh_wcoj_total")
    before = [POBS.counter(c).value() for c in counters]
    with PM.use_mesh(MH.global_row_mesh(CPU8)):
        g8 = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
        sharded = [_bag(g8.cypher(q)) for q in queries]
    for q, a, b in zip(queries, single, sharded):
        assert a == b, f"\nquery: {q}\nsingle: {a!r}\nsharded: {b!r}"
    assert all(POBS.counter(c).value() > b for c, b in zip(counters, before))


def test_collective_backend_follows_the_devices(monkeypatch):
    """The backend comes from the devices each process names, never from
    the host's card count: two cards visible change nothing for processes
    on the CPU or sharing one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cb = MH.collective_backend
    assert cb([("h", ["cpu"] * 4), ("h", ["cpu"] * 4)]) == "gloo"
    assert cb([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:0", "cuda:0"])]) == "gloo"
    assert cb([("h", ["cuda:0"]), ("h", ["cuda:1", "cpu"])]) == "gloo"
    assert cb([("h", ["cuda:0"]), ("h", ["cuda:1"])]) == "nccl"
    assert cb([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:1"])]) == "nccl"
    assert cb([("a", ["cuda:0"]), ("b", ["cuda:0"])]) == "nccl"  # two hosts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_engine_query():
    """Two OS processes over ``gloo`` (4 virtual CPU shards each, one
    global mesh of 8) run ``dryrun_multihost``, which checks both answers
    against numpy: a REPORT line means the engine ran right across the
    process boundary. Both processes must agree."""
    port = _free_port()
    procs = []
    try:
        for rank in (0, 1):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                       PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpu_cypher_torch.parallel.multihost"] + ["cpu"] * 4,
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        reports = []
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-2000:]
            lines = [l for l in out.splitlines() if l.startswith("REPORT ")]
            assert lines, out[-2000:]
            reports.append(json.loads(lines[-1][len("REPORT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [r["processes"] for r in reports] == [2, 2]
    assert [r["devices"] for r in reports] == [8, 8]
    assert [r["backend"] for r in reports] == ["gloo", "gloo"]
    assert reports[0]["two_hop"] == reports[1]["two_hop"]
    assert reports[0]["rows"] == reports[1]["rows"]
    assert {r["host0"] for r in reports} == {True, False}
