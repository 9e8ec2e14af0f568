"""The port stands alone: ``tpu_cypher_torch`` (and ``chip_smoke.py`` and
the ``scripts/`` that drive it on the card) import neither
``jax`` nor the JAX package.

Three checks: a subprocess that blocks ``jax``, ``jaxlib`` and
``tpu_cypher`` on ``sys.meta_path`` and still imports the port and answers
the single-hop count on the CPU; another that imports every module of the
serving tier (``tpu_cypher_torch/serve/``) under the same block and
answers a query through a ``QueryServer`` over TCP; and an AST scan that
fails on any import of those modules anywhere in the port's sources or
those scripts.
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "tpu_cypher")

_CHILD = r"""
import sys

BLOCKED = ("jax", "jaxlib", "tpu_cypher")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())

import torch

torch.set_num_threads(1)
from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.io.ldbc import generate_snb
from tpu_cypher_torch.relational.session import PropertyGraph

session = CypherSession.cuda(device="cpu")
graph = PropertyGraph(session, generate_snb(0.02, session))
rows = graph.cypher("MATCH (a:Person)-[:KNOWS]->(b) RETURN count(*) AS c").records.collect()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("COUNT", dict(rows[0])["c"])
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    # generate_snb(0.02): 200 persons, 8,950 KNOWS after dropping self-loops
    assert "COUNT 8950" in out.stdout, out.stdout


_SERVE_CHILD = _CHILD.split("session = CypherSession")[0] + r"""
import asyncio
import json

import tpu_cypher_torch.serve as S
from tpu_cypher_torch.serve import (  # noqa: F401
    __main__, batching, cluster, result_cache, router, scheduler, server,
    session_pool, supervisor, wire, worker,
)

session = CypherSession.cuda(device="cpu")
graph = session.create_graph_from_create_query(
    "CREATE (a:P {id: 1})-[:K]->(b:P {id: 2})")


async def main():
    async with S.QueryServer(session, port=0) as srv:
        srv.register_graph("g", graph)
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(json.dumps({"op": "submit", "id": "q", "graph": "g",
                                 "query": "MATCH (a)-[:K]->(b) RETURN b.id AS id"}
                                ).encode() + b"\n")
        rows = []
        while True:
            msg = json.loads(await reader.readline())
            if msg["type"] == "rows":
                rows += msg["rows"]
            if msg["type"] in ("done", "error"):
                writer.close()
                return msg["type"], rows


print("SERVED", asyncio.run(main()))
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
"""


def test_serving_tier_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SERVED ('done', [{'id': 2}])" in out.stdout, out.stdout


def _port_sources():
    for base, _, files in os.walk(os.path.join(ROOT, "tpu_cypher_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in ("kernel_ab.py", "query_ab.py", "serve_smoke.py", "sync_map.py"):
        yield os.path.join(ROOT, "scripts", name)


def _blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def test_no_module_of_the_port_imports_jax_or_the_reference():
    bad = []
    count = 0
    for path in _port_sources():
        count += 1
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _blocked(a.name)]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module and _blocked(node.module):
                    bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") in (
                "__import__", "import_module",
            ):
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    if _blocked(arg.value):
                        bad.append((path, arg.value))
    assert count > 50  # the walk saw the package
    seen = {os.path.relpath(p, ROOT).replace(os.sep, "/") for p in _port_sources()}
    assert {
        f"tpu_cypher_torch/analysis/{m}.py"
        for m in ("shapes", "rules/pad_invariant", "rules/recompile",
                  "rules/shape_stability", "rules/pad_mask", "rules/bucket_cardinality")
    } <= seen  # the shape pack is scanned
    assert not bad, bad
