"""``python -m tpu_cypher_torch.serve`` — a query server on a demo graph.

Builds one warm CUDA-backend session (``CypherSession.cuda()``: the card,
or an error without one; ``--device cpu`` runs every kernel's plain
PyTorch version on the host), mounts a small social-chain demo graph as
``demo``, warms the obvious query shapes, and serves
``TPU_CYPHER_SERVE_PORT`` until interrupted. The point is a copy-paste
smoke target::

    python -m tpu_cypher_torch.serve &            # or: --device cpu
    curl -s localhost:7687/healthz
    printf '%s\n' '{"op":"submit","graph":"demo","query":"MATCH (a:P) RETURN count(a) AS n"}' | nc localhost 7687
    curl -s localhost:7687/metrics | head

With ``TPU_CYPHER_SERVE_WORKERS=N`` (N > 0) the same entry point runs the
fault-isolated multi-process tier instead: a ``ClusterServer`` router in
this process fanning out to N supervised engine-worker processes
(``serve/cluster.py``) on the same device. SIGTERM drains gracefully in either mode:
in-flight queries finish, new submits are rejected typed, workers exit.

Real deployments embed ``QueryServer``/``ClusterServer`` and mount their
own catalog graphs; see docs/serving.md (written for the reference; the
protocol is the same).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..relational.session import CypherSession
from ..utils.config import SERVE_WORKERS
from .cluster import ClusterServer
from .server import QueryServer

DEMO_WARMUP = (
    "MATCH (a:P) RETURN count(a) AS n",
    "MATCH (a:P)-[:K]->(b:P) RETURN count(b) AS n",
    "MATCH (a:P {id: 0})-[:K]->(b:P) RETURN b.id AS id ORDER BY id",
)


def _demo_create_query(n: int = 32) -> str:
    parts = [f"(n{i}:P {{id: {i}}})" for i in range(n)]
    parts += [f"(n{i})-[:K]->(n{(i + 1) % n})" for i in range(n)]
    parts += [f"(n{i})-[:K]->(n{(i + 7) % n})" for i in range(n)]
    return "CREATE " + ", ".join(parts)


async def _serve(server: QueryServer, stats) -> int:
    await server.start()
    mode = (
        f"{server.n_workers} workers"
        if isinstance(server, ClusterServer)
        else "single-process"
    )
    print(
        f"tpu-cypher query server on {server.host}:{server.port} "
        f"({mode}; graphs: demo; warmup kernel builds: "
        f"{stats.get('compiles', '?')})",
        flush=True,
    )
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    # SIGTERM = graceful drain (k8s preStop semantics): finish in-flight,
    # reject new submits typed, then exit
    loop.add_signal_handler(signal.SIGTERM, stop.set)
    serve_task = asyncio.ensure_future(server.serve_forever())
    stop_task = asyncio.ensure_future(stop.wait())
    try:
        await asyncio.wait(
            {serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
        )
        if stop.is_set():
            await server.drain()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        serve_task.cancel()
        stop_task.cancel()
        await server.stop()
    return 0


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpu_cypher_torch.serve")
    parser.add_argument(
        "--device", default=None,
        help="the backend's device: cuda (the default; fails without a "
        "card) or cpu (every kernel's plain PyTorch version, for a drive "
        "without a card)",
    )
    args = parser.parse_args(argv)
    # the blocking setup — session bring-up, demo graph, warmup — happens
    # BEFORE the event loop exists; the loop only ever runs non-blocking
    # serving code
    if int(SERVE_WORKERS.get()) > 0:
        server = ClusterServer(device=args.device or "cuda")
        server.register_graph("demo", _demo_create_query())
        stats = server.warmup(DEMO_WARMUP, "demo")
        return asyncio.run(_serve(server, stats))
    session = CypherSession.cuda(device=args.device)
    server = QueryServer(session)
    server.register_graph(
        "demo", session.create_graph_from_create_query(_demo_create_query())
    )
    stats = server.warmup(DEMO_WARMUP, "demo")
    return asyncio.run(_serve(server, stats))


if __name__ == "__main__":
    try:
        sys.exit(_main())
    except KeyboardInterrupt:
        sys.exit(130)
