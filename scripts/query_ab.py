#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s SF10 expression and list queries on one checkout
of the port on one CUDA card, so that two checkouts compare in one run.

    python3 scripts/query_ab.py [--root PATH] [--label NAME] [--runs N] [--queries Q28,Q35]

``PATH`` is the root of a checkout of this repository (default: the one
this script lies in); its ``tpu_cypher_torch`` answers the queries, which
come from this script's own ``chip_smoke.py``, so both checkouts run the
same query text. To compare two checkouts, run the script on each in turns
(A, B, B, A) on one machine.

Each run builds SF10 (``generate_snb(10.0, seed=chip_smoke.SEED)``), then
runs each query once cold and ``N`` times warm (default 7) through
``CypherSession.cuda()``, timed on the host clock from the call to the
collected rows and a synchronize. Every run's rows are checked against
``chip_smoke.expr_truth`` or ``chip_smoke.list_truth``. A query the
checkout refuses (it raises) is listed with its error under ``refused``.
``host_probe_ms`` is the median of five runs of a fixed pure-Python loop,
the host's own speed in that process: a change of the host's speed moves
it, a change of the port does not.

It prints the ``nvidia-smi`` name and power limit line, then, as its last
line, one JSON object: per query the warm median ms, the fastest and
slowest warm runs and the cold run.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ("Q27", "Q28", "Q30", "Q31", "Q32", "Q34", "Q34_VALUES", "Q35")


def host_probe_ms() -> float:
    def once():
        t0 = time.perf_counter()
        acc = 0
        for i in range(2_000_000):
            acc += i & 7
        return (time.perf_counter() - t0) * 1e3

    return statistics.median(once() for _ in range(5))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE_ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--queries", default=",".join(QUERIES))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py (queries, truth), the other's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE_ROOT, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("query_ab: CUDA is not available; this script needs one card", file=sys.stderr)
        return 2
    import tpu_cypher_torch
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.backend.cuda.hopper import _build
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    pkg = os.path.dirname(os.path.abspath(tpu_cypher_torch.__file__))
    S.check(pkg == os.path.join(root, "tpu_cypher_torch"), f"imported {pkg}, not {root}")
    card = S.card_line()
    print(f"card: {card}")
    _build.build_all()
    session = CypherSession.cuda()
    g10 = PropertyGraph(session, generate_snb(10.0, session, seed=S.SEED))
    ids, bday, src, dst = S.graph_arrays(g10)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    truth = {**S.expr_truth(ids, bday, s, d), **S.list_truth(ids, bday, s, d, [])}
    truth["Q34_VALUES"] = truth.pop("Q34 values")
    res = {"label": args.label or root, "card": card, "host_probe_ms": host_probe_ms(),
           "refused": {}}

    def rows_ok(name, rows):
        if name == "Q34_VALUES":
            return sorted(rows, key=lambda r: r["id"]) == truth[name]
        if name == "Q35":
            return {r["a"]: sorted(n.id for n in r["fs"]) for r in rows} == truth[name]
        return rows == truth[name]

    for name in args.queries.split(","):
        query = getattr(S, name)
        times = []
        try:
            for _ in range(1 + args.runs):
                t0 = time.perf_counter()
                rows = [dict(r) for r in g10.cypher(query).records.collect()]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                S.check(rows_ok(name, rows), f"{name} disagrees with numpy truth")
        except S.SmokeFailure:
            raise
        except Exception as exc:  # a checkout that cannot answer the query
            res["refused"][name] = f"{type(exc).__name__}: {exc}"[:200]
            continue
        warm = times[1:]
        res[name] = {"warm_ms": statistics.median(warm), "min_ms": min(warm),
                     "max_ms": max(warm), "cold_ms": times[0]}
    res["host_probe_end_ms"] = host_probe_ms()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
