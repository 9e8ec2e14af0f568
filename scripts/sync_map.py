#!/usr/bin/env python3
"""The port's device->host syncs per query, by source line, held against
the static analyzer's host-sync inventory.

    python3 scripts/sync_map.py                       # on the card: SF1 and SF10
    python3 scripts/sync_map.py --device cpu --small 0.05 --big 0.1

Runs ``chip_smoke.SYNC_QUERIES`` (Q2, Q6, Q11 and Q15 on the big graph, Q5
on the small one) once warm and once traced, as ``chip_smoke.py`` phase
10 does (``tpu_cypher_torch.analysis.synctrace.trace_queries``). On the
card the trace is torch's sync debug mode (``cuda_sync_trace``); on the
CPU it is the rehearsal (``emulated_sync_trace``), which sees the
explicit syncs and the data-dependent sizes but no copy to the device,
runs the kernels' plain versions in their place, and counts a
``.cpu().numpy()`` twice; it runs under ``TPU_CYPHER_WCOJ=force``, so
that a small graph takes the WCOJ path ``auto`` gives SF10's Q6. Prints, per query, its syncs by analyzer status
and its sites as ``file:line:function [status] xN``; the last line is a
JSON object of the counts. Exits 1 when a site the analyzer should have
seen is ``missed``.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", type=float, default=1.0, help="scale of the small graph")
    ap.add_argument("--big", type=float, default=10.0, help="scale of the big graph")
    args = ap.parse_args()

    import torch

    from chip_smoke import SEED, SYNC_QUERIES
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.analysis import runner
    from tpu_cypher_torch.analysis import synctrace as ST
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph
    from tpu_cypher_torch.utils import config as C

    if args.device == "cuda" and not torch.cuda.is_available():
        print("sync_map: CUDA is not available (--device cpu rehearses)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    report = runner.check_engine()
    smap = ST.SyncMap(report, runner.ENGINE_ROOT)
    print(f"analyzer: {report.files_checked} files, {len(report.blocking)} findings, "
          f"{len(smap.static)} sync sites in {time.perf_counter() - t0:.2f} s")
    session = CypherSession.cuda(device=args.device)
    graphs = {
        "small": PropertyGraph(session, generate_snb(args.small, session, seed=SEED)),
        "big": PropertyGraph(session, generate_snb(args.big, session, seed=SEED)),
    }
    trace = ST.cuda_sync_trace if args.device == "cuda" else ST.emulated_sync_trace
    if args.device == "cpu":
        C.WCOJ_MODE.set("force")  # the WCOJ path SF10's Q6 takes under auto
    try:
        out, bad = ST.trace_queries(torch, smap, graphs, SYNC_QUERIES, trace)
    finally:
        C.WCOJ_MODE.reset()
    for label, site in bad:
        print(f"missed: {label} {site}")
    print(json.dumps({"device": args.device, "queries": out, "missed": len(bad)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
