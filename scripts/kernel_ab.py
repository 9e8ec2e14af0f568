#!/usr/bin/env python3
"""Time the ``segment_agg`` and ``frontier_deg_sum`` calls of one checkout
of the port on one CUDA card, so that two checkouts compare in one run.

    python3 scripts/kernel_ab.py [--root PATH] [--label NAME]

``PATH`` is the root of a checkout of this repository (default: the one
this script lies in); its ``tpu_cypher_torch`` is imported and its kernels
built. To compare two checkouts, run the script on each in turns (A, B, B,
A) on one machine. Each run prints the ``nvidia-smi`` name and power limit
line, then, as its last line, one JSON object of its times in ms (CUDA
events, means over back-to-back calls after warm-up, unless named
otherwise):

- ``seg_row_ms``: ``segment_agg``'s kernel at PERF.md's row shape (SF1's
  19,853,591 second-hop rows, k = 1, an int64 min, int32 segment ids, no
  mask); ``seg_row_call`` names the function timed, which differs between
  checkouts that have a one-pass kernel and those that have not;
- ``seg_q5_tier_ms``: the kernel tier (``_segment_aggregate_cuda``) on the
  arguments Q5's ``min(c.birthday)`` hands the ``segment_agg`` gate,
  captured with a hook (``seg_q5_args`` describes them);
- ``seg_k256_tier_ms``: the kernel tier at k = 256, 1,000,000 rows, random
  int64 segment ids and a mask;
- ``frontier_ms``: ``frontier_deg_sum``'s wrapper at Q2 (SF10, F =
  100,000), a host loop of 100 calls; ``frontier_device_ms`` the device
  time of the same loop (``torch.profiler``, kernel durations only);
- ``q3_warm_ms``, ``q5_warm_ms``: medians of ``--runs`` warm runs of Q3
  (SF10) and Q5 (SF1) through ``CypherSession.cuda()`` (host clock, ending
  in a synchronize), with their fastest and slowest runs.

Every answer is checked against numpy truth from the generator's arrays,
and every kernel result against the checkout's plain version.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE_ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py (its helpers), the other's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE_ROOT, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    import tpu_cypher_torch
    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import _build
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA
    from tpu_cypher_torch.backend.cuda.hopper import frontier as KF
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    pkg = os.path.dirname(os.path.abspath(tpu_cypher_torch.__file__))
    S.check(pkg == os.path.join(root, "tpu_cypher_torch"), f"imported {pkg}, not {root}")
    card = S.card_line()
    print(f"card: {card}")
    print(f"root {root}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all()
    session = CypherSession.cuda()
    dev = S.backend_device()
    g1 = PropertyGraph(session, generate_snb(1.0, session, seed=S.SEED))
    g10 = PropertyGraph(session, generate_snb(10.0, session, seed=S.SEED))
    ids1, bday1, src1, dst1 = S.graph_arrays(g1)
    ids10, bday10, src10, dst10 = S.graph_arrays(g10)
    s1, d1 = np.searchsorted(ids1, src1), np.searchsorted(ids1, dst1)
    s10, d10 = np.searchsorted(ids10, src10), np.searchsorted(ids10, dst10)
    in1 = np.bincount(d1, minlength=len(ids1))
    out1 = np.bincount(s1, minlength=len(ids1))
    q5_rows = int(out1[d1].sum())
    reach = bday1[d1[in1[s1] > 0]]
    q3_truth = {"lo": int(bday10[d10].min()), "hi": int(bday10[s10].max())}
    q5_truth = {"lo": int(reach.min()), "hi": int(reach.max())}
    res = {"label": args.label or root, "card": card}

    def same(got, want, what):
        S.check(S.tuple_err(torch, got, want) == 0.0, f"{what} disagrees with plain")

    # segment_agg at the row's shape
    rng = np.random.default_rng(S.SEED)
    vals = torch.from_numpy(rng.integers(0, 18_000, size=q5_rows, dtype=np.int64)).to(dev)
    seg32 = torch.zeros(q5_rows, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int64).max
    if hasattr(KA, "seg_reduce_cuda"):  # a checkout with the two-pass kernel
        res["seg_row_call"] = "seg_reduce_cuda (min only)"
        row = lambda: KA.seg_reduce_cuda(vals, seg32, big, "min", 1)  # noqa: E731
        same((row(),), (J._segment_reduce(vals, seg32, 1, "min", big),), "row shape")
    else:
        res["seg_row_call"] = "_segment_aggregate_cuda (count, min, valid)"
        row = lambda: KA._segment_aggregate_cuda(vals, None, seg32, "min", "i64", 1)  # noqa: E731
        same(row(), J.segment_aggregate(vals, None, None, seg32, "min", "i64", 1), "row shape")
    res["seg_row_ms"] = S.time_ms(torch, row)

    # the kernel tier on Q5's own min(c.birthday) call
    calls = S.q5_segment_agg_calls(g1, (q5_truth["lo"], q5_truth["hi"]))
    data, valid, seg_j, name, kind, k = calls[0]
    res["seg_q5_args"] = (
        f"{name}({kind}) n={int(data.shape[0])} k={k} mask={valid is not None} "
        f"seg={'none' if seg_j is None else str(seg_j.dtype)}"
    )
    tier = lambda: KA._segment_aggregate_cuda(*calls[0])  # noqa: E731
    same(tier(), J.segment_aggregate(data, valid, None, seg_j, name, kind, k), "Q5 tier")
    res["seg_q5_tier_ms"] = S.time_ms(torch, tier)

    # the kernel tier at k = 256
    n256 = 1_000_000
    v256 = torch.from_numpy(rng.integers(0, 18_000, size=n256, dtype=np.int64)).to(dev)
    s256 = torch.from_numpy(rng.integers(0, 256, size=n256, dtype=np.int64)).to(dev)
    m256 = torch.from_numpy(rng.random(n256) < 0.9).to(dev)
    k256 = lambda: KA._segment_aggregate_cuda(v256, m256, s256, "min", "i64", 256)  # noqa: E731
    same(k256(), J.segment_aggregate(v256, m256, None, s256, "min", "i64", 256), "k=256 tier")
    res["seg_k256_tier_ms"] = S.time_ms(torch, k256)

    # frontier_deg_sum at Q2
    ctx = session._runtime_context({})
    gi = GraphIndex.of(g10._graph)
    gi.node_ids(ctx)
    rp, _, _ = gi.csr(("KNOWS",), False, ctx)
    pos = torch.arange(gi.num_nodes, dtype=torch.int64, device=dev)
    present = torch.ones(gi.num_nodes, dtype=torch.bool, device=dev)
    fr = lambda: KF.deg_sum_cuda(rp, pos, present)  # noqa: E731
    S.check(int(fr()) == len(src10), "frontier_deg_sum at Q2 != the KNOWS count")
    res["frontier_ms"] = S.time_ms(torch, fr, iters=100)
    res["frontier_device_ms"] = S.device_ms(torch, fr, iters=100)

    # Q3 and Q5 warm
    for key, pg, q, want in (("q3", g10, S.Q3, q3_truth), ("q5", g1, S.Q5, q5_truth)):
        times = []
        for i in range(args.runs + 1):
            t0 = time.perf_counter()
            rows = [dict(r) for r in pg.cypher(q).records.collect()]
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            S.check(rows == [want], f"{key} {rows} != {want}")
        res[f"{key}_warm_ms"] = statistics.median(times)
        res[f"{key}_warm_min_max_ms"] = [min(times), max(times)]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
