#!/usr/bin/env python3
"""Time the ``segment_agg``, ``frontier_deg_sum``, ``expand_rows``,
``intersect`` and ``join_probe`` calls and Q3, Q5, Q6, Q11, Q22 and Q23 of
one checkout of the port on one CUDA card, so that two checkouts compare
in one run.

    python3 scripts/kernel_ab.py [--root PATH] [--label NAME]
                                 [--intersect-only | --join-only]

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
- ``expand_q5_tier_ms``: the ``expand_rows`` kernel tier
  (``expand_materialize_counted_cuda``) at Q5's second hop (SF1, F =
  449,972, 19,853,591 lanes, with orig, as ``CsrExpandOp`` calls it);
- ``expand_q6_tier_ms``: the same tier on the arguments Q6's count tier
  hands the ``expand_rows`` gate for arm 0 (SF10, 102,797,650 lanes),
  captured with a hook; ``expand_q6_call`` says whether that checkout's
  count tier asks for orig;
- ``intersect_q6_ms``, ``intersect_q22_ms``, ``intersect_q23_ms``:
  ``intersect``'s kernel (``range_count_cuda``) on the inputs of the
  count tier's arm 0 in Q6 (SF10, 102,797,650 queries), of Q22's first
  closing probe and of Q23's (Q6 under ``TPU_CYPHER_WCOJ=off``), each
  about 197M queries over SF10's 4,499,960 KNOWS keys, captured with a
  hook on the gate;
- ``q3_warm_ms``, ``q5_warm_ms``, ``q6_warm_ms``, ``q22_warm_ms``,
  ``q23_warm_ms``: medians of ``--runs`` warm runs of Q3 (SF10), Q5 (SF1),
  Q6, Q22 and Q23 (SF10) through ``CypherSession.cuda()`` (host clock,
  ending in a synchronize), with their fastest and slowest runs;
- ``q6_first_peak_gib``: peak device memory
  (``torch.cuda.max_memory_allocated``, GiB) over Q6's first run on the
  graph, which builds its reverse CSR; ``q6_warm_peak_gib`` the same over
  the warm runs; ``q6_base_gib`` and ``q6_peak_trace``: the memory held
  when one more warm run starts, and that run's running peak at each
  ``expand_rows`` and ``intersect`` gate call's entry and exit.

- ``join_build_ms``, ``join_probe_ms``: ``join_probe``'s build (its
  kernel and any memset) and probe kernels at Q11's captured inputs
  (SF10, 4,499,960 probe lanes, a 100,000-row build), their device time
  per call in a ``torch.profiler`` trace of the kernel tier
  (``_join_probe_kernel_tier``, which both checkouts have);
  ``join_tier_ms`` that tier as the gate runs it (CUDA events),
  ``join_tier_device_ms`` and ``join_tier_device_ops`` its device time and
  device operations a call, ``join_tier_device_by_name`` both by name, and
  ``q11_warm_ms`` Q11's warm median.

``--intersect-only`` keeps the ``intersect`` calls and Q22 and Q23 warm
and skips the rest, for turns between variants of that kernel;
``--join-only`` keeps the ``join_probe`` calls and Q11 warm.

Every answer is checked against numpy truth from the generator's arrays,
and every kernel result against the checkout's plain version.
"""

import argparse
import gc
import importlib.util
import json
import os
import statistics
import sys
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def expand_tier(KX, args, kwargs):
    """A call of the checkout's kernel tier on a gate call's arguments; a
    checkout without ``with_orig`` computes orig all the same."""
    extra = (kwargs["with_orig"],) if "with_orig" in kwargs else ()
    return lambda: KX.expand_materialize_counted_cuda(*args, kwargs["size"], *extra)


def peak_trace(S, torch, pg, query, rows_ok):
    """One run of ``query`` with hooks on the ``expand_rows`` and
    ``intersect`` gates: the device memory allocated when the run starts
    (GiB, after a garbage collection) and the running peak
    (``torch.cuda.max_memory_allocated``, GiB) at each gate call's entry and
    exit, so that the step which sets the query's peak shows."""
    from tpu_cypher_torch.backend.cuda import hopper

    trace = []

    def gib():
        torch.cuda.synchronize()
        return round(torch.cuda.max_memory_allocated() / 2**30, 3)

    def hooked(name, inner):
        def hook(*args, **kwargs):
            trace.append([f"{name} in", gib()])
            out = inner(*args, **kwargs)
            trace.append([f"{name} out", gib()])
            return out
        return hook

    names = ("expand_materialize_counted", "intersect_range_count")
    inner = {n: getattr(hopper, n) for n in names}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = round(torch.cuda.memory_allocated() / 2**30, 3)
    for n in names:
        setattr(hopper, n, hooked(n, inner[n]))
    try:
        rows = [dict(r) for r in pg.cypher(query).records.collect()]
    finally:
        for n in names:
            setattr(hopper, n, inner[n])
    S.check(rows_ok(rows), f"{query!r} (peak trace) gave other rows")
    trace.append(["end", gib()])
    return base, trace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE_ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--intersect-only", action="store_true",
                    help="time only the intersect calls and Q22 and Q23 warm")
    ap.add_argument("--join-only", action="store_true",
                    help="time only the join_probe calls and Q11 warm")
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
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX
    from tpu_cypher_torch.backend.cuda.hopper import frontier as KF
    from tpu_cypher_torch.backend.cuda.hopper import intersect as KI
    from tpu_cypher_torch.backend.cuda.hopper import join as KJ
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

    if not args.join_only:
        tri10 = S.triangle_truth(ids10, src10, dst10, False)
        q6_truth = {"triangles": tri10["triangles"]}
        q22_truth = {"t": int(tri10["close_rows"].sum())}

    only = args.intersect_only or args.join_only
    if not only:
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
            row = lambda: KA._segment_aggregate_cuda(  # noqa: E731
                vals, None, seg32, "min", "i64", 1)
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

        # the expand tier at Q5's second hop
        gi1 = GraphIndex.of(g1._graph)
        gi1.node_ids(ctx)
        rp1, ci1, eo1 = gi1.csr(("KNOWS",), False, ctx)
        pos1 = torch.arange(gi1.num_nodes, dtype=torch.int64, device=dev)
        deg1, t1 = J.expand_degrees_total(rp1, pos1, torch.ones_like(pos1, dtype=torch.bool))
        _, nbr1, _, _ = J.expand_materialize_counted(rp1, ci1, eo1, pos1, deg1, int(t1), int(t1))
        pos2 = nbr1.contiguous()
        deg2, t2 = J.expand_degrees_total(rp1, pos2, torch.ones_like(pos2, dtype=torch.bool))
        q5_args = (rp1, ci1, eo1, pos2, deg2, int(t2), int(t2))
        q5_tier = lambda: KX.expand_materialize_counted_cuda(*q5_args)  # noqa: E731
        same(q5_tier(), J.expand_materialize_counted(*q5_args), "expand tier at Q5")
        res["expand_q5_tier_ms"] = S.time_ms(torch, q5_tier)

        # the expand tier at Q6 arm 0, on the count tier's own arguments; Q6's
        # first run on the graph (the hooked one) builds its reverse CSR
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        q6_args, q6_kwargs = S.q6_expand_calls(g10, q6_truth["triangles"])[0]
        torch.cuda.synchronize()
        res["q6_first_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        q6_plain = {k: v for k, v in q6_kwargs.items() if k == "with_orig"}
        res["expand_q6_call"] = ("without orig" if q6_plain.get("with_orig") is False
                                 else "with orig")
        q6_tier = expand_tier(KX, q6_args, q6_kwargs)
        same(q6_tier(), J.expand_materialize_counted(*q6_args, q6_kwargs["size"], **q6_plain),
             "expand tier at Q6 arm 0")
        res["expand_q6_tier_ms"] = S.time_ms(torch, q6_tier, iters=10)
        del q6_args, q6_kwargs, q6_tier

    # intersect at Q6 arm 0, Q22's first probe and Q23's probe, on the
    # gate calls' own inputs
    from tpu_cypher_torch.backend.cuda import hopper

    if not args.join_only:
        probes = {"q6": S.q6_range_count_calls(torch, g10, q6_truth["triangles"])[0]}
        calls, rows = S.q_hooked_calls(g10, S.Q22, hopper, "intersect_range_count")
        S.check(rows == [q22_truth] and len(calls) == 2, f"Q22 (hooked) gave {rows}")
        probes["q22"] = calls[0][0]
        with S.wcoj_mode("off"):
            calls, rows = S.q_hooked_calls(g10, S.Q23, hopper, "intersect_range_count")
        S.check(rows == [q6_truth] and len(calls) == 1, f"Q23 (hooked) gave {rows}")
        probes["q23"] = calls[0][0]
        del calls
        for key, (keys, q, qvalid) in probes.items():
            call = lambda: KI.range_count_cuda(keys, q, qvalid)  # noqa: E731
            same(call(), KI.range_count_plain(keys, q, qvalid)[:2], f"intersect at {key}")
            res[f"intersect_{key}_ms"] = S.time_ms(torch, call, iters=10)
        del probes, keys, q, qvalid

    # join_probe at Q11's own inputs, through the kernel tier only
    q11_truth = {"n": int(np.bincount(bday10, minlength=18_000)[bday10[d10]].sum())}
    if not args.intersect_only:
        rd_s, order, ld, lvalids, nvalid, is_f64, is_bool = S.q11_join_probe_calls(
            g10, q11_truth["n"])
        join_tier = lambda: KJ._join_probe_kernel_tier(  # noqa: E731
            rd_s, order, ld, lvalids, nvalid, is_f64)
        same(join_tier(), J.join_probe(rd_s, order, ld, lvalids, nvalid, is_f64=is_f64,
                                       is_bool=is_bool), "join_probe tier at Q11")
        res["join_tier_ms"] = S.time_ms(torch, join_tier)
        iters = 50
        events = S.device_events(torch, join_tier, iters=iters)
        S.check(bool(events), "the profiler saw no device activity of the join tier")

        def per_call(keep):
            return sum(us for k, (_, us) in events.items() if keep(k)) / 1e3 / iters

        res["join_build_ms"] = per_call(lambda k: "hash_build" in k or "Memset" in k)
        res["join_probe_ms"] = per_call(lambda k: "hash_probe" in k)
        res["join_tier_device_ms"] = per_call(lambda k: True)
        res["join_tier_device_ops"] = sum(n for n, _ in events.values()) / iters
        res["join_tier_device_by_name"] = {
            k: [n / iters, us / 1e3 / iters] for k, (n, us) in events.items()}

    # Q3, Q5 and Q6 warm, then Q22 and Q23
    def warm(key, pg, q, want):
        times = []
        for i in range(args.runs + 1):
            if i == 1:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rows = [dict(r) for r in pg.cypher(q).records.collect()]
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            S.check(rows == [want], f"{key} {rows} != {want}")
        res[f"{key}_warm_ms"] = statistics.median(times)
        res[f"{key}_warm_min_max_ms"] = [min(times), max(times)]

    if not only:
        for key, pg, q, want in (("q3", g10, S.Q3, q3_truth), ("q5", g1, S.Q5, q5_truth),
                                 ("q6", g10, S.Q6, q6_truth)):
            warm(key, pg, q, want)
        res["q6_warm_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["q6_base_gib"], res["q6_peak_trace"] = peak_trace(
            S, torch, g10, S.Q6, lambda rows: rows == [q6_truth])
    if not args.join_only:
        warm("q22", g10, S.Q22, q22_truth)
        with S.wcoj_mode("off"):
            warm("q23", g10, S.Q23, q6_truth)
    if not args.intersect_only:
        warm("q11", g10, S.Q11, q11_truth)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
