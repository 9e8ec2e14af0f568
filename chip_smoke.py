#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of tpu-cypher on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero and prints no result line):

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` and checks
            that CUDA is available;
2. build  — builds every kernel source in ``tpu_cypher_torch/csrc`` with
            ``nvcc`` (all in parallel) and prints each build's ``ptxas``
            resource line;
3. kernels — calls each kernel's wrapper on the card at the shapes the
            slice's queries give it, holds the result against the kernel's
            plain PyTorch version on the same inputs (tolerance: exact —
            every output is integral, and float64 outputs are compared bit
            for bit), and times kernel, plain version and one PyTorch
            library call with CUDA events;
4. slice  — runs the five slice queries through ``CypherSession.cuda()``
            on the LDBC-SNB-shaped graphs (SF1: 10,000 persons, SF10:
            100,000 persons, seed 42), checks every answer against numpy
            ground truth computed from the generator's arrays, and checks
            that each query ran on the device rung once with no kernel
            fallback, and launched its kernels on the ``kernel`` tier.
            Phase 4 runs on graphs generated anew after phase 3, so each
            graph's first query builds its CSR inside its cold time; each
            cold run's time is split by the query's own trace phases.

The kernel launch counts are zeroed just before phase 4 and read just after
it; the comparisons of phase 3 do not count. The line before the last is
the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: the device-memory rate (NVIDIA's data sheet), and the int32
# instruction rate: 132 SMs x 64 int32 lanes x the 1.98 GHz boost clock
# (the Hopper white paper). The data sheet's 67 TFLOP/s fp32 is the same
# 132 SMs x 128 fp32 lanes x 1.98 GHz with an FMA counted as two
# operations. Both rates assume the full 700 W power limit.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

SEED = 42
Q1 = "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id AS a, b.id AS b"
Q2 = "MATCH (a:Person)-[:KNOWS]->(b) RETURN count(*) AS c"
Q3 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) "
    "RETURN min(b.birthday) AS lo, max(a.birthday) AS hi"
)
# the north-star 2-hop count (bench.py TWO_HOP)
Q4 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "RETURN count(*) AS c"
)
Q5 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "RETURN min(c.birthday) AS lo, max(c.birthday) AS hi"
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    check(out.returncode == 0 and lines, f"nvidia-smi failed: {out.stderr.strip()}")
    return lines[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, int_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    """Exact comparison: 0.0 when equal (float64 bit for bit, valid masks
    and dtypes included), else the largest absolute difference (inf when
    the shapes, dtypes or non-finite payloads differ)."""
    if a is None or b is None:
        return 0.0 if a is None and b is None else float("inf")
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.float64:
        if torch.equal(a.view(torch.int64), b.view(torch.int64)):
            return 0.0
        diff = (a - b).abs()
        return float("inf") if not torch.isfinite(diff).all() else float(diff.max())
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def tuple_err(torch, xs, ys) -> float:
    return max(max_abs_err(torch, x, y) for x, y in zip(xs, ys))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def backend_device():
    from tpu_cypher_torch.backend.cuda import device

    return device.get()


def graph_arrays(pg):
    """Host arrays of a generated graph: ids, birthday, src, dst."""
    node = [et for et in pg._graph.scans if et.is_node][0].table
    rel = [et for et in pg._graph.scans if not et.is_node][0].table
    return (
        node._cols["id"]._np_cache,
        node._cols["birthday"]._np_cache,
        rel._cols["source"]._np_cache,
        rel._cols["target"]._np_cache,
    )


def check_expand_rows(torch, session, g1, g10, report):
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.bucketing import round_up_pow2
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX

    ctx = session._runtime_context({})
    dev = backend_device()
    err = 0.0
    cases = []

    def csr(pg):
        gi = GraphIndex.of(pg._graph)
        gi.node_ids(ctx)
        return gi, gi.csr(("KNOWS",), False, ctx)

    def compare(label, rp, ci, eo, pos, present, size=None):
        nonlocal err
        deg, t_dev = J.expand_degrees_total(rp, pos, present)
        total = int(t_dev)
        size = total if size is None else size
        got = KX.expand_materialize_counted_cuda(rp, ci, eo, pos, deg, total, size)
        want = J.expand_materialize_counted(rp, ci, eo, pos, deg, total, size)
        torch.cuda.synchronize()
        e = tuple_err(torch, got, want)
        err = max(err, e)
        print(f"  expand_rows {label}: F={int(pos.shape[0])} lanes={size} "
              f"live={total} max_abs_err={e}")
        check(e == 0.0, f"expand_rows {label} disagrees with its plain version")
        return deg, total

    # Q3's hop at SF10: the whole Person scan as frontier
    gi10, (rp, ci, eo) = csr(g10)
    v10 = gi10.num_nodes
    pos = torch.arange(v10, dtype=torch.int64, device=dev)
    present = torch.ones(v10, dtype=torch.bool, device=dev)
    deg, total = compare("SF10 hop", rp, ci, eo, pos, present)
    cases.append(("SF10 hop (Q3)", rp, pos, deg, total))
    # the same frontier on a bucket-padded lane count (pad lanes clamp)
    compare("SF10 hop, pow2-padded", rp, ci, eo, pos, present,
            size=round_up_pow2(total))
    # Q5's second hop at SF1: the first hop's far ends as frontier
    gi1, (rp1, ci1, eo1) = csr(g1)
    v1 = gi1.num_nodes
    pos1 = torch.arange(v1, dtype=torch.int64, device=dev)
    pres1 = torch.ones(v1, dtype=torch.bool, device=dev)
    deg1, t1 = J.expand_degrees_total(rp1, pos1, pres1)
    _, nbr1, _, _ = J.expand_materialize_counted(rp1, ci1, eo1, pos1, deg1, int(t1), int(t1))
    pos2 = nbr1.contiguous()
    pres2 = torch.ones(pos2.shape[0], dtype=torch.bool, device=dev)
    deg2, total2 = compare("SF1 second hop", rp1, ci1, eo1, pos2, pres2)
    cases.append(("SF1 second hop (Q5)", rp1, pos2, deg2, total2))
    # an empty frontier and an all-absent one (every lane a pad lane)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    compare("empty frontier", rp1, ci1, eo1, empty, empty.bool())
    compare("all-absent frontier", rp1, ci1, eo1, pos1,
            torch.zeros(v1, dtype=torch.bool, device=dev), size=1024)

    # timing at Q5's second hop: the kernel (row search), its plain
    # version (the repeat cascade) and torch.searchsorted over the lanes
    label, rp_t, pos_t, deg_t, size = cases[-1]
    cum, starts = KX.frontier_state(rp_t, pos_t, deg_t)
    lanes = torch.arange(size, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: KX.expand_rows_cuda(cum, starts, size))
    plain_ms = time_ms(torch, lambda: J._expand_rows(starts, deg_t, size))
    lib_ms = time_ms(torch, lambda: torch.searchsorted(cum, lanes, right=True))
    f = int(pos_t.shape[0])
    nbytes = 4 * (f + 1) + 4 * f + 8 * size
    # int32 operations per lane, counted from expand_rows.cu: each step of
    # the row search is 6 (the midpoint's subtract, shift and add, the
    # compare, the lo/hi update and the loop test), and a search over F + 1
    # stops takes at least floor(log2(F + 1)) steps; the row clamp and the
    # edge arithmetic add 6 more
    ops = size * (6 * ((f + 1).bit_length() - 1) + 6)
    b_ms, b_by = bound(nbytes, ops)
    report["expand_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.searchsorted",
        shape=f"{label}: F={f}, lanes={size}",
    )
    print(f"  expand_rows timing at {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")


def check_frontier(torch, session, g10, report):
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import frontier as KF

    ctx = session._runtime_context({})
    dev = backend_device()
    gi = GraphIndex.of(g10._graph)
    gi.node_ids(ctx)
    rp, _, _ = gi.csr(("KNOWS",), False, ctx)
    v = gi.num_nodes
    pos = torch.arange(v, dtype=torch.int64, device=dev)
    present = torch.ones(v, dtype=torch.bool, device=dev)
    err = 0.0
    for label, p, pr in (
        ("F=100,000 (Q2)", pos, present),
        ("all masked", pos, torch.zeros(v, dtype=torch.bool, device=dev)),
        ("single row", pos[v // 2: v // 2 + 1], present[:1]),
    ):
        got = KF.deg_sum_cuda(rp, p, pr)
        want = KF.deg_sum_plain(rp, p, pr)
        e = max_abs_err(torch, got, want)
        err = max(err, e)
        print(f"  frontier_deg_sum {label}: {int(got)} vs plain {int(want)} "
              f"max_abs_err={e}")
        check(e == 0.0, f"frontier_deg_sum {label} disagrees with its plain version")
    deg_node = (rp[1:] - rp[:-1]).to(torch.int64)
    ms = time_ms(torch, lambda: KF.deg_sum_cuda(rp, pos, present), iters=100)
    plain_ms = time_ms(torch, lambda: KF.deg_sum_plain(rp, pos, present), iters=100)
    lib_ms = time_ms(torch, lambda: torch.sum(deg_node[pos]), iters=100)
    f = int(pos.shape[0])
    nbytes = 8 * f + f + 4 * min(v + 1, 2 * f) + 8
    # per row: the degree's subtract, the mask select and the add
    b_ms, b_by = bound(nbytes, 3 * f)
    report["frontier_deg_sum"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.sum over a gather",
        shape=f"Q2 at SF10: F={f}",
    )
    print(f"  frontier_deg_sum timing at F={f}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.sum over a gather {lib_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}; two launches dominate)")


def check_segment_agg(torch, q5_rows, report):
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA

    dev = backend_device()
    rng = np.random.default_rng(SEED)
    err = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for n, k in ((q5_rows, 1), (1_000_000, 256)):
        seg = t(rng.integers(0, k, size=n, dtype=np.int64))
        valid = t(rng.random(n) < 0.9)
        i64 = rng.integers(-(2**62), 2**62, size=n, dtype=np.int64)
        i64[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1]
        f64 = rng.normal(size=n) * 1e3
        f64[rng.random(n) < 0.001] = np.nan
        f64[rng.random(n) < 0.01] = 0.0
        f64[rng.random(n) < 0.01] = -0.0
        f64[:4] = [np.inf, -np.inf, -0.0, 0.0]
        columns = {
            "i64": (t(i64), ("count", "sum", "min", "max")),
            "bool": (t(rng.random(n) < 0.5), ("min", "max")),
            "str": (t(rng.integers(0, 5000, size=n).astype(np.int32)), ("min", "max")),
            "f64": (t(f64), ("min", "max")),
        }
        # at the slice's size the plain version's scatter atomics all hit
        # one slot, so only the masked variant runs there
        masks = (valid,) if k == 1 else (None, valid)
        for kind, (data, names) in columns.items():
            for name in names:
                for vmask in masks:
                    got = KA._segment_aggregate_cuda(data, vmask, seg, name, kind, k)
                    want = J.segment_aggregate(data, vmask, None, seg, name, kind, k)
                    e = tuple_err(torch, got, want)
                    err = max(err, e)
                    check(e == 0.0, f"segment_agg {name}({kind}) n={n} k={k} "
                          f"valid={vmask is not None} disagrees: {got} vs {want}")
        print(f"  segment_agg n={n} k={k}: count/sum/min/max over int64, BOOL, "
              f"string codes, float64 with NaN and +-0: max_abs_err={err}")
    # the -0.0 vs 0.0 tie on its own: min -> -0.0, max -> 0.0
    for order in ([0.0, -0.0], [-0.0, 0.0]):
        vals = torch.tensor(order * 1000, dtype=torch.float64, device=dev)
        seg = torch.zeros(vals.shape[0], dtype=torch.int64, device=dev)
        for name, sign in (("min", True), ("max", False)):
            got = KA._segment_aggregate_cuda(vals, None, seg, name, "f64", 1)[0]
            want = J.segment_aggregate(vals, None, None, seg, name, "f64", 1)[0]
            check(bool(torch.signbit(got)[0]) == sign
                  and max_abs_err(torch, got, want) == 0.0,
                  f"segment_agg {name} breaks the -0.0/0.0 tie wrongly")
    print("  segment_agg -0.0 vs 0.0 tie: min -> -0.0, max -> 0.0 (kernel == plain)")
    # timing at Q5's aggregate: one min pass over int64 values, k = 1
    vals = t(rng.integers(0, 18_000, size=q5_rows, dtype=np.int64))
    seg64 = torch.zeros(q5_rows, dtype=torch.int64, device=dev)
    seg32 = seg64.to(torch.int32)
    big = torch.iinfo(torch.int64).max
    ms = time_ms(torch, lambda: KA.seg_reduce_cuda(vals, seg32, big, "min", 1))
    plain_ms = time_ms(torch, lambda: J._segment_reduce(vals, seg32, 1, "min", big),
                       iters=3, warmup=1)
    # at k = 1 with no dead lane one torch.amin computes the same function;
    # scatter_reduce, the general segment call, is timed beside it
    lib_ms = time_ms(torch, lambda: torch.amin(vals).reshape(1))
    check(int(torch.amin(vals)) == int(KA.seg_reduce_cuda(vals, seg32, big, "min", 1)[0]),
          "segment_agg disagrees with torch.amin at k=1")
    scatter_ms = time_ms(
        torch, lambda: torch.full((1,), big, dtype=torch.int64, device=dev)
        .scatter_reduce(0, seg64, vals, "amin", include_self=True),
        iters=3, warmup=1)
    nbytes = 12 * q5_rows + 8
    # per row: the min and the segment-id check
    b_ms, b_by = bound(nbytes, 2 * q5_rows)
    report["segment_agg"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.amin",
        scatter_reduce_ms=scatter_ms,
        shape=f"Q5 aggregate at SF1: n={q5_rows}, k=1, int64 min",
    )
    print(f"  segment_agg timing at n={q5_rows}, k=1: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.amin {lib_ms:.4f} ms, Tensor.scatter_reduce "
          f"{scatter_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


# ---------------------------------------------------------------------------
# phase 4: the slice through CypherSession.cuda()
# ---------------------------------------------------------------------------


def run_query(torch, pg, query, kernels):
    """Run one query twice (cold, warm) and check the device-only contract
    on both runs. Returns (records rows of the warm run, seconds list,
    per-kernel kernel-tier launches, materialized lanes, the cold run's
    result)."""
    from tpu_cypher_torch.backend.cuda import bucketing
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    secs = []
    out_rows = None
    launches = {}
    lanes = None
    results = []
    for attempt in ("cold", "warm"):
        before = dispatch.use_counts()
        rows0 = bucketing._ROWS_TRUE.value()
        t0 = time.perf_counter()
        result = pg.cypher(query)
        recs = result.records
        table = recs.table
        for col in table._cols.values():
            check(col.kind == "obj" or col.data.device == backend_device(),
                  f"result column not on the card: {query}")
        rows = list(recs.collect())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = dispatch.use_counts()
        log = result.execution_log
        check(len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"],
              f"not one device rung: {log}")
        check("CsrExpandOp" in result.plans, "plan has no CsrExpandOp")
        for name in after:
            d = {t: after[name][t] - before[name][t] for t in after[name]}
            check(d["fallback"] == 0 and d["plain"] == 0,
                  f"{name} left the kernel tier: {d}")
            launches[name] = launches.get(name, 0) + d["kernel"]
        for name in kernels:
            check(after[name]["kernel"] > before[name]["kernel"],
                  f"{name} not launched by {query}")
        lanes = int(bucketing._ROWS_TRUE.value() - rows0)
        out_rows = rows
        results.append(result)
    return out_rows, secs, launches, lanes, results[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import tpu_cypher_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a tpu-cypher checkout ({exc})",
              file=sys.stderr)
        return 2
    import numpy as np

    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.backend.cuda.hopper import _build, dispatch
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    t_start = time.perf_counter()
    # 1. card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel sources in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.nvcc_path()})")
    for name in sorted(built):
        log = _build.build_log(name) or ""
        usage = [l.strip() for l in log.splitlines() if "registers" in l]
        print(f"  {name}: {built[name]:.2f} s; " + (" | ".join(usage) or "(cached)"))

    session = CypherSession.cuda()
    print(f"backend device: {backend_device()}")

    def graphs():
        t0 = time.perf_counter()
        a = PropertyGraph(session, generate_snb(1.0, session, seed=SEED))
        b = PropertyGraph(session, generate_snb(10.0, session, seed=SEED))
        torch.cuda.synchronize()
        print(f"graphs: SF1 and SF10 generated and ingested in "
              f"{time.perf_counter() - t0:.2f} s")
        return a, b

    g1, g10 = graphs()

    ids1, bday1, src1, dst1 = graph_arrays(g1)
    ids10, bday10, src10, dst10 = graph_arrays(g10)

    def idx(ids, x):
        return np.searchsorted(ids, x)  # ids are generated sorted

    s1, d1 = idx(ids1, src1), idx(ids1, dst1)
    s10, d10 = idx(ids10, src10), idx(ids10, dst10)
    out1 = np.bincount(s1, minlength=len(ids1))
    in1 = np.bincount(d1, minlength=len(ids1))
    out10 = np.bincount(s10, minlength=len(ids10))
    truth = {
        "Q1_pairs": np.sort(src1 * (1 << 32) + dst1),
        "Q2": int(len(src10)),
        "Q3": (int(bday10[d10].min()), int(bday10[s10].max())),
        "Q4": int(out10[d10].sum()),
        "Q5_rows": int(out1[d1].sum()),
        "Q5": (int(bday1[d1[in1[s1] > 0]].min()), int(bday1[d1[in1[s1] > 0]].max())),
    }
    print(f"truth: SF1 {len(ids1)} persons / {len(src1)} KNOWS; SF10 "
          f"{len(ids10)} persons / {len(src10)} KNOWS; Q4 2-hop paths "
          f"{truth['Q4']}; Q5 second-hop rows {truth['Q5_rows']}")

    # 3. kernels against their plain versions
    report = {}
    print("kernels vs plain (exact):")
    check_expand_rows(torch, session, g1, g10, report)
    check_frontier(torch, session, g10, report)
    check_segment_agg(torch, truth["Q5_rows"], report)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # 4. the slice, on graphs phase 3 has not touched (no CSR built yet)
    print("slice through CypherSession.cuda():")
    arrays3 = (graph_arrays(g1), graph_arrays(g10))
    del g1, g10
    torch.cuda.empty_cache()
    g1, g10 = graphs()
    check(all(np.array_equal(x, y)
              for old, new in zip(arrays3, (graph_arrays(g1), graph_arrays(g10)))
              for x, y in zip(old, new)),
          "the generator gave other arrays from the same seed")
    dispatch.reset()
    slice_launches = {}
    cold = {}

    def run(label, pg, q, kernels):
        rows, secs, launches, lanes, first = run_query(torch, pg, q, kernels)
        for k, v in launches.items():
            slice_launches[k] = slice_launches.get(k, 0) + v
        phases = {k: round(v, 4) for k, v in first.profile().phase_seconds().items()}
        cold[label] = first
        print(f"  {label}: cold {secs[0]:.3f} s, warm {secs[1]:.3f} s; kernel "
              f"launches {launches}; materialized lanes per run {lanes}")
        print(f"    cold run's trace phases (s): {phases}")
        return rows, secs, lanes

    rows, _, _ = run("Q1 (SF1)", g1, Q1, ("expand_rows",))
    got = np.sort(np.array([r["a"] * (1 << 32) + r["b"] for r in rows], np.int64))
    check(np.array_equal(got, truth["Q1_pairs"]), "Q1 pair bag differs from numpy")
    print(f"    Q1 = {len(rows)} (a, b) pairs, bag-identical to numpy")
    rows, _, _ = run("Q2 (SF10)", g10, Q2, ("frontier_deg_sum",))
    check([dict(r) for r in rows] == [{"c": truth["Q2"]}], f"Q2 {rows} != {truth['Q2']}")
    print(f"    Q2 = {rows[0]['c']}")
    rows, _, _ = run("Q3 (SF10)", g10, Q3, ("expand_rows", "segment_agg"))
    check((rows[0]["lo"], rows[0]["hi"]) == truth["Q3"], f"Q3 {rows} != {truth['Q3']}")
    print(f"    Q3 = {rows[0]}")
    rows, secs, _ = run("Q4 (SF10)", g10, Q4, ())
    check([dict(r) for r in rows] == [{"c": truth["Q4"]}], f"Q4 {rows} != {truth['Q4']}")
    expansions = len(src10) + truth["Q4"]
    print(f"    Q4 = {rows[0]['c']}; {expansions} edge expansions, "
          f"{expansions / secs[1]:.1f} expansions/s warm "
          f"({expansions / secs[0]:.1f} cold)")
    rows, _, lanes = run("Q5 (SF1)", g1, Q5, ("expand_rows", "segment_agg"))
    check((rows[0]["lo"], rows[0]["hi"]) == truth["Q5"], f"Q5 {rows} != {truth['Q5']}")
    check(lanes == len(src1) + truth["Q5_rows"],
          f"Q5 materialized {lanes} lanes, expected {len(src1) + truth['Q5_rows']}")
    print(f"    Q5 = {rows[0]} over {truth['Q5_rows']} second-hop rows")
    print("  Q4's cold run, its trace tree (wall ms per span):")
    for line in cold["Q4 (SF10)"].profile().render().splitlines():
        print(f"    {line}")
    counts = dispatch.use_counts()
    for name, c in counts.items():
        check(c["fallback"] == 0 and c["plain"] == 0, f"{name} fallbacks: {c}")
        check(c["kernel"] == slice_launches.get(name, 0) and c["kernel"] > 0,
              f"{name} launch count {c} vs {slice_launches}")
    print(f"slice launches (kernel tier, cold + warm runs): "
          f"{ {n: c['kernel'] for n, c in counts.items()} }")

    specs = dispatch.registry()
    kernels = []
    for name in ("expand_rows", "frontier_deg_sum", "segment_agg"):
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": specs[name].source,
            "replaces": specs[name].replaces,
            "launches": counts[name]["kernel"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "shape": r["shape"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)  # the nvidia-smi line as it came: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
