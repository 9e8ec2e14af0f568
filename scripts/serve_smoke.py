#!/usr/bin/env python3
"""Phase 6 of ``chip_smoke.py``: the serving tier (``tpu_cypher_torch/serve/``)
on one CUDA card.

    python3 chip_smoke.py                     # every phase; phase 6 comes from here
    python3 scripts/serve_smoke.py            # phases 1, 2 and 6 alone, on the card
    python3 scripts/serve_smoke.py --device cpu --big 0.1 --small 0.05 --cluster-persons 200
                                              # a rehearsal on the host at small sizes

It drives the serving tier through the entry points a deployment uses and
checks every answer:

1. **The in-process server at full width.** A ``QueryServer`` on
   ``CypherSession.cuda()`` with SF10 (``generate_snb(10.0)``, seed 42,
   generated anew, so the first queries race to build its CSR) and SF1
   mounted, on port 0; 16 TCP clients, each closed-loop over a fixed mix
   of five kinds: the 2-hop count over a 50-source id window
   (``$lo``/``$hi``), IS3 for a person id, the top 20 persons by
   out-degree, the triangle count at SF1, and a ``*1..2`` walk count over
   a window. Result cache and batching are off, so every query runs. Each
   answer is held to numpy/scipy truth and to the same query run serially;
   the pool's lanes must have run concurrently on distinct CUDA streams,
   and the kernels' scratch must show launches on at least two of them.
2. **Batching, caching, streaming, admission** (a second server, cache and
   a 50 ms window on): a burst of 8 identical submits is one dispatch; a
   repeat read is a cache hit with no kernel launch; a streamed cursor over
   SF1's 449,972 single-hop rows equals the eager rows and numpy, decoded
   chunk by chunk (``CudaTable.rows_chunked``, no whole-column decode);
   a query over a device-memory budget is rejected typed.
3. **Writes.** A ``MutableGraph`` of SF1 (10,000 persons, 449,972 KNOWS)
   with a WAL in a temporary directory, served to 8 clients, one op in ten
   a write (a MATCH...CREATE, a SET, a DETACH DELETE), each read back right
   after its acknowledgement; a compaction happens during the run; after
   it every acknowledged write reads back, the final reads equal numpy
   truth, and the store equals a rebuild from its committed writes (the
   seed elements, then the WAL).
4. **The cluster.** A ``ClusterServer`` of 2 worker processes on the card
   over a mutable CREATE graph of ``--cluster-persons`` persons (its parse
   time recorded); acknowledged writes, then reads from 4 clients while
   the writer worker is SIGKILLed: every read is retried on the replica and
   exact; after the restart and WAL replay both workers read every
   acknowledged write back. Each worker's peak device memory comes from
   its ``ping``.

Kernel launches are counted over served traffic only: the counters are
zeroed just before each served block of steps 1-3 (the clients' run
against the server) and read just after it, before any serial, eager or
rebuild work, and the phase's count is the sum of those reads (the
cluster's workers launch in their own processes). Times are host-clock
seconds around TCP round trips, stated as such. It prints the
``nvidia-smi`` name and power limit line beside the numbers.

``--lanes-ab`` runs step 1's mix alone at 8 lanes and at 1 (8, 1, 1, 8),
then once more at each with the serving threads' Python stacks sampled,
and prints where a lane's time goes: queries/s, latency, process CPU
seconds per wall second, a lane's wall and CPU time per query, idle
shares and the hottest frames (the whole profile goes to
``chiprun_out/serve_profile_lanes<N>.txt``).
"""

import argparse
import asyncio
import importlib.util
import json
import os
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WINDOW = "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
TWO_HOP_WINDOW = (WINDOW + "MATCH (a)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
                  "RETURN count(*) AS c")
VAR12_WINDOW = WINDOW + "MATCH (a)-[:KNOWS*1..2]->(b:Person) RETURN count(*) AS walks"
WINDOW_SOURCES = 50
CLIENTS = 16
ROUNDS = 6  # per client, over the five kinds: 480 queries
KINDS = ("2hop", "IS3", "top20", "triangles", "var12")

# the write phase
WRITE_CLIENTS = 8
WRITE_OPS = 20  # per client; ops 3 and 13 are writes, each read back next
PERSONS_MUT = "MATCH (n:Person) RETURN count(*) AS c"
HOPS_MUT = "MATCH (a:Person)-[:KNOWS]->(b) RETURN count(*) AS c"
AGG_MUT = ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
           "RETURN min(b.birthday) AS lo, max(b.birthday) AS hi")
JOIN_MUT = ("MATCH (a:Person {id: $id}), (b:Person) WHERE a.birthday = b.birthday "
            "RETURN count(*) AS n")
CREATE_MUT = ("MATCH (b:Person {id: $b}) "
              "CREATE (:Person {id: $id, birthday: $bd})-[:KNOWS]->(b)")
SET_MUT = "MATCH (n:Person {id: $id}) SET n.birthday = $bd"
DELETE_MUT = "MATCH (n:Person {id: $id}) DETACH DELETE n"
READ_CREATED = "MATCH (a:Person {id: $id})-[:KNOWS]->(b:Person) RETURN b.id AS b"
READ_SET = "MATCH (n:Person {id: $id}) RETURN n.birthday AS bd"
READ_DELETED = "MATCH (n:Person {id: $id}) RETURN count(*) AS c"
# the write phase's targets, as fractions of the person count: MATCH...CREATE
# links new persons to persons from 0.9 n, SET rewrites from 0.8 n, DETACH
# DELETE removes from 0.7 n, IS3 reads from 0.5 n, and the value join
# matches the birthday of the person at 0.4321 n
CREATE_AT, SET_AT, DELETE_AT, IS3_AT, JOIN_AT = 0.9, 0.8, 0.7, 0.5, 0.4321


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


async def _ask(reader, writer, qid, query, graph, params=None, **extra):
    """One submit on an open connection; (terminal message, rows)."""
    msg = {"op": "submit", "id": qid, "graph": graph, "query": query,
           "parameters": params or {}, **extra}
    writer.write((json.dumps(msg) + "\n").encode())
    await writer.drain()
    rows = []
    while True:
        m = json.loads(await asyncio.wait_for(reader.readline(), 600))
        if m.get("type") == "rows" and m.get("id") == qid:
            rows.extend(m["rows"])
        elif m.get("type") in ("done", "error", "cancelled") and m.get("id") == qid:
            return m, rows


def _plain(rows):
    return [dict(r) for r in rows]


PACKAGE = os.sep + "tpu_cypher_torch" + os.sep


def _short(path):
    """A source path as ``tpu_cypher_torch/...`` or ``<dir>/<file>``."""
    if PACKAGE in path:
        return "tpu_cypher_torch" + os.sep + path.split(PACKAGE, 1)[1]
    return os.path.join(os.path.basename(os.path.dirname(path)), os.path.basename(path))


class StackSampler:
    """Samples the Python stacks of the serving threads every ``interval``
    seconds (``sys._current_frames``) on a thread of its own. Per group
    (the pool's lanes, the event loop's thread): the share of samples
    idle (a lane waiting for a query in ``_worker``, the loop waiting in
    its selector), at each innermost frame, and in each function anywhere
    on the stack. A frame is where the thread's Python code stands, which
    includes a C call under it (a stream synchronize, a lock wait) and a
    wait for the GIL."""

    IDLE = {"lanes": ("thread.py", "_worker"), "loop": ("selectors.py", "select")}

    def __init__(self, interval=0.005):
        self.interval = interval
        self.samples = {g: 0 for g in self.IDLE}
        self.idle = {g: 0 for g in self.IDLE}
        self.leaf = {g: {} for g in self.IDLE}
        self.incl = {g: {} for g in self.IDLE}
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()

    def _run(self):
        main = threading.main_thread().ident
        while not self._stop.wait(self.interval):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == main:
                    group = "loop"
                elif names.get(ident, "").startswith("tpu-cypher-serve"):
                    group = "lanes"
                else:
                    continue
                self.samples[group] += 1
                code = frame.f_code
                where = (os.path.basename(code.co_filename), code.co_name)
                if where == self.IDLE[group]:
                    self.idle[group] += 1
                    continue
                leaf = f"{_short(code.co_filename)}:{frame.f_lineno} {code.co_name}"
                self.leaf[group][leaf] = self.leaf[group].get(leaf, 0) + 1
                seen = set()
                while frame is not None:  # the package's own functions only
                    c = frame.f_code
                    if PACKAGE in c.co_filename:
                        fn = f"{_short(c.co_filename)} {c.co_name}"
                        if fn not in seen:
                            seen.add(fn)
                            self.incl[group][fn] = self.incl[group].get(fn, 0) + 1
                    frame = frame.f_back

    def report(self, top):
        out = []
        for g in self.IDLE:
            n = max(self.samples[g], 1)
            out.append(f"    {g}: {self.samples[g]} samples, idle {self.idle[g] / n:.3f}")
            for title, tab in (("innermost frame", self.leaf[g]),
                               ("anywhere on the stack, the package's functions",
                                self.incl[g])):
                out.append(f"      share of samples, {title}:")
                for k, v in sorted(tab.items(), key=lambda kv: -kv[1])[:top]:
                    out.append(f"        {v / n:.3f} {k}")
        return "\n".join(out) + "\n"


class Phase:
    """Phase 6's state: the chip_smoke module (``cs``) for its truth
    helpers and checks, torch, the session and the printed results."""

    def __init__(self, cs, torch, session, on_card):
        self.cs = cs
        self.torch = torch
        self.session = session
        self.on_card = on_card
        self.check = cs.check
        self.launches = {}  # {kernel: {tier: n}} over the served blocks

    def served(self, block):
        """Run one block of served traffic; its kernel launches, and no
        others, join ``self.launches``."""
        from tpu_cypher_torch.backend.cuda.hopper import dispatch

        dispatch.reset()
        try:
            return block()
        finally:
            for name, tiers in dispatch.use_counts().items():
                mine = self.launches.setdefault(name, {})
                for tier, n in tiers.items():
                    mine[tier] = mine.get(tier, 0) + n
            dispatch.reset()

    @staticmethod
    def say(line):
        print(line, flush=True)

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    # -- 1. the in-process server ------------------------------------------

    def mix_truth(self, big, tri_small):
        """Per kind: [(params, truth rows)], one entry per client, from the
        generator's arrays."""
        import numpy as np

        cs = self.cs
        ids, _, src, dst = cs.graph_arrays(big)
        n = len(ids)
        s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
        w1, w2 = cs.walk_estimates(s, d, n, 2)
        out = {k: [] for k in KINDS}
        outdeg = np.bincount(s, minlength=n)
        top = np.lexsort((ids, -outdeg))[:20]
        top20 = [{"id": int(ids[i]), "deg": int(outdeg[i])} for i in top]
        k = min(WINDOW_SOURCES, n // (2 * CLIENTS))  # 50 unless the graph is small
        for c in range(CLIENTS):
            start = n // 2 + k * c
            params = cs.window_params(ids, start, k)
            win = slice(start, start + k)
            out["2hop"].append((params, [{"c": int(w2[win].sum())}]))
            # the graph is loop-free: every walk of length <= 2 is
            # relationship-unique
            out["var12"].append((params, [{"walks": int(w1[win].sum() + w2[win].sum())}]))
            me = min(n - 1, n // 10 + 37 * c)
            friends = np.concatenate([d[s == me], s[d == me]])
            rows = sorted((int(ids[f]), f"p{f}") for f in friends)
            out["IS3"].append(({"personId": int(ids[me])},
                               [{"friendId": a, "firstName": b} for a, b in rows]))
            out["top20"].append(({}, top20))
            out["triangles"].append(({}, [{"triangles": tri_small}]))
        return out

    def plan(self, truth):
        """Per client: [(kind, graph, query, params, truth rows)], the kinds
        rotated so the clients start on different ones."""
        cs = self.cs
        spec = {"2hop": ("big", TWO_HOP_WINDOW), "IS3": ("big", cs.Q10),
                "top20": ("big", cs.Q14), "triangles": ("small", cs.Q6),
                "var12": ("big", VAR12_WINDOW)}
        plans = []
        for c in range(CLIENTS):
            ops = []
            for r in range(ROUNDS):
                for j in range(len(KINDS)):
                    kind = KINDS[(c + r + j) % len(KINDS)]
                    graph, query = spec[kind]
                    params, rows = truth[kind][(c + r) % CLIENTS]
                    ops.append((kind, graph, query, params, rows))
            plans.append(ops)
        return plans

    async def run_clients(self, server, plans, sampler=None):
        """16 closed-loop clients: the first round (each client's first
        ``len(KINDS)`` queries, cold: they race to build the CSR) to its
        end, then the warm rounds. Per kind the warm and the first-round
        latencies, the answers, the two walls, the process CPU seconds of
        the warm rounds and the time they started. ``sampler`` samples the
        warm rounds' stacks."""
        lat = {k: [] for k in KINDS}
        cold = {k: [] for k in KINDS}
        results = []
        conns = [await asyncio.open_connection(server.host, server.port)
                 for _ in plans]

        async def client(c, ops, first):
            reader, writer = conns[c]
            for i, (kind, graph, query, params, want) in enumerate(ops):
                t0 = time.perf_counter()
                done, rows = await _ask(reader, writer, f"c{c}-{first + i}", query,
                                        graph, params, tenant=f"t{c}")
                dt = time.perf_counter() - t0
                self.check(done["type"] == "done", f"client {c} {kind}: {done}")
                (cold if first == 0 else lat)[kind].append(dt)
                results.append((kind, graph, query, params, want, rows))

        walls = []
        for lo, hi in ((0, len(KINDS)), (len(KINDS), None)):
            warm = lo > 0
            if warm and sampler is not None:
                sampler.start()
            t0, cpu0 = time.perf_counter(), time.process_time()
            await asyncio.gather(*(client(c, ops[lo:hi], lo)
                                   for c, ops in enumerate(plans)))
            walls.append(time.perf_counter() - t0)
            if warm:
                cpu, t_warm = time.process_time() - cpu0, t0
                if sampler is not None:
                    sampler.stop()
        for _, writer in conns:
            writer.close()
        return lat, cold, results, walls, cpu, t_warm

    def mix_run(self, big, small, plans, lanes=None, sampler=None):
        """One served run of the mix on a fresh server of ``lanes`` lanes
        (the default when None), result cache and batching off; every
        answer held to numpy truth. Returns the run's figures."""
        from tpu_cypher_torch.serve import QueryServer

        server = QueryServer(self.session, port=0, batch_window_ms=0, cache_bytes=0,
                             max_concurrent=lanes)
        server.register_graph("big", big)
        server.register_graph("small", small)
        inflight = [0, 0]
        spans = []  # (start, lane wall s, lane thread CPU s) per query
        lock = threading.Lock()
        isolated = server.pool._isolated

        def counted(fn):  # how many lanes ran a query at once, and for how long
            with lock:
                inflight[0] += 1
                inflight[1] = max(inflight[1], inflight[0])
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return isolated(fn)
            finally:
                spans.append((t0, time.perf_counter() - t0, time.thread_time() - c0))
                with lock:
                    inflight[0] -= 1

        server.pool._isolated = counted

        async def go():
            async with server:
                return await self.run_clients(server, plans, sampler)

        lat, cold, results, (cold_wall, wall), cpu, t_warm = self.served(
            lambda: asyncio.run(go()))
        warm = sum(len(v) for v in lat.values())
        total = warm + sum(len(v) for v in cold.values())
        self.check(total == CLIENTS * ROUNDS * len(KINDS), f"served {total} queries")
        for kind, _, _, params, want, rows in results:
            self.check(rows == want, f"{kind} {params}: served {rows[:3]} != truth {want[:3]}")
        warm_spans = [sp for sp in spans if sp[0] >= t_warm]
        return {"server": server, "lat": lat, "cold": cold, "results": results,
                "cold_wall": cold_wall, "wall": wall, "warm": warm, "total": total,
                "cpu": cpu, "inflight": inflight[1],
                "lanes": server.pool._executor._max_workers,
                "lane_wall": sum(sp[1] for sp in warm_spans) / max(len(warm_spans), 1),
                "lane_cpu": sum(sp[2] for sp in warm_spans) / max(len(warm_spans), 1)}

    def serve_mix(self, big, small, tri_small):
        from tpu_cypher_torch.backend.cuda.hopper import _build

        check = self.check
        truth = self.mix_truth(big, tri_small)
        r = self.mix_run(big, small, self.plan(truth))
        server, lat, cold, wall, warm = r["server"], r["lat"], r["cold"], r["wall"], r["warm"]
        # every served answer (held to numpy truth in mix_run): the serial run
        serial, serial_s = {}, {k: [] for k in KINDS}
        for kind, graph, query, params, want, rows in r["results"]:
            key = (query, json.dumps(params, sort_keys=True))
            if key not in serial:
                pg = big if graph == "big" else small
                t0 = time.perf_counter()
                serial[key] = _plain(pg.cypher(query, params).records.collect())
                self.sync()
                serial_s[kind].append(time.perf_counter() - t0)
            check(serial[key] == rows, f"{kind} {params}: serial run differs")
        streams = server.pool.lane_streams()
        check(r["inflight"] > 1, f"the lanes never ran concurrently ({r['inflight']})")
        if self.on_card:
            handles = set(streams.values())
            default = self.torch.cuda.default_stream().cuda_stream
            check(len(handles) == len(streams) > 1 and default not in handles,
                  f"lane streams not distinct: {streams}")
            used = {k[3] for k in _build._SCRATCH if k[0] == "expand_rows"}
            check(len(used & handles) > 1,
                  f"expand_rows launched on lane streams {used & handles} only")
        self.say(f"  serving mix: {CLIENTS} clients, {len(streams)} lanes, up to "
                 f"{r['inflight']} at once, each on its own CUDA stream"
                 + ("" if self.on_card else " (host: no streams)")
                 + f"; first round ({r['total'] - warm} queries, cold) in "
                 f"{r['cold_wall']:.3f} s; then {warm} warm queries in {wall:.3f} s host "
                 f"wall, {warm / wall:.1f} queries/s")
        for kind in KINDS:
            xs = lat[kind]
            self.say(f"    {kind}: {len(xs)} warm queries, {len(xs) / wall:.1f} queries/s "
                     f"of the mix, latency p50 {_percentile(xs, 0.5) * 1e3:.3f} ms, "
                     f"p99 {_percentile(xs, 0.99) * 1e3:.3f} ms (host clock, TCP round "
                     f"trip); first round p50 {statistics.median(cold[kind]) * 1e3:.3f} "
                     f"ms, max {max(cold[kind]) * 1e3:.3f} ms; one at a time in process "
                     f"(warm, no server) p50 {statistics.median(serial_s[kind]) * 1e3:.3f} ms")
        self.say(f"    every answer equal to numpy truth and to the serial run "
                 f"({len(serial)} distinct queries)")
        return truth

    def lanes_ab(self, big, small, tri_small):
        """The mix at 8 lanes and at 1, in turns (8, 1, 1, 8), then one
        sampled run at each: where a lane's time goes."""
        plans = self.plan(self.mix_truth(big, tri_small))
        self.mix_run(big, small, plans, 8)  # the first round builds the CSRs
        for lanes in (8, 1, 1, 8):
            self.say_run(self.mix_run(big, small, plans, lanes), "timed")
        for lanes in (8, 1):
            sampler = StackSampler()
            r = self.mix_run(big, small, plans, lanes, sampler)
            self.say_run(r, "sampled every 5 ms")
            path = os.path.join(ROOT, "chiprun_out", f"serve_profile_lanes{lanes}.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(sampler.report(top=60))
            self.say(sampler.report(top=12))

    def say_run(self, r, how):
        xs = [x for v in r["lat"].values() for x in v]
        self.say(f"  lanes={r['lanes']} ({how}): {r['warm']} warm queries in "
                 f"{r['wall']:.3f} s, {r['warm'] / r['wall']:.1f} queries/s, latency p50 "
                 f"{_percentile(xs, 0.5) * 1e3:.3f} ms p99 {_percentile(xs, 0.99) * 1e3:.3f} "
                 f"ms; up to {r['inflight']} at once; process CPU {r['cpu']:.3f} s "
                 f"({r['cpu'] / r['wall']:.3f} s a wall second); per query a lane's wall "
                 f"{r['lane_wall'] * 1e3:.3f} ms, its thread CPU "
                 f"{r['lane_cpu'] * 1e3:.3f} ms (host clock)")

    # -- 2. batching, caching, streaming, admission ------------------------

    def serve_features(self, big, small, truth, q1_pairs):
        import numpy as np

        from tpu_cypher_torch.backend.cuda import bucketing
        from tpu_cypher_torch.backend.cuda.column import Column
        from tpu_cypher_torch.backend.cuda.hopper import dispatch
        from tpu_cypher_torch.runtime import guard
        from tpu_cypher_torch.serve import QueryServer, estimate_cost_bytes
        from tpu_cypher_torch.serve.batching import DISPATCHES

        cs, check = self.cs, self.check
        top20 = truth["top20"][0][1]
        server = QueryServer(self.session, port=0, batch_window_ms=50)
        server.register_graph("big", big)
        server.register_graph("small", small)
        ranges, whole = [], []
        real_range, real_values = Column.to_values_range, Column.to_values

        def spy_range(col, lo, hi):
            ranges.append(hi - lo)
            return real_range(col, lo, hi)

        def spy_values(col, row_mask=None):
            whole.append(len(col))
            return real_values(col, row_mask)

        cost = estimate_cost_bytes(big, cs.Q14)

        async def go():
            out = {}
            async with server:
                host, port = server.host, server.port
                reader, writer = await asyncio.open_connection(host, port)
                d0 = sum(int(v) for _, v in DISPATCHES.items())
                for i in range(8):
                    writer.write((json.dumps({"op": "submit", "id": f"b{i}", "graph": "big",
                                              "query": cs.Q14}) + "\n").encode())
                await writer.drain()
                dones, rows = {}, {}
                while len(dones) < 8:
                    m = json.loads(await asyncio.wait_for(reader.readline(), 120))
                    if m["type"] == "rows":
                        rows.setdefault(m["id"], []).extend(m["rows"])
                    elif m["type"] in ("done", "error"):
                        dones[m["id"]] = m
                out["burst"] = (dones, rows, sum(int(v) for _, v in DISPATCHES.items()) - d0)
                before = dispatch.use_counts()
                t0 = time.perf_counter()
                done, hit_rows = await _ask(reader, writer, "hit", cs.Q14, "big")
                out["hit"] = (done, hit_rows, time.perf_counter() - t0,
                              dispatch.use_counts() == before)
                bucketing.MEM_BUDGET.set(cost // 2)
                try:
                    done, _ = await _ask(reader, writer, "over", cs.Q14 + " SKIP 1", "big")
                finally:
                    bucketing.MEM_BUDGET.reset()
                out["budget"] = done
                # the cursor over SF1's single-hop rows, acked page by page
                Column.to_values_range, Column.to_values = spy_range, spy_values
                try:
                    writer.write((json.dumps({"op": "submit", "id": "st", "graph": "small",
                                              "query": cs.Q1, "stream": True}) + "\n").encode())
                    await writer.drain()
                    t0 = time.perf_counter()
                    streamed, pages = [], 0
                    while True:
                        m = json.loads(await asyncio.wait_for(reader.readline(), 600))
                        if m["type"] == "rows":
                            streamed.extend(m["rows"])
                            pages += 1
                            writer.write(b'{"op": "next", "id": "st"}\n')
                            await writer.drain()
                        elif m["type"] in ("done", "error"):
                            break
                    out["stream"] = (m, streamed, pages, time.perf_counter() - t0)
                finally:
                    Column.to_values_range, Column.to_values = real_range, real_values
                writer.close()
            return out

        out = self.served(lambda: asyncio.run(go()))
        dones, rows, dispatched = out["burst"]
        check(all(d["type"] == "done" and d["batched"] == 8 for d in dones.values())
              and len({d["batch_leader"] for d in dones.values()}) == 1,
              f"the burst did not share one batch: {list(dones.values())[:2]}")
        check(dispatched == 1, f"the burst took {dispatched} dispatches")
        check(all(r == top20 for r in rows.values()), "a burst answer differs from numpy")
        done, hit_rows, hit_s, no_launch = out["hit"]
        check(done["type"] == "done" and done["cached"] is True and hit_rows == top20,
              f"the repeat read was not a cache hit: {done}")
        check(no_launch, "a cache hit launched a kernel")
        done = out["budget"]
        check(done["type"] == "error" and done["error"] == "AdmissionRejected",
              f"a query over the budget was not rejected typed: {done}")
        m, streamed, pages, stream_s = out["stream"]
        check(m["type"] == "done" and m["streamed"] is True
              and m["total_rows"] == m["rows"] == len(q1_pairs),
              f"the stream ended {m}")
        got = np.sort(np.array([r["a"] * (1 << 32) + r["b"] for r in streamed], np.int64))
        check(np.array_equal(got, q1_pairs), "the streamed rows differ from numpy")
        eager = _plain(small.cypher(self.cs.Q1).records.collect())
        check(eager == streamed, "the streamed rows differ from the eager rows")
        chunk = guard.stream_chunk_rows()
        want_chunks = -(-len(q1_pairs) // chunk)
        check(len(ranges) == 2 * want_chunks and max(ranges) <= chunk,
              f"decode by chunks {len(ranges)} x <= {max(ranges)}, expected "
              f"{2 * want_chunks} x <= {chunk}")
        check(not [w for w in whole if w >= len(q1_pairs)],
              f"a whole-column decode during the stream: {whole}")
        self.say(f"  batching: 8 identical submits, one dispatch, batched = 8; repeat "
                 f"read a cache hit in {hit_s * 1e3:.3f} ms host round trip, no kernel "
                 f"launched; admission: estimate {cost} bytes over a {cost // 2}-byte "
                 f"budget rejected as AdmissionRejected")
        self.say(f"  stream: {len(streamed)} SF1 single-hop rows in {pages} pages, "
                 f"{stream_s:.3f} s host clock with a client ack per page, decoded in "
                 f"{len(ranges) // 2} chunks of at most {chunk} rows a column, equal to "
                 f"the eager rows and numpy")

    # -- 3. writes ----------------------------------------------------------

    def mutable_sf1(self, small, wal_path):
        """A MutableGraph holding SF1's persons and KNOWS (element ids as
        the generator gives them) with a WAL at ``wal_path``; returns
        (property graph, seed nodes, seed relationships)."""
        from tpu_cypher_torch.api.values import Node, Relationship
        from tpu_cypher_torch.relational.session import PropertyGraph
        from tpu_cypher_torch.storage import MutableGraph, WriteAheadLog

        node = [et for et in small._graph.scans if et.is_node][0].table
        rel = [et for et in small._graph.scans if not et.is_node][0].table
        nodes = [Node(int(i), ("Person",), {"id": int(i), "birthday": int(b), "firstname": f})
                 for i, b, f in zip(node.column_values("id"), node.column_values("birthday"),
                                    node.column_values("firstname"))]
        rels = [Relationship(int(i), int(a), int(b), "KNOWS", {})
                for i, a, b in zip(rel.column_values("id"), rel.column_values("source"),
                                   rel.column_values("target"))]
        m = MutableGraph(self.session, nodes, rels, name="sf1")
        m.attach_wal(WriteAheadLog(wal_path))
        return PropertyGraph(self.session, m), nodes, rels

    def write_plan(self, ids):
        """Per client: [(query, params, kind)] — reads, and at ops 3 and 13
        a write followed by its read-back, on targets disjoint per client
        (``CREATE_AT`` and the others)."""
        n = len(ids)

        def at(frac, j=0):
            return int(ids[int(frac * n) + j])

        plans = []
        for c in range(WRITE_CLIENTS):
            ops = []
            for i in range(WRITE_OPS):
                j = c * 2 + (i > 10)
                if i in (3, 13):
                    kind = ("create", "set", "delete")[(c + (i > 10)) % 3]
                    if kind == "create":
                        p = {"b": at(CREATE_AT, j), "id": -(1 + j), "bd": 17_000 + j}
                        ops.append((CREATE_MUT, p, "create"))
                        ops.append((READ_CREATED, {"id": p["id"]}, ("created", p["b"])))
                    elif kind == "set":
                        p = {"id": at(SET_AT, j), "bd": 17_500 + j}
                        ops.append((SET_MUT, p, "set"))
                        ops.append((READ_SET, {"id": p["id"]}, ("set", p["bd"])))
                    else:
                        p = {"id": at(DELETE_AT, j)}
                        ops.append((DELETE_MUT, p, "delete"))
                        ops.append((READ_DELETED, p, ("deleted", 0)))
                elif i % 4 == 0:
                    ops.append((HOPS_MUT, {}, "read"))
                elif i % 4 == 1:
                    ops.append((AGG_MUT, {}, "read"))
                elif i % 4 == 2:
                    ops.append((self.cs.Q10, {"personId": at(IS3_AT, c)}, "read"))
                else:
                    ops.append((JOIN_MUT, {"id": at(JOIN_AT)}, "read"))
            plans.append(ops)
        return plans

    def serve_writes(self, small):
        import numpy as np

        from tpu_cypher_torch.serve import QueryServer
        from tpu_cypher_torch.storage import MutableGraph, WriteAheadLog
        from tpu_cypher_torch.utils import config

        cs, check = self.cs, self.check
        ids, bday, src, dst = cs.graph_arrays(small)
        tmp = tempfile.mkdtemp(prefix="tpu-cypher-smoke-wal-")
        try:
            wal_path = os.path.join(tmp, "sf1.wal")
            t0 = time.perf_counter()
            pg, nodes, rels = self.mutable_sf1(small, wal_path)
            self.sync()
            build_s = time.perf_counter() - t0
            m = pg._graph
            plans = self.write_plan(ids)
            config.COMPACT_DELTA_MAX.set(128)
            server = QueryServer(self.session, port=0, batch_window_ms=0)
            server.register_graph("m", pg)
            lat = {"read": [], "write": []}
            acked = []

            async def client(c, ops):
                reader, writer = await asyncio.open_connection(server.host, server.port)
                try:
                    for i, (query, params, kind) in enumerate(ops):
                        t0 = time.perf_counter()
                        done, rows = await _ask(reader, writer, f"w{c}-{i}", query, "m",
                                                params, tenant=f"w{c}")
                        dt = time.perf_counter() - t0
                        check(done["type"] == "done", f"write client {c}: {done}")
                        if isinstance(kind, tuple):  # the read-back of the last write
                            want = {"created": [{"b": kind[1]}], "set": [{"bd": kind[1]}],
                                    "deleted": [{"c": 0}]}[kind[0]]
                            check(rows == want, f"read-back {kind} {params}: {rows}")
                        elif kind != "read":
                            acked.append((kind, params))
                            lat["write"].append(dt)
                            continue
                        lat["read"].append(dt)
                finally:
                    writer.close()

            async def go():
                async with server:
                    t0 = time.perf_counter()
                    await asyncio.gather(*(client(c, ops) for c, ops in enumerate(plans)))
                    return time.perf_counter() - t0

            try:
                wall = self.served(lambda: asyncio.run(go()))
            finally:
                config.COMPACT_DELTA_MAX.reset()
            n_writes = WRITE_CLIENTS * 2
            check(len(acked) == n_writes and m.committed_batches == n_writes,
                  f"acked {len(acked)}, committed {m.committed_batches}")
            check(m.compactions >= 1, "no compaction happened during the run")
            # every acknowledged write reads back, and the final store
            # against numpy truth
            n = len(ids)
            s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
            bd = bday.copy()
            alive = np.ones(n, bool)
            created = []
            for kind, p in acked:
                if kind == "create":
                    rows = _plain(pg.cypher(READ_CREATED, {"id": p["id"]}).records.collect())
                    check(rows == [{"b": p["b"]}], f"created {p}: {rows}")
                    created.append(p)
                elif kind == "set":
                    rows = _plain(pg.cypher(READ_SET, {"id": p["id"]}).records.collect())
                    check(rows == [{"bd": p["bd"]}], f"set {p}: {rows}")
                    bd[np.searchsorted(ids, p["id"])] = p["bd"]
                else:
                    rows = _plain(pg.cypher(READ_DELETED, p).records.collect())
                    check(rows == [{"c": 0}], f"deleted {p}: {rows}")
                    alive[np.searchsorted(ids, p["id"])] = False
            keep = alive[s] & alive[d]
            anchor = int(JOIN_AT * n)
            want_hops = int(keep.sum()) + len(created)
            live_bd = np.concatenate([bd[alive], [p["bd"] for p in created]])
            got = {
                "persons": _plain(pg.cypher(PERSONS_MUT).records.collect()),
                "hops": _plain(pg.cypher(HOPS_MUT).records.collect()),
                "join": _plain(pg.cypher(JOIN_MUT, {"id": int(ids[anchor])})
                               .records.collect()),
            }
            want = {
                "persons": [{"c": int(alive.sum()) + len(created)}],
                "hops": [{"c": want_hops}],
                "join": [{"n": int((live_bd == bd[anchor]).sum())}],
            }
            check(got == want, f"final reads {got} != numpy {want}")
            # the store equals a rebuild from its committed writes
            t0 = time.perf_counter()
            rebuilt = MutableGraph(self.session, nodes, rels, name="sf1-rebuilt")
            rebuilt.attach_wal(WriteAheadLog(wal_path))
            replay_s = time.perf_counter() - t0
            check(rebuilt.replayed_batches == n_writes, "the WAL replays another count")
            check(_state(rebuilt) == _state(m), "the rebuild from the WAL differs")
            xs, ws = lat["read"], lat["write"]
            self.say(f"  writes: a MutableGraph of the small graph ({len(nodes)} persons, "
                     f"{len(rels)} KNOWS) built in {build_s:.3f} s; {len(xs) + len(ws)} "
                     f"ops from {WRITE_CLIENTS} clients in {wall:.3f} s host wall, "
                     f"{(len(xs) + len(ws)) / wall:.1f} ops/s; reads p50 "
                     f"{_percentile(xs, 0.5) * 1e3:.3f} ms p99 {_percentile(xs, 0.99) * 1e3:.3f} "
                     f"ms, writes p50 {_percentile(ws, 0.5) * 1e3:.3f} ms p99 "
                     f"{_percentile(ws, 0.99) * 1e3:.3f} ms (host clock); {n_writes} writes "
                     f"acknowledged and read back, {m.compactions} compaction(s), final "
                     f"reads equal numpy; WAL rebuild in {replay_s:.3f} s equals the store")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # -- 4. the cluster -----------------------------------------------------

    def cluster(self, persons, device):
        import numpy as np

        from tpu_cypher_torch.serve import ClusterServer, wire

        check = self.check
        rng = np.random.default_rng(self.cs.SEED)
        n, e = persons, persons * 10
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        bday = rng.integers(0, 18_000, n)
        ids = np.arange(n, dtype=np.int64) * 7 + 1
        create = "CREATE " + ", ".join(
            [f"(p{i}:Person {{id: {ids[i]}, birthday: {bday[i]}, firstname: 'p{i}'}})"
             for i in range(n)]
            + [f"(p{a})-[:KNOWS]->(p{b})" for a, b in zip(src, dst)])
        me = n // 3
        friends = np.concatenate([dst[src == me], src[dst == me]])
        truth = {
            "persons": [{"c": n + 4}],
            "hops": [{"c": int(len(src))}],
            "is3": [{"friendId": int(ids[f]), "firstName": f"p{f}"}
                    for f in sorted(friends, key=lambda f: ids[f])],
            "new": [{"id": -4}, {"id": -3}, {"id": -2}, {"id": -1}],
        }
        reads = [(PERSONS_MUT, {}, "persons"), (HOPS_MUT, {}, "hops"),
                 (self.cs.Q10, {"personId": int(ids[me])}, "is3")]
        new_q = "MATCH (n:Person) WHERE n.id < 0 RETURN n.id AS id ORDER BY id"
        tmp = tempfile.mkdtemp(prefix="tpu-cypher-smoke-cluster-")
        out = {}

        async def go():
            server = ClusterServer(workers=2, port=0, batch_window_ms=0, lanes=2,
                                   device=device, wal_dir=os.path.join(tmp, "wal"),
                                   cache_bytes=0)
            t0 = time.perf_counter()
            server.register_graph("m", create, mutable=True)
            out["parse_s"] = time.perf_counter() - t0
            server.warmup([PERSONS_MUT, HOPS_MUT], "m")
            t0 = time.perf_counter()
            await server.start()
            out["boot_s"] = time.perf_counter() - t0
            try:
                sup = server.supervisor
                check(len(sup.ready_workers) == 2, "the cluster did not boot 2 workers")
                reader, writer = await asyncio.open_connection(server.host, server.port)
                for k in range(1, 5):
                    done, _ = await _ask(reader, writer, f"cw{k}", "CREATE (:Person {id: $id})",
                                         "m", {"id": -k})
                    check(done["type"] == "done", f"cluster write {k}: {done}")
                writer.close()
                # two clients a worker (tenant-affine routing), and the
                # victim is client 0's: its next reads and its neighbour's
                # must be retried on the replica
                tenants, seen_w = [], {}
                for k in range(64):
                    wid = server.router._pick(f"ct{k}").worker_id
                    if seen_w.get(wid, 0) < 2:
                        seen_w[wid] = seen_w.get(wid, 0) + 1
                        tenants.append(f"ct{k}")
                check(len(tenants) == 4, f"no tenant spread over the workers: {seen_w}")
                victim = server.router._pick(tenants[0])
                answers, retried = [], []

                async def client(c):
                    r, w = await asyncio.open_connection(server.host, server.port)
                    try:
                        for i in range(12):
                            q, p, kind = reads[(c + i) % len(reads)]
                            done, rows = await _ask(r, w, f"r{c}-{i}", q, "m", p,
                                                    tenant=tenants[c])
                            check(done["type"] == "done", f"cluster read {c}: {done}")
                            answers.append((kind, rows))
                            if "replica" in done["rungs"]:
                                retried.append(done["rungs"])
                            if c == 0 and i == 2:
                                os.kill(victim.transport.pid, signal.SIGKILL)
                    finally:
                        w.close()

                t0 = time.perf_counter()
                await asyncio.gather(*(client(c) for c in range(4)))
                out["reads_s"] = time.perf_counter() - t0
                for kind, rows in answers:
                    check(rows == truth[kind], f"cluster {kind}: {rows[:3]}")
                check(retried, "no read was retried on the replica after the SIGKILL")
                t0 = time.perf_counter()
                deadline = time.monotonic() + 120
                while not (len(sup.ready_workers) == 2 and sup.total_restarts >= 1):
                    check(time.monotonic() < deadline, "the killed worker did not restart")
                    await asyncio.sleep(0.1)
                out["restart_s"] = time.perf_counter() - t0
                seen = set()
                for k in range(16):
                    payload = await server.router.submit(graph="m", query=new_q,
                                                         tenant=f"rb{k}")
                    check(payload["rows"] == truth["new"],
                          f"read-back on {payload['worker']}: {payload['rows']}")
                    seen.add(payload["worker"])
                check(seen == {"w0", "w1"}, f"read back on {seen} only")
                out["peaks"] = {}
                for wkr in sup.workers:
                    reply = await wire.request(wkr.host, wkr.port, {"op": "ping"},
                                               timeout=10.0)
                    out["peaks"][wkr.worker_id] = reply.get("peak_memory_bytes", 0)
                out["answers"], out["retried"] = len(answers), len(retried)
                out["victim"] = victim.worker_id
            finally:
                await server.stop()

        try:
            asyncio.run(go())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        peaks = ", ".join(f"{w} {b / 2**30:.3f} GiB" for w, b in sorted(out["peaks"].items()))
        self.say(f"  cluster: {persons} persons, {len(src)} KNOWS as CREATE text, parsed "
                 f"into the front end's replica in {out['parse_s']:.3f} s; 2 workers "
                 f"ready in {out['boot_s']:.3f} s; 4 writes acknowledged, then "
                 f"{out['answers']} reads from 4 clients in {out['reads_s']:.3f} s with "
                 f"{out['victim']} SIGKILLed mid-run ({out['retried']} retried on the "
                 f"replica), every answer exact; restarted in {out['restart_s']:.3f} s "
                 f"after the reads, WAL replayed, every write read back on w0 and w1")
        self.say(f"    worker peak device memory (torch.cuda.max_memory_allocated): {peaks}")
        return out


def _state(m):
    nodes = {i: (tuple(sorted(n.labels)), dict(sorted(n.properties.items())))
             for i, n in m._nodes.items()}
    rels = {i: (r.start, r.end, r.rel_type, dict(sorted(r.properties.items())))
            for i, r in m._rels.items()}
    return nodes, rels, m.fingerprint(), m._version


def run(cs, torch, session, *, big_scale=10.0, small_scale=1.0, cluster_persons=2000,
        tri_small=None, device="cuda", lanes_ab=False):
    """Phase 6 (``lanes_ab``: the lanes A/B alone instead). ``cs`` is the
    chip_smoke module; a failed check raises its ``SmokeFailure``."""
    import numpy as np

    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    on_card = device != "cpu"
    ph = Phase(cs, torch, session, on_card)
    t_start = time.perf_counter()
    print("serving tier (phase 6):", flush=True)
    t0 = time.perf_counter()
    big = PropertyGraph(session, generate_snb(big_scale, session, seed=cs.SEED))
    small = PropertyGraph(session, generate_snb(small_scale, session, seed=cs.SEED))
    ph.sync()
    ids1, _, src1, dst1 = cs.graph_arrays(small)
    if tri_small is None:
        tri_small = cs.triangle_truth(ids1, src1, dst1, rows_and_cliques=False)["triangles"]
    q1_pairs = np.sort(src1 * (1 << 32) + dst1)
    ph.say(f"  graphs: SF{big_scale:g} and SF{small_scale:g} generated and ingested "
           f"anew in {time.perf_counter() - t0:.3f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if lanes_ab:
        ph.lanes_ab(big, small, tri_small)
        return
    truth = ph.serve_mix(big, small, tri_small)
    ph.serve_features(big, small, truth, q1_pairs)
    ph.serve_writes(small)
    launches = ph.launches
    for name, c in launches.items():
        ph.check(c["fallback"] == 0 and (c["plain"] == 0) == on_card,
                 f"{name} off its tier in phase 6's served traffic: {c}")
        ph.check(c["kernel" if on_card else "plain"] > 0,
                 f"{name} not launched by phase 6's served traffic")
    ph.say(f"  phase 6 launches per (kernel, tier), served traffic only: "
           f"{ {n: {t: v for t, v in c.items() if v} for n, c in launches.items()} }")
    if on_card:
        ph.say(f"    in-process peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
               f"GiB (every graph this process holds included)")
    ph.cluster(cluster_persons, device)
    ph.say(f"  phase 6 took {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu for a "
                    "rehearsal of the control flow on the host")
    ap.add_argument("--big", type=float, default=10.0, help="the large graph's scale")
    ap.add_argument("--small", type=float, default=1.0, help="the small graph's scale")
    ap.add_argument("--cluster-persons", type=int, default=2000)
    ap.add_argument("--lanes-ab", action="store_true", help="run the served mix at 8 "
                    "lanes and at 1, with the serving threads' stacks sampled, and "
                    "nothing else of the phase")
    args = ap.parse_args()
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("serve_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpu_cypher_torch import CypherSession

    card = cs.card_line() if args.device != "cpu" else "cpu rehearsal: no device numbers"
    print(f"card: {card}")
    if args.device != "cpu":
        from tpu_cypher_torch.backend.cuda.hopper import _build

        t0 = time.perf_counter()
        _build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s")
    session = CypherSession.cuda(device=None if args.device != "cpu" else "cpu")
    try:
        run(cs, torch, session, big_scale=args.big, small_scale=args.small,
            cluster_persons=args.cluster_persons, device=args.device,
            lanes_ab=args.lanes_ab)
    except cs.SmokeFailure as exc:
        print(f"serve_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
