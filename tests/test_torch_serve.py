"""The port's serving tier (``tpu_cypher_torch/serve/``) against the
reference's (``tpu_cypher/serve/``), the counterpart of
``tests/test_serve.py``.

Every test drives the same thing through both packages: the reference's
``QueryServer`` on ``CypherSession.tpu()`` (JAX on the CPU) and the port's
on ``CypherSession.cuda(device="cpu")``, each over one graph built from the
same CREATE text, fed the same client lines over real sockets. The port
must give bag-identical rows (in order where the query orders them), the
same typed error names and protocol errors, the same result-cache hit and
miss counts and the same batching counters. Where the two differ by design
the test says so: the port has no host rung, so a chaos-injected device
fault reaches its client typed where the reference degrades.

Beyond the reference's tests: the cursor stream decodes chunk by chunk
(``CudaTable.rows_chunked``) with no whole-column decode, and the CSR
index fills once under racing threads.
"""

import asyncio
import json
import sys
import threading
from collections import Counter
from typing import NamedTuple

import pytest
import torch

import tpu_cypher as R
import tpu_cypher.serve as RS
from tpu_cypher import errors as RE

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as PE
import tpu_cypher_torch.serve as PS

torch.set_num_threads(1)

N = 16
CREATE_Q = "CREATE " + ", ".join(
    [f"(n{i}:P {{id: {i}}})" for i in range(N)]
    + [f"(n{i})-[:K]->(n{(i + 1) % N})" for i in range(N)]
    + [f"(n{i})-[:K]->(n{(i + 5) % N})" for i in range(N)]
)
COUNT_Q = "MATCH (a:P) RETURN count(a) AS n"
HOP_Q = "MATCH (a:P)-[:K]->(b:P) RETURN count(b) AS n"
ROWS_Q = "MATCH (a:P {id: 3})-[:K]->(b:P) RETURN b.id AS id ORDER BY id"
# 16^3 = 4096 rows -> 16 pages of PAGE_ROWS=256
CROSS_Q = "MATCH (a:P), (b:P), (c:P) RETURN a.id AS x, b.id AS y, c.id AS z"


class Engine(NamedTuple):
    name: str
    serve: object  # the package's serve module
    errors: object  # the package's errors module
    session: object
    graph: object


@pytest.fixture(scope="module")
def engines():
    ref = R.CypherSession.tpu()
    port = CypherSession.cuda(device="cpu")
    return (
        Engine("ref", RS, RE, ref, ref.create_graph_from_create_query(CREATE_Q)),
        Engine("port", PS, PE, port, port.create_graph_from_create_query(CREATE_Q)),
    )


def both(engines, fn):
    """``fn(engine)`` for the reference and the port: {name: result}."""
    return {e.name: fn(e) for e in engines}


def agree(engines, fn):
    """Run ``fn`` on both engines, require equal results, return one."""
    got = both(engines, fn)
    assert got["port"] == got["ref"], got
    return got["port"]


async def _client(host, port, lines, want=None):
    """Send every line, read until each submit reaches a terminal message."""
    reader, writer = await asyncio.open_connection(host, port)
    for line in lines:
        writer.write((json.dumps(line) + "\n").encode())
    await writer.drain()
    if want is None:
        want = sum(1 for l in lines if l.get("op") == "submit")
    out, done = [], 0
    while done < want:
        raw = await asyncio.wait_for(reader.readline(), 30)
        if not raw:
            break
        msg = json.loads(raw)
        out.append(msg)
        if msg.get("type") in ("done", "error", "cancelled"):
            done += 1
    writer.close()
    return out


async def _http(host, port, path, method="GET"):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.decode().split("\r\n")[0], body


def _terminals(msgs, typ="done"):
    return {m["id"]: m for m in msgs if m["type"] == typ}


def _rows_of(msgs, qid):
    rows = []
    for m in msgs:
        if m["type"] == "rows" and m["id"] == qid:
            rows.extend(m["rows"])
    return rows


def _bag(rows):
    return Counter(json.dumps(r, sort_keys=True) for r in rows)


def _serve(e, **kw):
    srv = e.serve.QueryServer(e.session, port=0, **kw)
    srv.register_graph("g", e.graph)
    return srv


def _served(e, lines, **kw):
    """Start a server on ``e``, run one client over ``lines``."""

    async def run():
        async with _serve(e, **kw) as srv:
            return await _client(srv.host, srv.port, lines)

    return asyncio.run(run())


def _dispatches(e):
    return sum(int(v) for _, v in e.serve.batching.DISPATCHES.items())


def _cache_counts(e):
    rc = e.serve.result_cache
    return int(rc.HITS.value()), int(rc.MISSES.value())


# ---------------------------------------------------------------------------
# scheduler units (no engine)
# ---------------------------------------------------------------------------


def test_scheduler_cost_ordering(engines):
    """With one slot, waiters are granted cheapest-padded-cost first."""

    def run(e):
        async def go():
            s = e.serve.AdmissionScheduler(max_concurrent=1)
            await s.acquire(10, "t")
            order = []

            async def waiter(name, cost):
                await s.acquire(cost, "t")
                order.append(name)
                s.release("t")

            tasks = [
                asyncio.ensure_future(waiter("big", 4096)),
                asyncio.ensure_future(waiter("small", 64)),
                asyncio.ensure_future(waiter("mid", 512)),
            ]
            await asyncio.sleep(0.01)
            s.release("t")
            await asyncio.gather(*tasks)
            return order

        return asyncio.run(go())

    assert agree(engines, run) == ["small", "mid", "big"]


def test_scheduler_tenant_fairness(engines):
    def run(e):
        async def go():
            s = e.serve.AdmissionScheduler(max_concurrent=2)
            await s.acquire(10, "hog")
            await s.acquire(10, "hog")
            order = []

            async def waiter(name, tenant, cost):
                await s.acquire(cost, tenant)
                order.append(name)

            tasks = [
                asyncio.ensure_future(waiter("hog3", "hog", 1)),
                asyncio.ensure_future(waiter("guest", "guest", 1000)),
            ]
            await asyncio.sleep(0.01)
            s.release("hog")
            await asyncio.sleep(0.01)
            s.release("hog")
            await asyncio.gather(*tasks)
            return order

        return asyncio.run(go())

    assert agree(engines, run) == ["guest", "hog3"]


def test_scheduler_tenant_quota(engines):
    def run(e):
        async def go():
            s = e.serve.AdmissionScheduler(max_concurrent=4, tenant_quota=1)
            await s.acquire(1, "t1")
            task = asyncio.ensure_future(s.acquire(1, "t1"))
            await asyncio.sleep(0.01)
            queued = (not task.done(), s.running)
            await s.acquire(1, "t2")
            s.release("t1")
            await asyncio.wait_for(task, 1)
            return queued, s.running

        return asyncio.run(go())

    assert agree(engines, run) == ((True, 1), 2)


def test_scheduler_queued_deadline_times_out_typed(engines):
    def run(e):
        async def go():
            s = e.serve.AdmissionScheduler(max_concurrent=1)
            await s.acquire(1, "t")
            loop = asyncio.get_running_loop()
            with pytest.raises(e.errors.QueryTimeout):
                await s.acquire(1, "t", deadline_at=loop.time() + 0.02)
            s.release("t")
            await s.acquire(1, "t")
            return s.queued

        return asyncio.run(go())

    assert agree(engines, run) == 0


def test_scheduler_expired_deadline_rejected_before_slot(engines):
    def run(e):
        async def go():
            s = e.serve.AdmissionScheduler(max_concurrent=1)
            with pytest.raises(e.errors.QueryTimeout):
                await s.acquire(1, "t", deadline_at=0.0)
            return s.running

        return asyncio.run(go())

    assert agree(engines, run) == 0


def test_estimate_cost_bytes_orders_by_shape(engines):
    """More pattern fan-out -> strictly larger padded estimate, the same
    bytes in both packages."""

    def run(e):
        est = e.serve.estimate_cost_bytes
        return (
            est(e.graph, COUNT_Q),
            est(e.graph, HOP_Q),
            est(e.graph, "MATCH (a)-[:K]->()-[:K]->()-[:K]->(d) RETURN d"),
        )

    c1, c2, c3 = agree(engines, run)
    assert 0 < c1 < c2 < c3


def test_preflight_admit_rejects_over_budget_typed(engines):
    """With a device-memory budget below a query's estimate, admission
    rejects it typed (``bucketing.admit`` against
    ``bucketing.memory_budget_bytes``) before it takes a slot."""
    from tpu_cypher.utils import config as RC
    from tpu_cypher_torch.backend.cuda import bucketing
    from tpu_cypher_torch.utils import config as PC

    def run(e):
        budget = (RC if e.name == "ref" else PC).MEM_BUDGET
        cost = e.serve.preflight_admit(e.graph, HOP_Q)
        budget.set(cost // 2)
        try:
            with pytest.raises(e.errors.AdmissionRejected) as info:
                e.serve.preflight_admit(e.graph, HOP_Q)
        finally:
            budget.reset()
        return cost, type(info.value).__name__

    cost, name = agree(engines, run)
    assert cost > 0 and name == "AdmissionRejected"
    assert bucketing.memory_budget_bytes() == 0  # restored


# ---------------------------------------------------------------------------
# batcher units
# ---------------------------------------------------------------------------


def test_batch_key_none_for_uncacheable(engines):
    def run(e):
        bk = e.serve.batch_key
        return (
            bk(e.session, "CREATE GRAPH g { RETURN 1 }", e.graph, {}),
            bk(e.session, COUNT_Q, e.graph, {"rows": [{"a": 1}]}),
        )

    assert agree(engines, run) == (None, None)


def test_batch_key_separates_param_values(engines):
    q = "MATCH (a:P {id: $i}) RETURN a.id AS id"

    def run(e):
        bk = e.serve.batch_key
        k1 = bk(e.session, q, e.graph, {"i": 1})
        k2 = bk(e.session, q, e.graph, {"i": 2})
        k1b = bk(e.session, q, e.graph, {"i": 1})
        return k1 is not None, k1 == k1b, k1 != k2, k1[1:]

    got = agree(engines, run)
    assert got[:3] == (True, True, True)
    assert got[3] == ((("i", "1"),), ("off",))  # values, bucket signature


def test_batch_window_coalesces_until_sealed(engines):
    def run(e):
        async def go():
            w = e.serve.BatchWindow(window_ms=50)
            b, lead = w.lead_or_join("k", "q1")
            b2, lead2 = w.lead_or_join("k", "q2")
            w.close(b)
            b3, lead3 = w.lead_or_join("k", "q3")
            w.publish(b, result="r")
            return (lead, b2 is b, lead2, lead3, b3 is b, b.result,
                    b.done.is_set(), b.size)

        return asyncio.run(go())

    assert agree(engines, run) == (True, True, False, True, False, "r", True, 2)


def test_batch_window_zero_disables_coalescing(engines):
    def run(e):
        async def go():
            w = e.serve.BatchWindow(window_ms=0)
            b1, l1 = w.lead_or_join("k", "q1")
            b2, l2 = w.lead_or_join("k", "q2")
            return l1 and l2 and b1 is not b2

        return asyncio.run(go())

    assert agree(engines, run) is True


# ---------------------------------------------------------------------------
# server end-to-end (real sockets)
# ---------------------------------------------------------------------------


def test_server_submit_stream_done(engines):
    def run(e):
        msgs = _served(e, [
            {"op": "submit", "id": "a", "graph": "g", "query": ROWS_Q},
        ])
        done = _terminals(msgs)["a"]
        return msgs[0], done["rungs"], done["degraded"], _rows_of(msgs, "a")

    accepted, rungs, degraded, rows = agree(engines, run)
    assert accepted == {"type": "accepted", "id": "a"}
    assert rungs == ["device"] and degraded is False
    assert rows == [{"id": 4}, {"id": 8}]


def test_server_results_identical_to_serial(engines):
    """Every served row page reproduces serial in-process execution
    byte-for-byte, and the port's pages equal the reference's."""
    queries = [COUNT_Q, HOP_Q, ROWS_Q,
               "MATCH (a:P) RETURN a.id AS id ORDER BY id LIMIT 5",
               "MATCH (a:P)-[:K]->(b:P) RETURN a.id AS a, b.id AS b"]

    def run(e):
        msgs = _served(e, [
            {"op": "submit", "id": f"q{i}", "graph": "g", "query": q}
            for i, q in enumerate(queries)
        ])
        out = []
        for i, q in enumerate(queries):
            records = e.graph.cypher(q).records
            want = e.serve.wire.encode_rows(records.collect(), records.columns)
            got = _rows_of(msgs, f"q{i}")
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), q
            out.append(got if "ORDER BY" in q else _bag(got))
        return out

    agree(engines, run)


def test_server_burst_shares_one_dispatch(engines):
    """A same-plan same-params burst inside the window is ONE dispatch,
    every client tagged with the batch size and the leader's id."""

    def run(e):
        async def go():
            async with _serve(e, batch_window_ms=50) as srv:
                before = _dispatches(e)
                msgs = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": f"b{i}", "graph": "g", "query": HOP_Q}
                    for i in range(4)
                ])
                return msgs, _dispatches(e) - before

        msgs, dispatches = asyncio.run(go())
        dones = _terminals(msgs)
        pages = {json.dumps(_rows_of(msgs, f"b{i}")) for i in range(4)}
        return (len(dones), {d["batched"] for d in dones.values()},
                len({d["batch_leader"] for d in dones.values()}), dispatches,
                sorted(pages))

    n, sizes, leaders, dispatches, pages = agree(engines, run)
    assert (n, sizes, leaders, dispatches) == (4, {4}, 1, 1)
    assert pages == ['[{"n": 32}]']


def test_server_chaos_scoped_per_client(engines):
    """A chaos schedule is context-local to the client that asked for it:
    an interleaved clean query of the SAME shape stays on the device rung
    with the right rows. By design the port has no host rung: the chaos
    query's DeviceOOM reaches its client typed, where the reference
    degrades down its ladder to the host oracle."""

    def run(e):
        msgs = _served(e, [
            {"op": "submit", "id": "chaos", "graph": "g", "query": HOP_Q,
             "faults": "oom@expand:*"},
            {"op": "submit", "id": "clean", "graph": "g", "query": HOP_Q},
        ], batch_window_ms=10)
        return msgs

    got = both(engines, run)
    ref, port = got["ref"], got["port"]
    clean = [_terminals(m)["clean"] for m in (ref, port)]
    assert [c["rungs"] for c in clean] == [["device"], ["device"]]
    assert _rows_of(port, "clean") == _rows_of(ref, "clean") == [{"n": 32}]
    assert _terminals(ref)["chaos"]["rungs"][-1] == "host-oracle"
    assert _rows_of(ref, "chaos") == [{"n": 32}]
    err = _terminals(port, "error")["chaos"]
    assert err["error"] == "DeviceOOM" and _rows_of(port, "chaos") == []


def test_server_expired_deadline_is_typed_error(engines):
    def run(e):
        msgs = _served(e, [
            {"op": "submit", "id": "t", "graph": "g", "query": COUNT_Q,
             "deadline_s": 1e-6},
        ])
        return _terminals(msgs, "error")["t"]["error"]

    assert agree(engines, run) == "QueryTimeout"


def test_server_cancel_queued_query(engines):
    """Cancel while queued: the query never dispatches; the client gets a
    terminal 'cancelled' message and the scheduler stays healthy."""

    def run(e):
        async def go():
            async with _serve(e, max_concurrent=1) as srv:
                await srv.scheduler.acquire(1, "holder")
                reader, writer = await asyncio.open_connection(srv.host, srv.port)

                async def send(obj):
                    writer.write((json.dumps(obj) + "\n").encode())
                    await writer.drain()

                async def terminal():
                    while True:
                        m = json.loads(await asyncio.wait_for(reader.readline(), 30))
                        if m.get("type") in ("done", "error", "cancelled"):
                            return m

                await send({"op": "submit", "id": "victim", "graph": "g",
                            "query": COUNT_Q})
                accepted = json.loads(await asyncio.wait_for(reader.readline(), 30))
                await asyncio.sleep(0.05)
                await send({"op": "cancel", "id": "victim"})
                victim = await terminal()
                srv.scheduler.release("holder")
                await send({"op": "submit", "id": "after", "graph": "g",
                            "query": COUNT_Q})
                after = await terminal()
                writer.close()
                return accepted["type"], victim, after["type"], after["id"]

        return asyncio.run(go())

    assert agree(engines, run) == (
        "accepted", {"type": "cancelled", "id": "victim"}, "done", "after"
    )


def test_server_protocol_errors(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                return await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "g1", "graph": "nope", "query": "RETURN 1"},
                    {"op": "submit", "id": "g2", "graph": "g", "query": "MATCH ("},
                    {"op": "nonsense", "id": "g3"},
                    {"op": "submit", "id": "g4", "graph": "g", "query": "  "},
                ], want=4)

        errs = _terminals(asyncio.run(go()), "error")
        return {k: v["error"] for k, v in errs.items()}

    errs = agree(engines, run)
    assert errs["g1"] == "UnknownGraph"
    assert errs["g2"]  # the typed parse error, surfaced not swallowed
    assert errs["g3"] == errs["g4"] == "ProtocolError"


def test_server_concurrent_clients_match_serial(engines):
    """Eight clients at once, each on its own connection, each with its
    own mix: every answer equals the serial run and the reference's."""
    mix = [(COUNT_Q, {}), (HOP_Q, {}), (ROWS_Q, {}),
           ("MATCH (a:P {id: $i})-[:K]->(b:P) RETURN b.id AS id ORDER BY id",
            {"i": 7})]

    def run(e):
        async def go():
            async with _serve(e, batch_window_ms=0, cache_bytes=0) as srv:
                return await asyncio.gather(*(
                    _client(srv.host, srv.port, [
                        {"op": "submit", "id": f"c{c}q{i}", "graph": "g",
                         "query": q, "parameters": p, "tenant": f"t{c}"}
                        for i, (q, p) in enumerate(mix)
                    ]) for c in range(8)
                ))

        per_client = asyncio.run(go())
        out = []
        for c, msgs in enumerate(per_client):
            for i, (q, p) in enumerate(mix):
                records = e.session.cypher(q, p, graph=e.graph).records
                want = e.serve.wire.encode_rows(records.collect(), records.columns)
                got = _rows_of(msgs, f"c{c}q{i}")
                assert got == want, (c, q)
                out.append(got)
        return out

    agree(engines, run)


# ---------------------------------------------------------------------------
# HTTP observability surface
# ---------------------------------------------------------------------------


def test_http_metrics_golden_matches_in_process(engines):
    """GET /metrics serves ``session.metrics_text()`` VERBATIM."""

    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "m", "graph": "g", "query": COUNT_Q},
                ])
                status, body = await _http(srv.host, srv.port, "/metrics")
                golden = e.session.metrics_text()
            return status, body.decode() == golden, (
                "tpu_cypher_serve_queries_total" in golden)

        return asyncio.run(go())

    status, same, named = agree(engines, run)
    assert status.endswith("200 OK") and same and named


def test_http_query_record_serves_profile(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "p1", "graph": "g", "query": HOP_Q},
                ])
                ok = await _http(srv.host, srv.port, "/queries/p1")
                missing = await _http(srv.host, srv.port, "/queries/zzz")
            return ok, missing

        (status, body), (mstatus, _) = asyncio.run(go())
        rec = json.loads(body)
        names = json.dumps(rec["profile"])
        return (status, rec["status"], rec["rungs"], rec["batched"],
                rec["tenant"], "execute" in names, "collect" in names, mstatus)

    got = agree(engines, run)
    assert got[0].endswith("200 OK") and got[-1].endswith("404 Not Found")
    assert got[1:7] == ("done", ["device"], 1, "default", True, True)


def test_http_healthz_and_404(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                h = await _http(srv.host, srv.port, "/healthz")
                nf = await _http(srv.host, srv.port, "/bogus")
            return h, nf

        (hs, hb), (ns, _) = asyncio.run(go())
        return hs, json.loads(hb), ns

    hs, health, ns = agree(engines, run)
    assert hs.endswith("200 OK") and ns.endswith("404 Not Found")
    assert health["ok"] is True and health["graphs"] == ["g"]


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------


def test_result_cache_lru_byte_budget_eviction(engines):
    def run(e):
        p = {"rows": [{"id": 1}], "degraded": False}
        one = len(json.dumps(p))
        cache = e.serve.ResultCache(max_bytes=2 * one)
        steps = [cache.store("k1", "fp", p), cache.store("k2", "fp", p),
                 cache.lookup("k1", "fp") is not None, cache.store("k3", "fp", p),
                 cache.lookup("k2", "fp") is None,
                 cache.lookup("k1", "fp") is not None,
                 cache.lookup("k3", "fp") is not None,
                 cache.lookup("k1", "other-fp") is None,
                 cache.lookup("k1", "fp") is None,
                 cache.store("big", "fp", {"rows": [{"id": i} for i in range(99)]}),
                 cache.store("deg", "fp", {"rows": [], "degraded": True}),
                 cache.store(None, "fp", p),
                 cache.store("obj", "fp", {"rows": object()})]
        stats = cache.stats()
        return steps, stats["entries"], stats["bytes"] == one, cache.flush(), (
            cache.stats()["bytes"])

    steps, entries, one_entry, flushed, after = agree(engines, run)
    assert steps == [True] * 9 + [False] * 4
    assert (entries, one_entry, flushed, after) == (1, True, 1, 0)


def test_result_cache_disabled_by_zero_budget(engines):
    def run(e):
        cache = e.serve.ResultCache(max_bytes=0)
        return cache.enabled, cache.store("k", "fp", {"rows": []}), (
            cache.lookup("k", "fp"))

    assert agree(engines, run) == (False, False, None)


def test_graph_fingerprint_tracks_statistics(engines):
    """Equal graphs fingerprint alike in both packages; other data does
    not."""

    def run(e):
        fp = e.serve.result_cache.graph_fingerprint
        g2 = e.session.create_graph_from_create_query("CREATE (a:P {id: 0})")
        return fp(e.session, e.graph), fp(e.session, e.graph), fp(e.session, g2)

    a, b, c = agree(engines, run)
    assert a == b and a != c


def test_cache_hit_byte_identical_and_zero_dispatch(engines):
    """A repeat read is served with zero dispatch (no kernel launches on
    the port) and its pages are byte-identical to the original's."""
    from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD

    def run(e):
        async def go():
            async with _serve(e) as srv:
                m1 = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "c1", "graph": "g", "query": ROWS_Q},
                ])
                before = _dispatches(e)
                PD.reset()
                h0 = _cache_counts(e)
                m2 = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "c2", "graph": "g", "query": ROWS_Q},
                ])
                h1 = _cache_counts(e)
                launches = sum(sum(c.values()) for c in PD.use_counts().values())
                after = _dispatches(e)
                _, rec = await _http(srv.host, srv.port, "/queries/c2")
            return m1, m2, after - before, launches, json.loads(rec), (
                h1[0] - h0[0], h1[1] - h0[1])

        m1, m2, dispatches, launches, rec, hits = asyncio.run(go())
        d1, d2 = _terminals(m1)["c1"], _terminals(m2)["c2"]
        return (d1["cached"], d2["cached"], dispatches, rec["cached"],
                rec["compile_stats"], rec["profile"]["root"]["children"][0]["name"],
                json.dumps(_rows_of(m1, "c1")) == json.dumps(_rows_of(m2, "c2")),
                hits, d2["seconds"] < 0.001, launches if e.name == "port" else 0)

    assert agree(engines, run) == (
        False, True, 0, True, {}, "cache", True, (1, 0), True, 0)


def test_cache_excludes_chaos_and_deadline_queries(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "f1", "graph": "g", "query": HOP_Q,
                     "faults": "oom@expand:*"},
                    {"op": "submit", "id": "d1", "graph": "g", "query": HOP_Q,
                     "deadline_s": 30.0},
                ])
                entries = srv.cache.stats()["entries"]
                m = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "f2", "graph": "g", "query": HOP_Q},
                ])
            return entries, _terminals(m)["f2"]["cached"]

        return asyncio.run(go())

    assert agree(engines, run) == (0, False)


def test_cache_fingerprint_mismatch_invalidates(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "i1", "graph": "g", "query": COUNT_Q},
                ])
                first = srv.cache.stats()["entries"]
                srv._fingerprints["g"] = "stats-changed"
                m = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "i2", "graph": "g", "query": COUNT_Q},
                ])
                return first, _terminals(m)["i2"]["cached"], (
                    srv.cache.stats()["entries"])

        return asyncio.run(go())

    assert agree(engines, run) == (1, False, 1)


def test_cache_batched_burst_populates_then_hits(engines):
    def run(e):
        async def go():
            async with _serve(e, batch_window_ms=50) as srv:
                burst = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": f"s{i}", "graph": "g", "query": COUNT_Q}
                    for i in range(3)
                ])
                before = _dispatches(e)
                late = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "late", "graph": "g", "query": COUNT_Q},
                ])
                return burst, late, _dispatches(e) - before

        burst, late, dispatches = asyncio.run(go())
        dones = _terminals(burst)
        d = _terminals(late)["late"]
        return ({x["batched"] for x in dones.values()},
                [x["cached"] for x in dones.values()], d["cached"], dispatches,
                _rows_of(late, "late"), _rows_of(burst, "s0"))

    sizes, cached, late_cached, dispatches, late, first = agree(engines, run)
    assert sizes == {3} and cached == [False] * 3
    assert late_cached is True and dispatches == 0 and late == first == [{"n": 16}]


def test_http_cache_stats_and_flush(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "h1", "graph": "g", "query": COUNT_Q},
                    {"op": "submit", "id": "h2", "graph": "g", "query": COUNT_Q},
                ])
                _, stats = await _http(srv.host, srv.port, "/cache")
                _, flushed = await _http(srv.host, srv.port, "/cache/flush",
                                         method="POST")
                _, stats2 = await _http(srv.host, srv.port, "/cache")
            return json.loads(stats), json.loads(flushed), json.loads(stats2)

        stats, flushed, stats2 = asyncio.run(go())
        return (stats["entries"], stats["bytes"] > 0, stats["max_bytes"] > 0,
                flushed, stats2["entries"], stats2["bytes"])

    assert agree(engines, run) == (1, True, True, {"flushed": 1}, 0, 0)


def test_cache_flush_requires_post(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "h1", "graph": "g", "query": COUNT_Q},
                ])
                get_status, get_body = await _http(srv.host, srv.port, "/cache/flush")
                _, stats = await _http(srv.host, srv.port, "/cache")
                post_other, _ = await _http(srv.host, srv.port, "/metrics",
                                            method="POST")
            return get_status, json.loads(get_body), json.loads(stats), post_other

        gs, body, stats, post_other = asyncio.run(go())
        return gs.split()[1], "POST" in body["error"], stats["entries"], (
            post_other.split()[1])

    assert agree(engines, run) == ("405", True, 1, "405")


# ---------------------------------------------------------------------------
# cursor streaming
# ---------------------------------------------------------------------------


async def _stream_client(host, port, submit, close_after=None):
    """One streaming query: ack every page (``next``), optionally closing
    the cursor after ``close_after`` pages."""
    reader, writer = await asyncio.open_connection(host, port)

    async def send(obj):
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()

    await send(submit)
    msgs, pages = [], 0
    while True:
        msg = json.loads(await asyncio.wait_for(reader.readline(), 60))
        msgs.append(msg)
        if msg.get("type") == "rows":
            pages += 1
            if close_after is not None and pages >= close_after:
                await send({"op": "close", "id": submit["id"]})
                close_after = None
            else:
                await send({"op": "next", "id": submit["id"]})
        if msg.get("type") in ("done", "error", "cancelled"):
            break
    writer.close()
    return msgs


def test_stream_rows_match_eager_and_zero_row_parity(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                s = await _stream_client(srv.host, srv.port, {
                    "op": "submit", "id": "st", "graph": "g", "query": ROWS_Q,
                    "stream": True})
                c = await _stream_client(srv.host, srv.port, {
                    "op": "submit", "id": "cx", "graph": "g", "query": CROSS_Q,
                    "stream": True})
                ea = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "ea", "graph": "g", "query": ROWS_Q}])
                z = await _stream_client(srv.host, srv.port, {
                    "op": "submit", "id": "zz", "graph": "g",
                    "query": "MATCH (a:P {id: 99}) RETURN a.id AS id",
                    "stream": True})
            return s, c, ea, z

        s, c, ea, z = asyncio.run(go())
        d, cd, zd = _terminals(s)["st"], _terminals(c)["cx"], _terminals(z)["zz"]
        return (d["streamed"], d["cached"], d["rows"], d["total_rows"],
                _rows_of(s, "st") == _rows_of(ea, "ea"), _rows_of(s, "st"),
                cd["rows"], _bag(_rows_of(c, "cx")), zd["rows"],
                [m["rows"] for m in z if m["type"] == "rows"])

    got = agree(engines, run)
    assert got[:6] == (True, False, 2, 2, True, [{"id": 4}, {"id": 8}])
    assert got[6] == 4096 and sum(got[7].values()) == 4096
    assert got[8:] == (0, [[]])


def test_stream_close_ends_delivery_early(engines):
    def run(e):
        async def go():
            async with _serve(e) as srv:
                return await _stream_client(srv.host, srv.port, {
                    "op": "submit", "id": "cl", "graph": "g", "query": CROSS_Q,
                    "stream": True}, close_after=1)

        d = _terminals(asyncio.run(go()))["cl"]
        return d["total_rows"], 0 < d["rows"] < 4096

    assert agree(engines, run) == (4096, True)


def test_stream_backpressure_parks_only_its_cursor(engines, monkeypatch):
    """A consumer that grants no credit parks its cursor after exactly
    ``window`` pages, while the loop keeps serving other clients."""
    monkeypatch.setenv("TPU_CYPHER_SERVE_STREAM_WINDOW", "2")

    def run(e):
        waits_metric = e.serve.server.BACKPRESSURE_WAITS

        async def go():
            async with _serve(e) as srv:
                reader, writer = await asyncio.open_connection(srv.host, srv.port)

                async def send(obj):
                    writer.write((json.dumps(obj) + "\n").encode())
                    await writer.drain()

                async def recv():
                    return json.loads(await asyncio.wait_for(reader.readline(), 30))

                before = waits_metric.value()
                await send({"op": "submit", "id": "bp", "graph": "g",
                            "query": CROSS_Q, "stream": True})
                await recv()
                pages = [await recv(), await recv()]
                for _ in range(100):
                    if waits_metric.value() > before:
                        break
                    await asyncio.sleep(0.01)
                waits = waits_metric.value() - before
                other = await _client(srv.host, srv.port, [
                    {"op": "submit", "id": "ok", "graph": "g", "query": COUNT_Q}])
                await send({"op": "close", "id": "bp"})
                tail = []
                while True:
                    m = await recv()
                    tail.append(m)
                    if m.get("type") in ("done", "error", "cancelled"):
                        break
                writer.close()
            return waits, other, pages + tail

        waits, other, msgs = asyncio.run(go())
        d = _terminals(msgs)["bp"]
        return (waits >= 1, _terminals(other)["ok"]["type"],
                sum(1 for m in msgs if m.get("type") == "rows"),
                d["rows"], d["total_rows"])

    assert agree(engines, run) == (True, "done", 2, 512, 4096)


def test_stream_decodes_chunk_by_chunk(engines, monkeypatch):
    """The port's counterpart of the reference's 1.26M-row RSS pin: a
    100,489-row stream (317 persons, every pair) decodes through
    ``CudaTable.rows_chunked`` one chunk at a time — each column's
    ``to_values_range`` once per chunk, and no whole-column decode of the
    result — and its rows equal the reference's stream."""
    from tpu_cypher_torch.backend.cuda.column import Column

    monkeypatch.setenv("TPU_CYPHER_SERVE_STREAM_CHUNK_ROWS", "16384")
    n = 317
    create = "CREATE " + ", ".join(f"(n{i}:P {{id: {i}}})" for i in range(n))
    query = "MATCH (a:P), (b:P) RETURN a.id AS x, b.id AS y"
    ranges, whole = [], []
    real_range, real_values = Column.to_values_range, Column.to_values

    def spy_range(self, lo, hi):
        ranges.append(hi - lo)
        return real_range(self, lo, hi)

    def spy_values(self, row_mask=None):
        whole.append(len(self))
        return real_values(self, row_mask)

    def run(e):
        graph = e.session.create_graph_from_create_query(create)

        async def go():
            server = e.serve.QueryServer(e.session, port=0)
            server.register_graph("big", graph)
            checksum = total = 0
            async with server:
                reader, writer = await asyncio.open_connection(server.host, server.port)
                writer.write((json.dumps({"op": "submit", "id": "big", "graph": "big",
                                          "stream": True, "query": query}) + "\n").encode())
                while True:
                    msg = json.loads(await asyncio.wait_for(reader.readline(), 120))
                    if msg["type"] == "rows":
                        total += len(msg["rows"])
                        checksum += sum(r["x"] * n + r["y"] for r in msg["rows"])
                        writer.write(b'{"op": "next", "id": "big"}\n')
                    elif msg["type"] == "done":
                        done = msg
                        break
                    elif msg["type"] != "accepted":
                        raise AssertionError(msg)
                writer.close()
            return total, done["total_rows"], done["streamed"], checksum

        if e.name == "port":
            monkeypatch.setattr(Column, "to_values_range", spy_range)
            monkeypatch.setattr(Column, "to_values", spy_values)
        try:
            return asyncio.run(go())
        finally:
            monkeypatch.setattr(Column, "to_values_range", real_range)
            monkeypatch.setattr(Column, "to_values", real_values)

    total, total_rows, streamed, checksum = agree(engines, run)
    assert total == total_rows == n * n and streamed is True
    assert checksum == sum(range(n * n))
    chunks = -(-n * n // 16384)  # 7
    assert len(ranges) == 2 * chunks and max(ranges) == 16384
    assert sum(ranges) == 2 * n * n
    assert not [w for w in whole if w >= 16384 * 2], whole


def test_stream_serves_a_factorized_fan(engines, monkeypatch):
    """A 64 x 64 fan (64 sources -> 1 hub -> 64 targets) under
    ``TPU_CYPHER_FACTORIZE=force``: the result is a ``FactorizedTable``
    and the cursor streams its 4,096 rows chunk by chunk
    (``FactorizedTable.rows_chunked``) without flattening it; the rows
    equal the reference's stream and the closed form."""
    import test_factorized as RFT
    from tpu_cypher.utils import config as RCFG
    from tpu_cypher_torch.backend.cuda.factorized import FactorizedTable
    from tpu_cypher_torch.utils import config as PCFG

    k = m = 64
    monkeypatch.setenv("TPU_CYPHER_SERVE_STREAM_CHUNK_ROWS", "1024")
    flattened = []
    real = FactorizedTable.to_flat_table

    def spy(self):
        flattened.append(self.size)
        return real(self)

    monkeypatch.setattr(FactorizedTable, "to_flat_table", spy)
    tables = []

    def run(e):
        graph = e.session.create_graph_from_create_query(RFT._fan_create(k, m))
        if e.name == "port":
            tables.append(graph.cypher(RFT.FAN_QUERY).records.table)

        async def go():
            async with _serve(e) as srv:
                srv.register_graph("fan", graph)
                return await _stream_client(srv.host, srv.port, {
                    "op": "submit", "id": "fan", "graph": "fan", "stream": True,
                    "query": RFT.FAN_QUERY})

        msgs = asyncio.run(go())
        d = _terminals(msgs)["fan"]
        return d["streamed"], d["rows"], d["total_rows"], _bag(_rows_of(msgs, "fan"))

    for cfg in (RCFG, PCFG):
        cfg.FACTORIZE.set("force")
    try:
        streamed, rows, total, bag = agree(engines, run)
    finally:
        for cfg in (RCFG, PCFG):
            cfg.FACTORIZE.reset()
    assert streamed is True and rows == total == k * m
    assert bag == _bag([{"x": x, "y": y} for x, y in RFT._fan_rows(k, m)])
    assert isinstance(tables[0], FactorizedTable)
    assert not [n for n in flattened if n >= k * m], flattened


# ---------------------------------------------------------------------------
# concurrency: the shared CSR index
# ---------------------------------------------------------------------------


def test_graph_index_fills_once_under_racing_threads(monkeypatch):
    """Eight threads' first queries on one graph: ``GraphIndex.of`` gives
    them one index, the CSR of each orientation is built once (the others
    wait for it), and every answer is right."""
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex

    session = CypherSession.cuda(device="cpu")
    graph = session.create_graph_from_create_query(CREATE_Q)
    builds, maps = Counter(), [0]
    real_build, real_map = GraphIndex._build_csr, GraphIndex._map_endpoints

    def spy_build(self, types_key, reverse, ctx):
        builds[(types_key, reverse)] += 1
        return real_build(self, types_key, reverse, ctx)

    def spy_map(self, types_key, ctx):
        maps[0] += 1
        return real_map(self, types_key, ctx)

    monkeypatch.setattr(GraphIndex, "_build_csr", spy_build)
    monkeypatch.setattr(GraphIndex, "_map_endpoints", spy_map)
    barrier = threading.Barrier(8)
    results, indexes, errors = [None] * 8, [None] * 8, []
    queries = [HOP_Q, "MATCH (a:P)<-[:K]-(b:P) RETURN count(*) AS n"]

    def worker(i):
        try:
            barrier.wait(timeout=30)
            indexes[i] = GraphIndex.of(graph._graph)
            rows = graph.cypher(queries[i % 2]).records.collect()
            results[i] = [dict(r) for r in rows]
        except BaseException as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert results == [[{"n": 32}]] * 8
    assert all(gi is indexes[0] for gi in indexes)
    assert builds and all(v == 1 for v in builds.values()), builds
    gi = indexes[0]
    assert (("K",), False) in gi._csr or (("K",), True) in gi._csr
