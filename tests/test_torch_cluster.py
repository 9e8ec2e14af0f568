"""The port's fault-isolated multi-process serving
(``tpu_cypher_torch/serve/{supervisor,router,cluster,worker}.py``) against
the reference's, the counterpart of ``tests/test_cluster.py``.

Two tiers:

* **fake-worker units** — each package's ``Supervisor``/``Router`` runs
  against in-process asyncio TCP servers that speak that package's worker
  wire protocol with scripted behavior (die mid-query, reply slowly, reply
  a typed error). Breaker transitions, backoff restarts, replica retry with
  the ``"replica"`` rung and hedged dispatch must come out the same in
  both packages.
* **real subprocesses** — two tests spawn ``python -m
  tpu_cypher_torch.serve.worker``: a ``ClusterServer`` of two CPU workers
  (``device: "cpu"``) whose answers equal the reference engine's, through
  an injected crash, a SIGKILL with WAL replay of a mutable graph, and a
  drain; and a worker asked for the card on a host without one, which
  fails its readiness instead of serving on the host.
"""

import asyncio
import collections
import json
import os
import signal
import subprocess
import sys
import time
import zlib
from typing import NamedTuple

import pytest
import torch

import tpu_cypher as R
import tpu_cypher.serve as RS
from tpu_cypher import errors as RE
from tpu_cypher.runtime import faults as RF
from tpu_cypher.runtime import guard as RG
from tpu_cypher.utils import config as RC

import tpu_cypher_torch.serve as PS
from tpu_cypher_torch import errors as PE
from tpu_cypher_torch.runtime import faults as PF
from tpu_cypher_torch.runtime import guard as PG
from tpu_cypher_torch.utils import config as PC

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg(NamedTuple):
    name: str
    serve: object
    errors: object
    faults: object
    guard: object
    config: object


PKGS = (Pkg("ref", RS, RE, RF, RG, RC), Pkg("port", PS, PE, PF, PG, PC))


def agree(fn):
    """``fn(pkg)`` for the reference and the port; equal results."""
    got = {p.name: fn(p) for p in PKGS}
    assert got["port"] == got["ref"], got
    return got["port"]


# ---------------------------------------------------------------------------
# fake workers: in-process asyncio servers speaking the worker protocol
# ---------------------------------------------------------------------------


def _payload(rows=({"n": 16},)):
    rows = [dict(r) for r in rows]
    return {
        "rows": rows, "columns": list(rows[0]) if rows else [], "seconds": 0.001,
        "execution_log": [{"rung": "device", "ok": True}],
        "rungs": ["device"], "degraded": False,
        "compile_stats": {}, "profile": {},
    }


class FakeWorkerTransport:
    """Duck-types ``SubprocessTransport`` over an in-process server. Each
    ``execute`` follows the launcher's script for the worker id ("ok" |
    "die" | "slow:<s>" | "error:<Type>"), shared across respawns."""

    def __init__(self, owner, worker_id):
        self.owner = owner
        self.wire = owner.wire
        self.worker_id = worker_id
        self.host = "127.0.0.1"
        self.port = 0
        self._dead = None
        self._server = None

    @property
    def pid(self):
        return 4242

    def poll(self):
        return self._dead

    def kill(self):
        self._die(137)

    terminate = kill

    def _die(self, code):
        if self._dead is None:
            self._dead = code
            if self._server is not None:
                self._server.close()

    async def wait_exit(self, timeout=None):
        while self._dead is None:
            await asyncio.sleep(0.005)

    async def wait_ready(self, timeout):
        if self.owner.boot_fail.get(self.worker_id, 0) > 0:
            self.owner.boot_fail[self.worker_id] -= 1
            self._dead = 1
            raise EOFError(f"fake worker {self.worker_id}: scripted boot crash")
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return {"ready": True, "port": self.port, "pid": self.pid,
                "worker": self.worker_id, "warmup": {"compiles": 0}}

    async def _handle(self, reader, writer):
        wire = self.wire
        try:
            while True:
                try:
                    msg = await wire.read_msg(reader)
                except (EOFError, ConnectionError, OSError):
                    return
                if self._dead is not None:
                    return
                op = msg.get("op")
                if op == "ping":
                    await wire.send_msg(writer, {"ok": True, "pong": True,
                                                 "worker": self.worker_id})
                    continue
                if op == "drain":
                    await wire.send_msg(writer, {"ok": True, "draining": True})
                    self._die(0)
                    return
                script = self.owner.scripts.get(self.worker_id)
                action = script.pop(0) if script else "ok"
                if action == "die":
                    self._die(137)
                    return
                if action.startswith("slow:"):
                    await asyncio.sleep(float(action.split(":", 1)[1]))
                    action = "ok"
                if action.startswith("error:"):
                    await wire.send_msg(writer, {
                        "id": msg.get("id"), "ok": False,
                        "error": action.split(":", 1)[1], "message": "scripted"})
                    continue
                self.owner.executes[self.worker_id].append(msg)
                await wire.send_msg(writer, {
                    "id": msg.get("id"), "ok": True, "worker": self.worker_id,
                    "payload": _payload()})
        finally:
            writer.close()


class FakeLauncher:
    def __init__(self, pkg, scripts=None, boot_fail=None):
        self.wire = pkg.serve.wire
        self.scripts = scripts or {}
        self.boot_fail = boot_fail or {}
        self.spawns = collections.Counter()
        self.live = {}
        self.executes = collections.defaultdict(list)

    async def spawn(self, worker_id):
        self.spawns[worker_id] += 1
        t = FakeWorkerTransport(self, worker_id)
        self.live[worker_id] = t
        return t


def _supervisor(pkg, launcher, n=2, **kw):
    kw.setdefault("canary", ("g", "MATCH (n) RETURN count(n) AS n"))
    kw.setdefault("health_interval_s", 0.03)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("backoff_max_s", 0.08)
    return pkg.serve.Supervisor(launcher, n, **kw)


async def _until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# circuit breaker (pure, fake clock)
# ---------------------------------------------------------------------------


def test_breaker_transitions():
    def run(p):
        now = [0.0]
        b = p.serve.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: now[0])
        seen = [(b.state, b.allow())]
        b.record_failure()
        seen.append(b.state)
        b.record_failure()
        seen.append((b.state, b.allow()))
        for t in (9.9, 10.0):
            now[0] = t
            seen.append(b.state)
        b.record_failure()
        seen.append(b.state)
        now[0] = 20.0
        seen.append(b.state)
        b.record_success()
        seen.append((b.state, b.allow()))
        return seen

    assert agree(run) == [("closed", True), "closed", ("open", False), "open",
                          "half-open", "open", "half-open", ("closed", True)]


def test_breaker_success_resets_failure_count():
    def run(p):
        b = p.serve.CircuitBreaker(threshold=3, cooldown_s=1.0)
        for f in ("fail", "fail", "ok", "fail", "fail"):
            b.record_failure() if f == "fail" else b.record_success()
        return b.state

    assert agree(run) == "closed"


def test_breaker_state_change_hook():
    def run(p):
        seen, now = [], [0.0]
        b = p.serve.CircuitBreaker(threshold=1, cooldown_s=5.0,
                                   clock=lambda: now[0], on_change=seen.append)
        b.record_failure()
        b.record_success()
        return seen

    assert agree(run) == ["open", "closed"]


# ---------------------------------------------------------------------------
# supervisor backoff
# ---------------------------------------------------------------------------


def test_backoff_delay_doubles_and_caps():
    def run(p):
        sup = _supervisor(p, FakeLauncher(p), backoff_s=0.25, backoff_max_s=5.0)
        return [sup.backoff_delay(a) for a in range(8)]

    assert agree(run) == [0.25, 0.5, 1.0, 2.0, 4.0, 5.0, 5.0, 5.0]


def test_supervisor_restarts_through_boot_crashes():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            ready = len(sup.ready_workers)
            launcher.boot_fail = {"w0": 2}
            launcher.live["w0"].kill()
            w0 = sup.workers[0]
            await _until(lambda: w0.restarts == 1 and w0.restart_attempt == 0,
                         what="w0 recovery through 2 boot crashes")
            out = ready, launcher.spawns["w0"], sup.total_restarts
            await sup.stop()
            return out

        return asyncio.run(go())

    assert agree(run) == (2, 4, 1)


# ---------------------------------------------------------------------------
# router: replica retry, idempotence, hedging
# ---------------------------------------------------------------------------


def test_router_replica_retry_stamps_rung_and_restarts_worker():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=2, hedge_ms=0)
            victim = router._pick("tenant-a").worker_id
            launcher.scripts[victim] = ["die"]
            payload = await router.submit(
                graph="g", query="MATCH (a:P) RETURN count(a) AS n",
                tenant="tenant-a", qid="q1")
            survivor = payload["worker"]
            executed = len(launcher.executes[survivor]), list(launcher.executes[victim])
            await _until(lambda: sup.workers[int(victim[1:])].restarts == 1,
                         what="victim restart")
            await sup.stop()
            log = payload["execution_log"]
            return (payload["rows"], payload["replica_retries"], survivor != victim,
                    log[0]["rung"], log[0]["worker"] == victim, payload["rungs"],
                    *executed)

        return asyncio.run(go())

    got = agree(run)
    assert got == ([{"n": 16}], 1, True, PG.RUNG_REPLICA, True,
                   [PG.RUNG_REPLICA, PG.RUNG_DEVICE], 1, [])


def test_router_strips_fault_spec_on_retry():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=2, hedge_ms=0)
            victim = router._pick("t").worker_id
            launcher.scripts[victim] = ["die"]
            payload = await router.submit(graph="g", query="q", tenant="t",
                                          faults="crash@expand:1")
            faults = launcher.executes[payload["worker"]][0]["faults"]
            await sup.stop()
            return faults

        return asyncio.run(go())

    assert agree(run) is None


def test_router_exhausted_retries_raises_worker_lost():
    def run(p):
        async def go():
            launcher = FakeLauncher(p, scripts={"w0": ["die", "die"],
                                                "w1": ["die", "die"]})
            sup = _supervisor(p, launcher, n=2, backoff_s=5.0)
            await sup.start()
            router = p.serve.Router(sup, retry_max=1, hedge_ms=0)
            with pytest.raises(p.errors.WorkerLost) as info:
                await router.submit(graph="g", query="q", tenant="t")
            await sup.stop()
            return type(info.value).__name__

        return asyncio.run(go())

    assert agree(run) == "WorkerLost"


def test_refused_connection_restarts_unreaped_worker():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=2, hedge_ms=0, ready_wait_s=5.0)
            victim = sup.workers[0]
            victim.transport._server.close()
            unreaped = victim.transport.poll() is None
            tenant = "t"
            while router._pick(tenant).worker_id != victim.worker_id:
                tenant += "x"
            payload = await router.submit(graph="g", query="q", tenant=tenant)
            await _until(lambda: launcher.spawns[victim.worker_id] >= 2,
                         what="victim respawn")
            await sup.stop()
            return unreaped, payload["rows"], payload["replica_retries"] >= 1

        return asyncio.run(go())

    assert agree(run) == (True, [{"n": 16}], True)


def test_router_waits_out_momentarily_empty_fleet():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=2, hedge_ms=0, ready_wait_s=5.0)
            for w in sup.workers:
                w.transport._die(1)
            payload = await router.submit(graph="g", query="q", tenant="t")
            await sup.stop()
            return (payload["rows"], payload["replica_retries"] >= 1,
                    p.guard.RUNG_REPLICA in payload["rungs"])

        return asyncio.run(go())

    assert agree(run) == ([{"n": 16}], True, True)


def test_router_typed_worker_errors_pass_through():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=1)
            await sup.start()
            launcher.scripts["w0"] = ["error:QueryTimeout"]
            router = p.serve.Router(sup, retry_max=2, hedge_ms=0)
            with pytest.raises(p.errors.QueryTimeout):
                await router.submit(graph="g", query="q", tenant="t")
            state = sup.workers[0].breaker.state
            await sup.stop()
            return state

        return asyncio.run(go())

    assert agree(run) == "closed"


def test_hedged_dispatch_second_replica_wins():
    def run(p):
        async def go():
            launcher = FakeLauncher(p)
            sup = _supervisor(p, launcher, n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=1, hedge_ms=20.0)
            primary = router._pick("tenant-h").worker_id
            launcher.scripts[primary] = ["slow:1.5"]
            t0 = time.monotonic()
            payload = await router.submit(graph="g", query="q", tenant="tenant-h")
            elapsed = time.monotonic() - t0
            await sup.stop()
            return payload["worker"] != primary, elapsed < 1.0

        return asyncio.run(go())

    assert agree(run) == (True, True)


def test_hedging_skipped_for_faulted_queries():
    def run(p):
        async def go():
            sup = _supervisor(p, FakeLauncher(p), n=2)
            await sup.start()
            router = p.serve.Router(sup, retry_max=1, hedge_ms=20.0)
            out = router._should_hedge(None, None), router._should_hedge("oom@join:1", None)
            await sup.stop()
            return out

        return asyncio.run(go())

    assert agree(run) == (True, False)


# ---------------------------------------------------------------------------
# scheduler: drain + shed
# ---------------------------------------------------------------------------


def test_scheduler_drain_rejects_new_and_quiesces():
    def run(p):
        async def go():
            s = p.serve.AdmissionScheduler(max_concurrent=2)
            await s.acquire(1, "t")
            s.begin_drain()
            with pytest.raises(p.errors.AdmissionRejected):
                await s.acquire(1, "t")

            async def finish():
                await asyncio.sleep(0.05)
                s.release("t")

            task = asyncio.ensure_future(finish())
            t0 = time.monotonic()
            await s.quiesce(5.0)
            waited = time.monotonic() - t0 >= 0.04
            await task
            return s.running, s.queued, waited

        return asyncio.run(go())

    assert agree(run) == (0, 0, True)


def test_scheduler_queue_high_sheds_typed():
    def run(p):
        async def go():
            s = p.serve.AdmissionScheduler(max_concurrent=1, queue_high=1)
            await s.acquire(1, "t")
            waiter = asyncio.ensure_future(s.acquire(1, "t"))
            await asyncio.sleep(0.01)
            with pytest.raises(p.errors.AdmissionRejected) as e:
                await s.acquire(1, "t")
            s.release("t")
            await waiter
            s.release("t")
            return "watermark" in str(e.value)

        return asyncio.run(go())

    assert agree(run) is True


# ---------------------------------------------------------------------------
# typed plumbing: classify, crash kind, config registry
# ---------------------------------------------------------------------------


def test_classify_worker_disconnects():
    def run(p):
        out = []
        for exc in (ConnectionResetError("peer reset"), BrokenPipeError("gone"),
                    asyncio.IncompleteReadError(b"", 1)):
            typed = p.errors.classify(exc)
            out.append((type(typed).__name__, isinstance(typed, p.errors.DeviceLost),
                        typed.retryable))
        return out, p.errors.classify(ValueError("not a fault"))

    out, none = agree(run)
    assert out == [("WorkerLost", True, True)] * 3 and none is None


def test_crash_kind_parses_and_is_disarmed_outside_workers():
    def run(p):
        F = p.faults
        spec = F.parse_spec("crash@expand:1")
        armed = F.crash_armed()
        with F.scoped_spec("crash@somewhere:1"):
            with pytest.raises(F.InjectedFault) as e:
                F.fault_point("somewhere")
        return spec, armed, isinstance(p.errors.classify(e.value), p.errors.DeviceLost)

    assert agree(run) == ({"expand": [("crash", 1, 1)]}, False, True)


def test_serve_knobs_declared_in_registry():
    names = (
        "TPU_CYPHER_SERVE_WORKERS", "TPU_CYPHER_SERVE_BREAKER_THRESHOLD",
        "TPU_CYPHER_SERVE_BREAKER_COOLDOWN_S", "TPU_CYPHER_SERVE_RESTART_BACKOFF_S",
        "TPU_CYPHER_SERVE_RESTART_BACKOFF_MAX_S", "TPU_CYPHER_SERVE_HEALTH_INTERVAL_S",
        "TPU_CYPHER_SERVE_DRAIN_TIMEOUT_S", "TPU_CYPHER_SERVE_HEDGE_MS",
        "TPU_CYPHER_SERVE_QUEUE_HIGH", "TPU_CYPHER_SERVE_RETRY_MAX",
    )

    def run(p):
        reg = p.config.REGISTRY
        return [(n, n in reg and bool(reg[n].help), reg[n].default if n in reg else None)
                for n in names]

    assert all(ok for _, ok, _ in agree(run))
    # the stream chunk: one setting in the port, whose default is the
    # reference's effective one (its 0 follows TPU_CYPHER_CHUNK_ROWS)

    def chunk(p):
        return p.guard.stream_chunk_rows()

    assert agree(chunk) == 65536
    for rows, want in (("16384", 16384), ("100", 1024)):
        for p in PKGS:
            p.config.SERVE_STREAM_CHUNK_ROWS.set(int(rows))
        try:
            assert agree(chunk) == want
        finally:
            for p in PKGS:
                p.config.SERVE_STREAM_CHUNK_ROWS.reset()


def test_tenant_pick_is_stable_and_salt_free():
    def run(p):
        async def go():
            sup = _supervisor(p, FakeLauncher(p), n=4)
            await sup.start()
            router = p.serve.Router(sup, retry_max=0, hedge_ms=0)
            picks = {router._pick("tenant-x").worker_id for _ in range(10)}
            await sup.stop()
            return picks

        return asyncio.run(go())

    assert agree(run) == {f"w{zlib.crc32(b'tenant-x') % 4}"}


# ---------------------------------------------------------------------------
# real subprocesses: python -m tpu_cypher_torch.serve.worker
# ---------------------------------------------------------------------------

_N = 8
CREATE_Q = "CREATE " + ", ".join(
    [f"(n{i}:P {{id: {i}}})" for i in range(_N)]
    + [f"(n{i})-[:K]->(n{(i + 1) % _N})" for i in range(_N)]
    + [f"(n{i})-[:K]->(n{(i + 3) % _N})" for i in range(_N)]
)
COUNT_Q = "MATCH (a:P) RETURN count(a) AS n"
HOP_Q = "MATCH (a:P)-[:K]->(b:P) RETURN count(b) AS n"
ROWS_Q = "MATCH (a:P {id: 3})-[:K]->(b:P) RETURN b.id AS id ORDER BY id"
WRITE_Q = "CREATE (:P {id: $id})"
READ_W = "MATCH (a:P) WHERE a.id >= 100 RETURN a.id AS id ORDER BY id"


async def _client(host, port, lines):
    reader, writer = await asyncio.open_connection(host, port)
    for line in lines:
        writer.write((json.dumps(line) + "\n").encode())
    await writer.drain()
    want = sum(1 for l in lines if l.get("op") == "submit")
    out, done = [], 0
    while done < want:
        raw = await asyncio.wait_for(reader.readline(), 120)
        if not raw:
            break
        msg = json.loads(raw)
        out.append(msg)
        if msg.get("type") in ("done", "error", "cancelled"):
            done += 1
    writer.close()
    return out


def _rows_of(msgs, qid):
    return [r for m in msgs if m["type"] == "rows" and m["id"] == qid for r in m["rows"]]


def _done_of(msgs, qid):
    for m in msgs:
        if m.get("id") == qid and m["type"] in ("done", "error"):
            return m
    raise AssertionError(f"no terminal for {qid}: {msgs}")


def _reference_rows():
    """The reference engine's answers on the same CREATE graph, in wire
    form."""
    session = R.CypherSession.tpu()
    graph = session.create_graph_from_create_query(CREATE_Q)
    out = {}
    for q in (COUNT_Q, HOP_Q, ROWS_Q):
        records = session.cypher(q, {}, graph=graph).records
        out[q] = RS.wire.encode_rows(records.collect(), list(records.columns))
    return out


def test_cluster_e2e_crash_sigkill_wal_replay_drain(tmp_path):
    """Two real CPU workers: answers equal the reference engine's; an
    injected ``crash@expand`` kills a worker mid-query and the client
    still gets exact rows (rung "replica"); acknowledged writes to a
    mutable graph survive a SIGKILL of the writer, replayed from the
    shared WAL by the restarted worker and read back from both; drain
    rejects new submits typed."""
    golden = _reference_rows()

    async def run():
        server = PS.ClusterServer(
            workers=2, port=0, batch_window_ms=0, lanes=2, device="cpu",
            wal_dir=str(tmp_path / "wal"), cache_bytes=0,
        )
        server.register_graph("g", CREATE_Q)
        server.register_graph("m", CREATE_Q, mutable=True)
        server.warmup([COUNT_Q, HOP_Q, ROWS_Q], "g")
        await server.start()
        try:
            sup = server.supervisor
            assert len(sup.ready_workers) == 2
            qs = (COUNT_Q, HOP_Q, ROWS_Q)
            msgs = await _client(server.host, server.port, [
                {"op": "submit", "id": f"p{i}", "graph": "g", "query": q,
                 "tenant": f"t{i}"} for i, q in enumerate(qs)])
            for i, q in enumerate(qs):
                assert _done_of(msgs, f"p{i}")["type"] == "done"
                assert _rows_of(msgs, f"p{i}") == golden[q], q

            msgs = await _client(server.host, server.port, [
                {"op": "submit", "id": "boom", "graph": "g", "query": HOP_Q,
                 "tenant": "chaos", "faults": "crash@expand:1"}])
            done = _done_of(msgs, "boom")
            assert done["type"] == "done", done
            assert _rows_of(msgs, "boom") == golden[HOP_Q]
            assert PG.RUNG_REPLICA in done["rungs"], done
            await _until(lambda: len(sup.ready_workers) == 2
                         and sup.total_restarts >= 1, timeout=90.0,
                         what="crash recovery")

            # acknowledged writes, then SIGKILL the writer (the first id)
            msgs = await _client(server.host, server.port, [
                {"op": "submit", "id": f"w{i}", "graph": "m", "query": WRITE_Q,
                 "parameters": {"id": 100 + i}} for i in range(3)])
            assert all(_done_of(msgs, f"w{i}")["type"] == "done" for i in range(3))
            writer = min(sup.ready_workers, key=lambda w: w.worker_id)
            os.kill(writer.transport.pid, signal.SIGKILL)
            msgs = await _client(server.host, server.port, [
                {"op": "submit", "id": f"k{i}", "graph": "g", "query": COUNT_Q,
                 "tenant": f"kt{i}"} for i in range(6)])
            for i in range(6):
                assert _done_of(msgs, f"k{i}")["type"] == "done"
                assert _rows_of(msgs, f"k{i}") == golden[COUNT_Q]
            await _until(lambda: len(sup.ready_workers) == 2
                         and sup.total_restarts >= 2, timeout=90.0,
                         what="SIGKILL recovery")
            seen = set()
            for tenant in (f"r{i}" for i in range(16)):
                payload = await server.router.submit(graph="m", query=READ_W,
                                                     tenant=tenant)
                assert payload["rows"] == [{"id": 100}, {"id": 101}, {"id": 102}]
                seen.add(payload["worker"])
            assert seen == {"w0", "w1"}  # both replicas, the restarted one too

            await server.drain(timeout=15.0)
            msgs = await _client(server.host, server.port, [
                {"op": "submit", "id": "late", "graph": "g", "query": COUNT_Q}])
            late = _done_of(msgs, "late")
            assert late["type"] == "error" and late["error"] == "AdmissionRejected"
        finally:
            await server.stop()

    asyncio.run(run())
    assert os.path.isfile(tmp_path / "wal" / "m.wal")


def test_worker_without_card_fails_readiness():
    """A worker whose config does not ask for the CPU needs a card: on a
    host without one it exits before its readiness line, so the
    supervisor's cold start fails and nothing serves on the host."""

    async def run():
        launcher = PS.SubprocessLauncher({"g": CREATE_Q}, {}, device="cuda")
        sup = PS.Supervisor(launcher, 1, ready_timeout_s=120.0)
        with pytest.raises(EOFError, match="exited before READY"):
            await sup.start()
        w = sup.workers[0]
        await w.transport.wait_exit(timeout=30.0)
        return w.state, w.transport.poll()

    state, code = asyncio.run(run())
    assert state != "ready" and code not in (None, 0)


def test_main_without_card_raises_unless_asked_for_cpu():
    """``python -m tpu_cypher_torch.serve`` builds ``CypherSession.cuda()``:
    without a card it raises before serving."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cypher_torch.serve"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "DeviceUnavailable" in proc.stderr and "device='cpu'" in proc.stderr
    assert "query server on" not in proc.stdout
