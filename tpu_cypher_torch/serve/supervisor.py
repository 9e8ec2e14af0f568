"""Worker supervision: spawn, health-check, breaker, backoff restart.

The supervisor owns the worker PROCESSES; the router (``serve/router.py``)
owns the REQUESTS. Split that way, every failure-handling decision has one
home: "is this worker usable right now" is answered here (liveness probes,
circuit breaker, restart state), and "what do I do with this query" is
answered there (retry on a surviving replica, hedge, fail typed).

Recovery model, in order of escalation:

* **health loop** — every ``TPU_CYPHER_SERVE_HEALTH_INTERVAL_S``: a dead
  child process (``poll()``) goes straight to restart; a live one gets a
  ``ping`` probe (liveness + queue depth); an open breaker past its
  cooldown gets a CANARY query (a real, known-good execute) and only a
  canary success closes the breaker — readiness is proven by doing, not
  asserted.
* **circuit breaker** (per worker) — consecutive transport failures open
  it (routing stops immediately); after
  ``TPU_CYPHER_SERVE_BREAKER_COOLDOWN_S`` it half-opens for exactly one
  probe. Classic closed/open/half-open, time-lazy (state is computed from
  the clock, no timer tasks to leak).
* **backoff restart** — a crashed worker respawns after
  ``base * 2^attempt`` capped at ``TPU_CYPHER_SERVE_RESTART_BACKOFF_MAX_S``
  so a worker that dies on arrival (poisoned cache, bad device) cannot
  hot-loop the host. The attempt counter resets only on a successful
  canary, not on a successful spawn. Restarted workers load the kernel
  libraries the first boot built (``hopper/_build.py`` reuses a build
  directory by source hash), so recovery cost is process boot, CUDA
  context and graph replica, not a kernel build.

Workers are spawned with ``asyncio.create_subprocess_exec`` — a fresh
interpreter, never a fork: CUDA cannot be used in a forked child. Child
lifecycle rides the event loop like everything else here; nothing in this
module blocks.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import tpu_cypher_torch

from ..obs.metrics import REGISTRY as _REGISTRY
from ..utils.config import (
    SERVE_BREAKER_COOLDOWN_S,
    SERVE_BREAKER_THRESHOLD,
    SERVE_HEALTH_INTERVAL_S,
    SERVE_RESTART_BACKOFF_MAX_S,
    SERVE_RESTART_BACKOFF_S,
)
from . import wire

WORKER_RESTARTS = _REGISTRY.counter(
    "tpu_cypher_serve_worker_restarts_total",
    "supervisor restarts of crashed engine workers",
    labels=("worker",),
)
WORKERS_UP = _REGISTRY.gauge(
    "tpu_cypher_serve_workers_up",
    "engine workers currently ready for traffic",
)
BREAKER_STATE = _REGISTRY.gauge(
    "tpu_cypher_serve_breaker_state",
    "per-worker circuit breaker (0=closed, 1=half-open, 2=open)",
    labels=("worker",),
)

_BREAKER_CODES = {"closed": 0, "half-open": 1, "open": 2}

# worker process states
STARTING = "starting"
READY = "ready"
DOWN = "down"


class CircuitBreaker:  # shared-by: loop
    """Per-worker closed/open/half-open breaker, time-lazy: ``state`` is
    computed from the last transition stamp and the clock, so there are no
    timer tasks and tests inject a fake clock."""

    def __init__(
        self,
        threshold: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        on_change: Optional[Callable[[str], None]] = None,
    ):
        self.threshold = int(
            threshold if threshold is not None else SERVE_BREAKER_THRESHOLD.get()
        )
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else SERVE_BREAKER_COOLDOWN_S.get()
        )
        self._clock = clock
        self._on_change = on_change
        self._failures = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        """May a request be routed here? Open says no; half-open says yes —
        the next outcome decides which way it latches."""
        return self.state != "open"

    def record_success(self) -> None:
        changed = self._opened_at is not None or self._failures
        self._failures = 0
        self._opened_at = None
        if changed and self._on_change is not None:
            self._on_change(self.state)

    def record_failure(self) -> None:
        if self.state == "half-open":
            # the probe failed: re-open and restart the cooldown
            self._opened_at = self._clock()
        else:
            self._failures += 1
            if self._failures >= self.threshold and self._opened_at is None:
                self._opened_at = self._clock()
        if self._on_change is not None:
            self._on_change(self.state)


class WorkerHandle:  # shared-by: loop
    """One supervised worker: its transport (process + port), breaker, and
    restart bookkeeping. ``available`` is the router's routing predicate."""

    def __init__(self, worker_id: str, breaker: CircuitBreaker):
        self.worker_id = worker_id
        self.breaker = breaker
        self.transport = None  # set by Supervisor on every (re)spawn
        self.state = STARTING
        self.restarts = 0  # completed restarts, lifetime
        self.restart_attempt = 0  # consecutive failures, resets on canary
        self.restarting = False

    @property
    def host(self) -> str:
        return self.transport.host

    @property
    def port(self) -> int:
        return self.transport.port

    @property
    def available(self) -> bool:
        return (
            self.state == READY
            and self.transport is not None
            and self.breaker.allow()
        )


class SubprocessTransport:
    """A real ``python -m tpu_cypher_torch.serve.worker`` child process."""

    def __init__(self, proc: asyncio.subprocess.Process, host: str):
        self._proc = proc
        self.host = host
        self.port = 0

    @property
    def pid(self) -> int:
        return self._proc.pid

    def poll(self) -> Optional[int]:
        """Exit code if the child has died, else None (alive)."""
        return self._proc.returncode

    def kill(self) -> None:
        if self._proc.returncode is None:
            self._proc.kill()

    def terminate(self) -> None:
        if self._proc.returncode is None:
            self._proc.terminate()

    async def wait_exit(self, timeout: Optional[float] = None) -> None:
        await asyncio.wait_for(self._proc.wait(), timeout)

    async def wait_ready(self, timeout: float) -> Dict[str, Any]:
        """Block until the child prints its readiness line (warmup-gated by
        construction — see ``serve/worker.py``), skipping any non-JSON
        noise a library emits on stdout first."""
        deadline = time.monotonic() + timeout

        async def _scan() -> Dict[str, Any]:
            while True:
                line = await self._proc.stdout.readline()
                if not line:
                    raise EOFError(
                        f"worker pid={self.pid} exited before READY "
                        f"(code={self.poll()})"
                    )
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue  # fault-ok: stray stdout noise before READY
                if isinstance(msg, dict) and msg.get("ready"):
                    return msg

        msg = await asyncio.wait_for(
            _scan(), max(deadline - time.monotonic(), 0.001)
        )
        self.port = int(msg["port"])
        return msg


class SubprocessLauncher:
    """Spawns engine workers as child processes and feeds each its config
    line (device, graphs to replicate, warmup corpus, WAL directory).
    Tests substitute a fake launcher whose transports are in-process
    asyncio servers — everything above the transport interface is
    exercised without subprocess boot costs."""

    def __init__(
        self,
        graphs: Dict[str, str],
        warmup: Dict[str, List[str]],
        device: str = "cuda",
        host: str = "127.0.0.1",
        lanes: int = 4,
        mutable: Optional[List[str]] = None,
        wal_dir: Optional[str] = None,
    ):
        self.graphs = dict(graphs)
        self.warmup = {k: list(v) for k, v in warmup.items()}
        self.device = device
        self.host = host
        self.lanes = lanes
        self.mutable = sorted(mutable or ())
        self.wal_dir = wal_dir

    async def spawn(self, worker_id: str) -> SubprocessTransport:
        env = dict(os.environ)
        # the child must import THIS tree even when the parent runs from a
        # checkout that is not on the default sys.path
        repo_root = os.path.dirname(os.path.dirname(tpu_cypher_torch.__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo_root, env.get("PYTHONPATH")) if p
        )
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "tpu_cypher_torch.serve.worker",
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            env=env,
        )
        cfg = {
            "worker_id": worker_id,
            "host": self.host,
            "graphs": self.graphs,
            "warmup": self.warmup,
            "device": self.device,
            "lanes": self.lanes,
            "mutable": self.mutable,
            "wal_dir": self.wal_dir,
        }
        proc.stdin.write((json.dumps(cfg) + "\n").encode())
        await proc.stdin.drain()
        return SubprocessTransport(proc, self.host)


class Supervisor:  # shared-by: loop
    """Owns N ``WorkerHandle``s: concurrent cold start, periodic health
    loop, breaker canaries, and backoff restarts. The ``canary`` is a
    known-good (graph, query) pair executed to PROVE a worker ready."""

    def __init__(
        self,
        launcher,
        n_workers: int,
        canary: Optional[Tuple[str, str]] = None,
        health_interval_s: Optional[float] = None,
        backoff_s: Optional[float] = None,
        backoff_max_s: Optional[float] = None,
        ready_timeout_s: float = 120.0,
    ):
        self.launcher = launcher
        self.canary = canary
        self.health_interval_s = float(
            health_interval_s if health_interval_s is not None
            else SERVE_HEALTH_INTERVAL_S.get()
        )
        self.backoff_s = float(
            backoff_s if backoff_s is not None else SERVE_RESTART_BACKOFF_S.get()
        )
        self.backoff_max_s = float(
            backoff_max_s if backoff_max_s is not None
            else SERVE_RESTART_BACKOFF_MAX_S.get()
        )
        self.ready_timeout_s = ready_timeout_s
        self.workers: List[WorkerHandle] = []
        for i in range(max(int(n_workers), 1)):
            wid = f"w{i}"
            self.workers.append(
                WorkerHandle(
                    wid,
                    CircuitBreaker(
                        on_change=lambda s, _wid=wid: BREAKER_STATE.set(
                            _BREAKER_CODES[s], worker=_wid
                        )
                    ),
                )
            )
        self._health_task: Optional[asyncio.Task] = None
        self._restart_tasks: set = set()  # strong refs: tasks must not be GC'd
        self._stopping = False

    # -- introspection ---------------------------------------------------

    @property
    def ready_workers(self) -> List[WorkerHandle]:
        return [w for w in self.workers if w.available]

    @property
    def total_restarts(self) -> int:
        return sum(w.restarts for w in self.workers)

    def _note_up(self) -> None:
        WORKERS_UP.set(sum(1 for w in self.workers if w.state == READY))

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        """Cold-start every worker CONCURRENTLY (they warm independently;
        serial boot would multiply cold-start latency by N) and begin the
        health loop. Raises if any worker fails its first boot — a cluster
        that cannot start whole should say so, not limp up."""
        await asyncio.gather(*(self._boot(w) for w in self.workers))
        self._health_task = asyncio.ensure_future(self._health_loop())

    async def _boot(self, w: WorkerHandle) -> Dict[str, Any]:
        w.state = STARTING
        w.transport = await self.launcher.spawn(w.worker_id)
        ready = await w.transport.wait_ready(self.ready_timeout_s)
        w.state = READY
        self._note_up()
        return ready

    async def stop(self) -> None:
        self._stopping = True
        if self._health_task is not None:
            self._health_task.cancel()
        for t in list(self._restart_tasks):
            t.cancel()
        for w in self.workers:
            if w.transport is not None:
                w.transport.kill()
        # reap the children while the loop is still alive — otherwise the
        # transports' pipe cleanup fires from __del__ after loop close
        for w in self.workers:
            if w.transport is not None:
                try:
                    await w.transport.wait_exit(timeout=5.0)
                except Exception:  # fault-ok: stop() must never raise
                    pass
        self._note_up()

    async def drain(self, timeout: float) -> None:
        """Ask every live worker to finish in-flight work and exit; bound
        the whole goodbye by ``timeout``."""
        self._stopping = True
        if self._health_task is not None:
            self._health_task.cancel()

        async def _drain_one(w: WorkerHandle) -> None:
            if w.transport is None or w.transport.poll() is not None:
                return
            w.state = DOWN
            try:
                await wire.request(
                    w.host, w.port, {"op": "drain"}, timeout=5.0
                )
                await w.transport.wait_exit(timeout)
            except Exception:  # fault-ok: a worker that won't drain is killed
                w.transport.kill()

        await asyncio.gather(*(_drain_one(w) for w in self.workers))
        self._note_up()

    # -- failure intake (the router calls this) --------------------------

    def note_failure(self, w: WorkerHandle, exc: BaseException) -> None:
        """The router observed a transport failure against ``w``: charge
        the breaker now (routing reacts immediately) and, if the process is
        actually dead, restart without waiting for the next health tick.

        ``poll()`` alone is not enough: right after a SIGKILL the child is
        not reaped yet and ``returncode`` is still None — but a
        ``ConnectionRefusedError`` means NOTHING is listening on the port
        this worker advertised, which a healthy worker never does. Treat
        refused as dead, or the worker sits stale-READY (and keeps getting
        picked) until the next health tick."""
        w.breaker.record_failure()
        dead = w.transport is not None and w.transport.poll() is not None
        if dead or isinstance(exc, ConnectionRefusedError):
            self._ensure_restart(w)

    # -- health + restart ------------------------------------------------

    def backoff_delay(self, attempt: int) -> float:
        """Exponential restart delay: ``base * 2^attempt`` capped at the
        configured max (attempt 0 = first restart)."""
        return min(
            self.backoff_s * (2 ** max(int(attempt), 0)), self.backoff_max_s
        )

    async def _health_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.health_interval_s)
            for w in list(self.workers):
                await self._check(w)

    async def _check(self, w: WorkerHandle) -> None:
        if w.restarting or w.transport is None:
            return
        if w.transport.poll() is not None:
            # liveness: the process is gone — no probe needed
            self._ensure_restart(w)
            return
        if w.state != READY:
            return
        try:
            await wire.request(
                w.host, w.port, {"op": "ping"},
                timeout=max(self.health_interval_s, 0.25),
            )
        except Exception as exc:  # fault-ok: probe failure IS the signal
            self.note_failure(w, exc)
            return
        if w.breaker.state == "half-open":
            # cooldown elapsed: spend the half-open probe on a canary so
            # the breaker only closes on a PROVEN end-to-end execute
            await self._canary(w)

    async def _canary(self, w: WorkerHandle) -> bool:
        if self.canary is None:
            w.breaker.record_success()
            return True
        graph_name, query = self.canary
        try:
            reply = await wire.request(
                w.host, w.port,
                {"op": "execute", "id": f"canary-{w.worker_id}",
                 "graph": graph_name, "query": query},
                timeout=30.0,
            )
        except Exception as exc:  # fault-ok: canary failure latches the breaker open
            self.note_failure(w, exc)
            return False
        if not reply.get("ok"):
            w.breaker.record_failure()
            return False
        w.breaker.record_success()
        return True

    def _ensure_restart(self, w: WorkerHandle) -> None:
        if w.restarting or self._stopping:
            return
        w.restarting = True
        w.state = DOWN
        self._note_up()
        task = asyncio.ensure_future(self._restart(w))
        self._restart_tasks.add(task)
        task.add_done_callback(self._restart_tasks.discard)

    async def _restart(self, w: WorkerHandle) -> None:
        """Backoff-respawn until the worker proves itself with a canary.
        The attempt counter survives spawn success — only a canary pass
        resets it, so a boot-crash-boot-crash worker keeps backing off."""
        try:
            if w.transport is not None:
                w.transport.kill()
                try:
                    # reap the dead child now; an unreaped transport leaks
                    # pipe cleanup into interpreter shutdown
                    await w.transport.wait_exit(timeout=5.0)
                except Exception:  # fault-ok: reaping is best-effort
                    pass
            while not self._stopping:
                delay = self.backoff_delay(w.restart_attempt)
                await asyncio.sleep(delay)
                try:
                    w.transport = await self.launcher.spawn(w.worker_id)
                    await w.transport.wait_ready(self.ready_timeout_s)
                except Exception:  # fault-ok: failed spawn feeds the backoff
                    w.restart_attempt += 1
                    continue
                w.state = READY
                w.restarts += 1
                WORKER_RESTARTS.inc(worker=w.worker_id)
                self._note_up()
                if await self._canary(w):
                    w.restart_attempt = 0
                    return
                if w.transport.poll() is None:
                    # alive but failing canaries: leave it to the breaker/
                    # health loop rather than kill-looping a warm process
                    return
                w.restart_attempt += 1
                w.state = DOWN
                self._note_up()
        finally:
            w.restarting = False
