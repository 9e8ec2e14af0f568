"""Typed config registry: every ``TPU_CYPHER_*`` knob, declared ONCE.

Re-design of the reference's ``ConfigOption``/``ConfigFlag`` system
(``okapi-api/.../impl/configuration/ConfigOption.scala:31-60``; per-layer
flag objects like ``CoraConfiguration.scala:33-39``): JVM system properties
become environment variables with in-process overrides.

Knobs grew organically — ``ConfigOption``s declared in six modules
plus raw ``os.environ`` reads in four more, with one var
(``TPU_CYPHER_PRINT_TIMINGS``) read through two different paths. This
module is now the SINGLE declaration point: ``declare``/``declare_flag``
register each option in ``REGISTRY`` so the engine's whole configuration
surface is enumerable (``options()``), and the ``env-var-registry`` lint
rule (``tpu_cypher.analysis``) fails any raw ``TPU_CYPHER_*`` read or any
``ConfigOption`` constructed outside this file. Engine modules import
their options from here (often under a local alias, e.g.
``bucketing.MODE is config.BUCKET_MODE``) so existing ``MODE.set(..)``
call sites keep working on the same object.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Generic, Mapping, Optional, TypeVar

T = TypeVar("T")


class ConfigOption(Generic[T]):
    def __init__(
        self,
        name: str,
        default: T,
        parse: Callable[[str], T],
        help: str = "",
    ):
        self.name = name
        self.default = default
        self.parse = parse
        self.help = help
        self._override: Optional[T] = None

    def get(self) -> T:
        if self._override is not None:
            return self._override
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            return self.parse(raw)
        except ValueError:
            return self.default

    def set(self, value: T):
        self._override = value

    def reset(self):
        self._override = None

    @property
    def overridden(self) -> bool:
        """True when the operator pinned this knob explicitly — an
        in-process ``set()`` or a live environment variable. Adaptive
        layers (the cost-based optimizer) treat an overridden knob as a
        hand-tuned constant to respect, and only substitute their own
        modelled value for knobs still at the declared default."""
        return self._override is not None or self.name in os.environ

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"ConfigOption({self.name!r}, default={self.default!r})"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class ConfigFlag(ConfigOption[bool]):
    def __init__(self, name: str, default: bool = False, help: str = ""):
        super().__init__(name, default, _parse_bool, help=help)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, ConfigOption] = {}


def declare(
    name: str,
    default: T,
    parse: Callable[[str], T],
    help: str = "",
) -> ConfigOption[T]:
    """Declare one typed env-backed option. Idempotent per name (repeat
    declarations return the first object so every importer shares override
    state); the name must carry the engine prefix."""
    if name in REGISTRY:
        return REGISTRY[name]
    opt = ConfigOption(name, default, parse, help=help)
    REGISTRY[name] = opt
    return opt


def declare_flag(name: str, default: bool = False, help: str = "") -> ConfigFlag:
    if name in REGISTRY:
        return REGISTRY[name]  # type: ignore[return-value]
    opt = ConfigFlag(name, default, help=help)
    REGISTRY[name] = opt
    return opt


def options() -> Mapping[str, ConfigOption]:
    """Every declared option, by env var name — the engine's enumerable
    configuration surface."""
    return dict(REGISTRY)


# ---------------------------------------------------------------------------
# declarations: the engine's whole TPU_CYPHER_* surface
# ---------------------------------------------------------------------------

# per-stage debug flags (reference PrintTimings / PrintIr / PrintLogicalPlan
# / PrintRelationalPlan, Configuration.scala:36, CoraConfiguration.scala:33-39)
PRINT_TIMINGS = declare_flag(
    "TPU_CYPHER_PRINT_TIMINGS", help="echo per-stage wall timings to stdout"
)
PRINT_IR = declare_flag("TPU_CYPHER_PRINT_IR", help="dump the query IR")
PRINT_LOGICAL = declare_flag(
    "TPU_CYPHER_PRINT_LOGICAL_PLAN", help="dump the logical plan"
)
PRINT_RELATIONAL = declare_flag(
    "TPU_CYPHER_PRINT_RELATIONAL_PLAN", help="dump the relational plan"
)

# shape bucketing + memory admission (backend/tpu/bucketing.py)
BUCKET_MODE = declare(
    "TPU_CYPHER_BUCKET",
    "off",
    str,
    help="materialize-size bucket lattice: off | pow2 | 1.25",
)
MEM_BUDGET = declare(
    "TPU_CYPHER_MEM_BUDGET",
    0,
    int,
    help="HBM budget (bytes) for any single padded materialize; 0 = off",
)

# execution guard (runtime/guard.py)
DEADLINE_S = declare(
    "TPU_CYPHER_QUERY_DEADLINE_S",
    0.0,
    float,
    help="per-query wall deadline in seconds; 0 = none",
)

# deterministic fault injection (runtime/faults.py)
FAULTS = declare(
    "TPU_CYPHER_FAULTS",
    "",
    str,
    help="fault schedule: kind@site[:n|:a-b|:*], comma-separated",
)

# Pallas kernel tier (backend/tpu/pallas/dispatch.py)
PALLAS_MODE = declare(
    "TPU_CYPHER_PALLAS", "auto", str, help="kernel tier: auto | interpret | off"
)

# MXU dense-expand tiers (backend/tpu/expand_op.py)
MXU_DENSE = declare(
    "TPU_CYPHER_MXU_DENSE",
    "auto",
    str,
    help="dense MXU expand: auto | 1 | force | off",
)
MXU_TILED_MAX = declare(
    "TPU_CYPHER_MXU_TILED_MAX",
    1 << 17,
    int,
    help="node-count ceiling for the tiled MXU close-count tier",
)

# MXU dense-adjacency node cap (backend/tpu/graph_index.py dense_adj).
# The effective cap is a CostModel decision (optimizer/cost.py
# mxu_dense_node_cap): a pin here is honored verbatim; otherwise the cap
# is modelled from TPU_CYPHER_MEM_BUDGET when one is set.
MXU_DENSE_MAX = declare(
    "TPU_CYPHER_MXU_DENSE_MAX",
    16384,
    int,
    help="node-count ceiling for the dense MXU adjacency tier "
    "(Npad^2 bf16 per matrix); modelled from the HBM budget unless pinned",
)

# per-kernel Pallas eligibility caps (backend/tpu/pallas/*). Each default
# mirrors the kernel's VMEM working-set budget; the effective cap routes
# through optimizer/cost.pallas_cap so a pin is honored verbatim while the
# unpinned value stays a derived byte-budget decision.
PALLAS_MAX_FRONTIER = declare(
    "TPU_CYPHER_PALLAS_MAX_FRONTIER",
    1 << 18,
    int,
    help="frontier cap for the Pallas expand kernel (resident cum+starts "
    "state, ~8 B per frontier element of a ~2 MiB VMEM budget)",
)
PALLAS_MAX_NODES = declare(
    "TPU_CYPHER_PALLAS_MAX_NODES",
    1 << 20,
    int,
    help="node cap for the Pallas frontier-degree kernel (resident int32 "
    "degree vector, 4 B per node of a ~4 MiB VMEM budget)",
)
PALLAS_MAX_KEYS = declare(
    "TPU_CYPHER_PALLAS_MAX_KEYS",
    1 << 20,
    int,
    help="pow2-padded key cap for the Pallas intersect kernel (two int32 "
    "planes, 8 B per key of an ~8 MiB VMEM budget)",
)
PALLAS_MAX_BUILD = declare(
    "TPU_CYPHER_PALLAS_MAX_BUILD",
    1 << 17,
    int,
    help="build-side cap for the Pallas hash-join kernel (4 int32 table "
    "vectors at load factor 1/2, 32 B per build row of a ~4 MiB budget)",
)
PALLAS_MAX_GROUPS = declare(
    "TPU_CYPHER_PALLAS_MAX_GROUPS",
    256,
    int,
    help="GROUP BY cardinality cap for the Pallas segment-aggregate "
    "kernel (the (k_pad, block) compare matrix budget)",
)

# worst-case-optimal multiway join (backend/tpu/wcoj.py)
WCOJ_MODE = declare(
    "TPU_CYPHER_WCOJ",
    "auto",
    str,
    help="cyclic-pattern multiway intersection: auto (EmptyHeaded-style "
    "eligibility from degree stats) | force | off",
)
WCOJ_MIN_ROWS = declare(
    "TPU_CYPHER_WCOJ_MIN_ROWS",
    4096,
    int,
    help="auto mode routes a cyclic pattern to WCOJ only when the "
    "estimated binary-join intermediate exceeds this many rows",
)

# factorized join intermediates (backend/tpu/factorized.py)
FACTORIZE = declare(
    "TPU_CYPHER_FACTORIZE",
    "auto",
    str,
    help="compressed (prefix x suffix-run) materialize tier for expand and "
    "multiway-join intermediates: auto (only when the flat row set would "
    "bust the admission budget) | force | off",
)
FACTORIZE_CHUNK_ROWS = declare(
    "TPU_CYPHER_FACTORIZE_CHUNK_ROWS",
    131072,
    int,
    help="logical rows decompressed per chunk when a factorized table is "
    "enumerated (collect / one-shot flatten); floor 1024",
)

# cost-based adaptive query optimizer (optimizer/). The port defaults to
# syntax order until its statistics and cost model are ported and tested
# against the CUDA backend (ROADMAP.md queue 1, item 4).
OPT_MODE = declare(
    "TPU_CYPHER_OPT",
    "syntax",
    str,
    help="cost-based join-order optimizer: auto (apply the padded-lattice "
    "cost model's plan when it predicts a win) | syntax (keep the "
    "syntax-driven order) | force (always apply the "
    "model's chosen order, even on ties; differential tests)",
)
OPT_DP_MAX_RELS = declare(
    "TPU_CYPHER_OPT_DP_MAX_RELS",
    8,
    int,
    help="pattern-size ceiling for exact DP join-order enumeration over "
    "connected subpatterns; larger patterns use the greedy fallback",
)
OPT_MARGIN = declare(
    "TPU_CYPHER_OPT_MARGIN",
    0.9,
    float,
    help="auto mode applies a reordered plan only when its modelled cost "
    "is below margin x the syntax-order cost (hysteresis against churning "
    "plans on estimate noise); force ignores the margin",
)
OPT_FEEDBACK = declare(
    "TPU_CYPHER_OPT_FEEDBACK",
    "on",
    str,
    help="adaptive feedback: fold result.profile() span timings and "
    "true-vs-padded row counts back into per-graph calibration factors "
    "(persisted beside the compile cache): on | off",
)

# sharded shuffle (parallel/shuffle.py)
BROADCAST_LIMIT = declare(
    "TPU_CYPHER_BROADCAST_LIMIT",
    4096,
    int,
    help="max rows broadcast to every shard instead of hash-shuffled",
)

# mesh execution (parallel/mesh.py): table algebra runs mesh-native when a
# mesh is active — either via parallel.mesh.use_mesh / CypherSession.tpu(
# mesh=...) or the TPU_CYPHER_MESH env default below
MESH_SPEC = declare(
    "TPU_CYPHER_MESH",
    "",
    str,
    help="default engine mesh: '' / 'off' = single device; 'auto' / 'all' "
    "= one row-sharding mesh over every visible device; an integer N = "
    "mesh over the first N devices",
)
MESH_AGG = declare(
    "TPU_CYPHER_MESH_AGG",
    "auto",
    str,
    help="sharded segment aggregates / distinct-count tier while a mesh "
    "is active: auto (integer data only, bit-identical psum combine) | off",
)
MESH_WCOJ = declare(
    "TPU_CYPHER_MESH_WCOJ",
    "auto",
    str,
    help="sharded WCOJ count tier: each shard range-counts its local "
    "slice of the sorted edge_keys and counts psum-combine: auto | off",
)

# persistent compile cache (relational/session.py)
COMPILE_CACHE_DIR = declare(
    "TPU_CYPHER_COMPILE_CACHE_DIR",
    "",
    str,
    help="persistent XLA compile cache directory; empty = disabled",
)

# multi-tenant query server (serve/): the asyncio front end that admits,
# schedules, and micro-batches concurrent queries on one warm engine
SERVE_PORT = declare(
    "TPU_CYPHER_SERVE_PORT",
    7687,
    int,
    help="query-server TCP port (0 = ephemeral, for tests)",
)
SERVE_MAX_CONCURRENT = declare(
    "TPU_CYPHER_SERVE_MAX_CONCURRENT",
    8,
    int,
    help="max queries executing concurrently; the rest wait in the "
    "cost-ordered admission queue",
)
SERVE_BATCH_WINDOW_MS = declare(
    "TPU_CYPHER_SERVE_BATCH_WINDOW_MS",
    2.0,
    float,
    help="micro-batch coalescing window: same-bucket queries arriving "
    "within it share one device dispatch; 0 = batching off",
)
SERVE_TENANT_QUOTA = declare(
    "TPU_CYPHER_SERVE_TENANT_QUOTA",
    0,
    int,
    help="max in-flight queries per tenant; 0 = no quota (fair-share only)",
)

# fault-isolated multi-process serving (serve/cluster.py): a router fans
# requests out to N supervised engine-worker processes so one libtpu abort
# never takes down every tenant
SERVE_WORKERS = declare(
    "TPU_CYPHER_SERVE_WORKERS",
    0,
    int,
    help="supervised engine-worker processes behind the router; "
    "0 = single-process in-session serving",
)
SERVE_BREAKER_THRESHOLD = declare(
    "TPU_CYPHER_SERVE_BREAKER_THRESHOLD",
    3,
    int,
    help="consecutive worker failures that open its circuit breaker",
)
SERVE_BREAKER_COOLDOWN_S = declare(
    "TPU_CYPHER_SERVE_BREAKER_COOLDOWN_S",
    1.0,
    float,
    help="seconds an open breaker waits before half-open canary probing",
)
SERVE_RESTART_BACKOFF_S = declare(
    "TPU_CYPHER_SERVE_RESTART_BACKOFF_S",
    0.25,
    float,
    help="initial supervisor restart delay for a crashed worker; doubles "
    "per consecutive failure",
)
SERVE_RESTART_BACKOFF_MAX_S = declare(
    "TPU_CYPHER_SERVE_RESTART_BACKOFF_MAX_S",
    5.0,
    float,
    help="exponential restart backoff cap (seconds)",
)
SERVE_HEALTH_INTERVAL_S = declare(
    "TPU_CYPHER_SERVE_HEALTH_INTERVAL_S",
    0.5,
    float,
    help="supervisor liveness/readiness probe period (seconds)",
)
SERVE_DRAIN_TIMEOUT_S = declare(
    "TPU_CYPHER_SERVE_DRAIN_TIMEOUT_S",
    30.0,
    float,
    help="graceful-drain budget: in-flight queries finish, new submits "
    "are rejected typed, workers exit",
)
SERVE_HEDGE_MS = declare(
    "TPU_CYPHER_SERVE_HEDGE_MS",
    0.0,
    float,
    help="hedged-dispatch delay: a read still unanswered after this many "
    "ms is duplicated to a second replica (first reply wins); 0 = off",
)
SERVE_QUEUE_HIGH = declare(
    "TPU_CYPHER_SERVE_QUEUE_HIGH",
    0,
    int,
    help="admission queue-depth shed watermark: deeper queues reject new "
    "queries typed before queueing; 0 = off",
)
SERVE_RETRY_MAX = declare(
    "TPU_CYPHER_SERVE_RETRY_MAX",
    2,
    int,
    help="max replica retries of an idempotent read after WorkerLost",
)

# zero-dispatch result cache + backpressured cursor streaming (serve/)
SERVE_CACHE_BYTES = declare(
    "TPU_CYPHER_SERVE_CACHE_BYTES",
    64 << 20,
    int,
    help="byte budget of the serving-tier result cache (host-side encoded "
    "row pages, LRU-evicted); 0 = cache off",
)
SERVE_STREAM_WINDOW = declare(
    "TPU_CYPHER_SERVE_STREAM_WINDOW",
    4,
    int,
    help="cursor-stream credit window: row pages the server may send "
    "ahead of client 'next' credits before backpressure blocks the cursor",
)

# transactional mutation (storage/): write-ahead-log durability and
# delta-overlay compaction (docs/mutation.md)
WAL_DIR = declare(
    "TPU_CYPHER_WAL_DIR",
    "",
    str,
    help="write-ahead log directory; empty = derive '<compile cache>/wal' "
    "when a persistent compile cache is configured, else mutations are "
    "in-memory only (no durability)",
)
WAL_SYNC = declare(
    "TPU_CYPHER_WAL_SYNC",
    "fsync",
    str,
    help="WAL commit durability: fsync (default, survives SIGKILL and "
    "power loss) | flush (OS buffers only: survives SIGKILL, not power "
    "loss) | off (test-only, no flush at commit)",
)
COMPACT_DELTA_MAX = declare(
    "TPU_CYPHER_COMPACT_DELTA_MAX",
    256,
    int,
    help="delta-overlay row threshold: a committed batch leaving more "
    "than this many live+tombstone delta rows triggers compaction into a "
    "fresh immutable base",
)
COMPACT_MIN_BUCKET = declare(
    "TPU_CYPHER_COMPACT_MIN_BUCKET",
    8,
    int,
    help="minimum row bucket a delta-overlay table is host-padded to when "
    "shape bucketing is on, so small deltas share one program shape "
    "across write batches",
)

# observability (obs/metrics.py, utils/profiling.py, obs/trace.py)
METRICS_FILE = declare(
    "TPU_CYPHER_METRICS_FILE",
    "",
    str,
    help="JSON-lines per-query event sink; empty = disabled",
)
PROFILE_DIR = declare(
    "TPU_CYPHER_PROFILE_DIR",
    "",
    str,
    help="jax.profiler trace directory; also annotates spans",
)
