"""Padded-lattice cost model: one estimator behind every routing choice.

Costs are computed in **padded** rows, not true rows: every operator's
device work is a function of its bucketed shapes (``analysis.shapes.predict_padded``
is the lattice's rounding, pinned equal to the one ``round_size`` applies at run time),
so composing ``round_size`` over candidate plans prices exactly the rows
the device will be asked to hold — and makes two plans with the same
bucket sequence provably the same cost.

Mesh-awareness: with an active device mesh the unit of work is the
per-shard padded shape times the shard count, plus a cross-shard term for
operators that imply a shuffle/psum — this is the "mesh-aware plan
costing" item the mesh-native tables left open.

The heuristics this module subsumes (each keeps its env knob as a
hand override, detected via ``ConfigOption.overridden``):

* ``wcoj.py`` routing — :func:`wcoj_threshold` / :func:`prefer_wcoj`
  replace the fixed ``TPU_CYPHER_WCOJ_MIN_ROWS`` comparison with a
  calibration-scaled threshold;
* ``serve/scheduler.estimate_cost_bytes`` — :func:`estimate_query_cost_bytes`
  prices admission from real cardinalities when statistics exist;
* ``parallel/shuffle.broadcast_join`` — :func:`broadcast_build_limit`
  extends the broadcast window past ``TPU_CYPHER_BROADCAST_LIMIT`` when
  the modelled replication cost still beats a hash repartition (it never
  *shrinks* the window below the declared limit);
* join-order search (``joinorder.py``) composes :class:`CostModel` steps
  instead of trusting syntax order;
* MXU tier gating — :func:`mxu_dense_node_cap` (modelled from the HBM
  budget when one is set) and :func:`mxu_tiled_node_cap` replace the
  fixed node caps in ``graph_index.dense_adj`` / ``expand_op``;
* kernel eligibility — :func:`pallas_cap` gives each Hopper kernel's size
  cap (``backend/cuda/hopper/*``), which a pinned knob may only lower.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..utils.config import (
    BROADCAST_LIMIT,
    MEM_BUDGET,
    MXU_DENSE_MAX,
    MXU_TILED_MAX,
    PALLAS_MAX_BUILD,
    PALLAS_MAX_FRONTIER,
    PALLAS_MAX_GROUPS,
    PALLAS_MAX_KEYS,
    PALLAS_MAX_NODES,
    WCOJ_MIN_ROWS,
)
from .stats import GraphStatistics

# generic selectivity of one residual filter predicate (no value-level
# statistics yet; only relative plan ranking needs it)
FILTER_SELECTIVITY = 0.75

# cross-shard traffic is priced at a multiple of local row work: a shuffle
# moves rows over ICI, which the scaling bench shows is worth a few local
# touches per row
SHUFFLE_WEIGHT = 4.0

# calibration-scaled WCOJ threshold is clipped to this window so one noisy
# profile can never push routing to an always/never extreme
_WCOJ_CLIP = (512, 65536)


def padded_rows(n) -> int:
    """True row count -> padded row count on the runtime lattice. Uses the
    pure shape-facts predictor (pinned equal to ``bucketing.round_size``
    by the agreement test) rather than ``round_size`` itself, because the
    runtime function stamps every call's true/padded pair on the enclosing
    trace span — estimator what-ifs must not pollute measured profiles.
    ``tests/test_torch_shapes.py`` pins it, ``bucketing.predict_padded``
    and ``round_size`` equal in every mode."""
    from ..analysis.shapes import predict_padded
    from ..backend.cuda import bucketing

    return int(predict_padded(max(int(n), 0), bucketing.mode()))


def _mesh_size() -> int:
    from ..parallel.mesh import mesh_size

    return int(mesh_size())


class CostModel:
    """Prices logical plan steps over one graph's statistics.

    Every step method returns ``(est_rows_out, cost)`` where ``cost`` is
    abstract padded-row work (comparable only within one model instance).
    Calibration factors — measured seconds per padded kilorow per operator
    class — skew the weights once feedback has samples; with no samples
    every weight is 1.0 and the model is purely structural.
    """

    def __init__(self, graph, ctx, calibration=None):
        self.stats = GraphStatistics.of(graph, ctx)
        if calibration is None:
            from . import feedback

            calibration = feedback.get(graph, ctx)
        self.cal = calibration
        self.nsh = _mesh_size()
        # plan steps this model priced at the factorized (run-compressed)
        # lane extent instead of the flat row product — exported through
        # joinorder's ``join_order`` span note for plan introspection
        self.factorized_steps = 0

    # -- mesh-aware work units -------------------------------------------

    def work(self, n_rows) -> float:
        """Device work for touching ``n_rows`` once: the per-shard padded
        shape times the shard count (sharding rounds per shard, so small
        relations on big meshes still pay the bucket floor per shard)."""
        if self.nsh <= 1:
            return float(padded_rows(n_rows))
        per = padded_rows((int(n_rows) + self.nsh - 1) // self.nsh)
        return float(per * self.nsh)

    def shuffle(self, n_rows) -> float:
        """Cross-shard movement term; zero without a mesh."""
        if self.nsh <= 1:
            return 0.0
        return SHUFFLE_WEIGHT * float(padded_rows(n_rows))

    def _w(self, op_class: str) -> float:
        return float(self.cal.weight(op_class)) if self.cal is not None else 1.0

    # -- plan steps ------------------------------------------------------

    def scan(self, labels=()) -> Tuple[float, float]:
        est = float(self.stats.node_count(labels))
        return est, self._w("scan") * self.work(est)

    def expand(
        self, est_in: float, types=(), reverse: bool = False, target_labels=()
    ) -> Tuple[float, float]:
        """Expand one hop from ``est_in`` bound rows: output is fanout
        times label selectivity of the far endpoint; cost touches both the
        input frontier and the (padded) output."""
        fanout = self.stats.avg_degree(types, reverse)
        est_out = est_in * fanout * self.stats.label_selectivity(target_labels)
        if prefer_factorized(est_out, 9):
            # factorized materialize touches the lane (prefix) extent,
            # never the flat product: device work is the input frontier
            # plus the run-bound gather over the same lanes
            self.factorized_steps += 1
            cost = self._w("expand") * (2.0 * self.work(est_in))
            return est_out, cost + self.shuffle(est_in)
        cost = self._w("expand") * (self.work(est_in) + self.work(est_out))
        return est_out, cost + self.shuffle(est_out)

    def expand_into(self, est_in: float, types=()) -> Tuple[float, float]:
        """Close an edge between two already-bound endpoints: selectivity
        is the edge probability ``rels / nodes²`` applied to the candidate
        pairs already in the row set."""
        n = max(self.stats.node_count(()), 1)
        sel = self.stats.rel_count(types) / float(n * n)
        est_out = est_in * min(sel, 1.0)
        cost = self._w("expand_into") * (self.work(est_in) + self.work(est_out))
        return est_out, cost

    def filter(self, est_in: float) -> Tuple[float, float]:
        est_out = est_in * FILTER_SELECTIVITY
        return est_out, self._w("filter") * self.work(est_in)


# -- WCOJ routing (subsumes the TPU_CYPHER_WCOJ_MIN_ROWS constant) --------


def wcoj_threshold(graph, ctx) -> int:
    """Binary-expand row-count estimate above which the multiway
    intersect (WCOJ) tier is routed. When the operator pinned
    ``TPU_CYPHER_WCOJ_MIN_ROWS`` the pin wins verbatim; otherwise the
    declared default is scaled by the measured seconds-per-padded-kilorow
    ratio of the intersect tier vs. the binary tier on THIS graph —
    a relatively slow intersect kernel raises the bar, a fast one lowers
    it. With no profile samples the scale is 1.0, i.e. exactly the
    hand-tuned default."""
    if WCOJ_MIN_ROWS.overridden:
        return int(WCOJ_MIN_ROWS.get())
    base = int(WCOJ_MIN_ROWS.default)
    scale = 1.0
    try:
        from . import feedback

        cal = feedback.get(graph, ctx)
        if cal is not None:
            scale = cal.wcoj_scale()
    except Exception as exc:
        from ..errors import reraise_if_device

        reraise_if_device(exc, site="optimizer.wcoj_threshold")
    lo, hi = _WCOJ_CLIP
    return max(lo, min(hi, int(base * scale)))


def prefer_wcoj(est_rows: int, graph, ctx) -> bool:
    """True when the modelled binary-expand blowup justifies the WCOJ
    tier for this graph."""
    return int(est_rows) > wcoj_threshold(graph, ctx)


# -- factorized materialize routing (backend/cuda/factorized.py) ----------


def factorized_rows(lanes: int) -> int:
    """Padded physical size of a factorized intermediate: the *lane*
    (prefix) extent on the runtime lattice — the sum of run counts, not
    the run-product. This is the quantity a factorized materialize pays
    admission for; the flat row product never exists on device."""
    return padded_rows(lanes)


def flat_materialize_busts(flat_rows, bytes_per_row: int) -> bool:
    """True when a flat materialize of ``flat_rows`` would bust the
    memory budget that ``bucketing.admit`` enforces — the same padded
    bytes-per-row arithmetic, run as a what-if instead of a raise. With
    no budget configured nothing busts (admission is wide open)."""
    from ..backend.cuda import bucketing

    budget = bucketing.memory_budget_bytes()
    if budget <= 0:
        return False
    eff = (int(flat_rows) + _mesh_size() - 1) // max(_mesh_size(), 1)
    return padded_rows(eff) * int(bytes_per_row) > budget


def factorized_routing_enabled() -> bool:
    """Cheap pre-gate for producers: can ``prefer_factorized`` possibly
    answer True without knowing the flat estimate? ``off`` → no; ``auto``
    with no admission budget → no (nothing busts a wide-open budget), so
    the default configuration pays ZERO per-expand work — no run-bounds
    program, no row-total sync — for the factorized route."""
    from ..utils.config import FACTORIZE

    mode = str(FACTORIZE.get()).strip().lower()
    if mode == "force":
        return True
    if mode == "off":
        return False
    from ..backend.cuda import bucketing

    return bucketing.memory_budget_bytes() > 0


def prefer_factorized(flat_rows, bytes_per_row: int) -> bool:
    """Route one materialize to the factorized (run-compressed) form.

    ``TPU_CYPHER_FACTORIZE=force`` always routes it, ``off`` never does;
    ``auto`` (default) chooses factorized exactly when the flat estimate
    busts the admission budget — the case that used to decline to the
    flat shadow tier or record an over-budget bench skip."""
    from ..utils.config import FACTORIZE

    mode = str(FACTORIZE.get()).strip().lower()
    if mode == "force":
        return True
    if mode == "off":
        return False
    return flat_materialize_busts(flat_rows, bytes_per_row)


# -- broadcast-vs-hash join window (parallel/shuffle.py) ------------------


def broadcast_build_limit(n_l: int, nsh: int) -> int:
    """Build-side row ceiling for a broadcast join given a probe side of
    ``n_l`` rows on ``nsh`` shards. Broadcasting replicates the build side
    to every shard (cost ≈ nsh × padded(build)); a hash repartition moves
    both sides once (cost ≈ padded(probe) + padded(build)); the crossover
    is ``padded(probe) / (nsh - 1)``. The returned limit only ever
    *extends* the declared ``TPU_CYPHER_BROADCAST_LIMIT`` window — and an
    operator pin of that knob is honoured verbatim."""
    limit = int(BROADCAST_LIMIT.get())
    if BROADCAST_LIMIT.overridden:
        return limit
    crossover = padded_rows(n_l) // max(int(nsh) - 1, 1)
    return max(limit, min(crossover, 1 << 20))


# -- MXU tier node caps (backend/tpu/graph_index.py, expand_op.py) --------


def mxu_dense_node_cap() -> int:
    """Node-count ceiling for the dense MXU adjacency tier
    (``GraphIndex.dense_adj``: one bf16[(Npad, Npad)] matrix per cached
    orientation). A ``TPU_CYPHER_MXU_DENSE_MAX`` pin wins verbatim.
    Otherwise, with an HBM budget set (``TPU_CYPHER_MEM_BUDGET``) the cap
    is the largest DENSE_BLOCK multiple whose padded matrix fits a quarter
    of the budget at 2 bytes/cell — the same byte-budget reasoning every
    materialize admission runs — clipped so one extreme budget cannot
    route absurd sizes; with no budget the declared default stands."""
    if MXU_DENSE_MAX.overridden:
        return int(MXU_DENSE_MAX.get())
    default = int(MXU_DENSE_MAX.default)
    budget = int(MEM_BUDGET.get())
    if budget <= 0:
        return default
    block = 256  # GraphIndex.DENSE_BLOCK
    # Npad^2 * 2 B (bf16) <= budget / 4, Npad a block multiple
    npad = int((budget / 8) ** 0.5) // block * block
    return max(block, min(npad, 1 << 16))


def mxu_tiled_node_cap() -> int:
    """Node-count ceiling for the TILED MXU close-count tier (row-block
    tiles, no full dense matrix — the cap bounds total FLOPs, not memory).
    ``TPU_CYPHER_MXU_TILED_MAX`` is honored whether pinned or defaulted;
    routing through the cost model keeps the gate a single decision
    point beside the dense cap it backstops."""
    return int(MXU_TILED_MAX.get())


# -- Hopper kernel eligibility caps (backend/cuda/hopper/*) ---------------

# kernel -> (knob, the largest size its CUDA kernel takes on the H100).
# The reference's caps are VMEM working-set budgets (2-8 MiB tables); none
# of these kernels keeps such a table on chip, so each limit comes from
# the kernel's own index arithmetic instead:
# * expand: frontier rows; the degree scan and row starts are int32
#   (csrc/expand_rows.cu), so a frontier stays below 2**31 - 1;
# * frontier: the node count; the kernel reads row_ptr from device memory
#   and sums in int64, so nothing bounds it (2**62 stands for "any");
# * intersect: sorted keys; bucket starts and record offsets are int32
#   (csrc/range_count.cu);
# * join: build rows; the open-addressing table holds a power of two of at
#   least twice the rows, and its slot index is 32-bit (csrc/hash_probe.cu);
# * aggregate: groups; a block keeps one accumulator per group in shared
#   memory, sized for kMaxGroups = 256 (csrc/segment_reduce.cu).
# Each knob's declared default is that limit, so an unpinned cap is the
# kernel's; a pin can lower a cap, never raise it past the limit.
_HOPPER_CAPS = {
    "expand": (PALLAS_MAX_FRONTIER, 2**31 - 2),
    "frontier": (PALLAS_MAX_NODES, 2**62),
    "intersect": (PALLAS_MAX_KEYS, 2**31 - 1),
    "join": (PALLAS_MAX_BUILD, 2**30),
    "aggregate": (PALLAS_MAX_GROUPS, 256),
}


def pallas_cap(kernel: str) -> int:
    """Eligibility size cap of one Hopper kernel (``hopper/*.py`` reads
    it per call): a ``TPU_CYPHER_PALLAS_MAX_*`` value, clipped to what the
    kernel takes."""
    knob, limit = _HOPPER_CAPS[kernel]
    return max(0, min(int(knob.get()), limit))


# -- serve admission (serve/scheduler.estimate_cost_bytes) ----------------


def estimate_query_cost_bytes(
    graph, query: str, *, fallback_rows: int, bytes_per_row: int
) -> int:
    """Admission-control byte estimate for one query text. When the graph
    already carries statistics (any prior optimized query), the hop count
    is priced through real average fanout instead of the legacy
    rows × (hops + 1) proxy; the result stays on the padded lattice so
    admission and execution agree on shapes."""
    hops = query.count("]")
    legacy = float(max(int(fallback_rows), 1) * (hops + 1))
    est = legacy
    stats: Optional[GraphStatistics] = getattr(
        graph, "_tpu_cypher_opt_stats", None
    )
    if stats is not None:
        fed = float(max(stats.node_count(()), 1))
        fanout = max(stats.avg_degree(()), 1.0)
        for _ in range(hops):
            fed = min(fed * fanout, 1e15)
        # additive over the legacy proxy: keeps the estimate strictly
        # monotone in pattern fan-out even on fanout<=1 graphs, which is
        # the ordering contract admission relies on
        est = legacy + fed
    return padded_rows(min(est, 1e15)) * int(bytes_per_row)
