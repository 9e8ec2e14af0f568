"""Cost-based, statistics-fed adaptive query optimizer.

One padded-lattice cost model (``cost.py``) over per-graph statistics
(``stats.py``), searched by a bounded join-order enumerator
(``joinorder.py``) and sharpened by measured query profiles
(``feedback.py``). Replaces the engine's four ad-hoc routing heuristics
— WCOJ row threshold, serve admission bytes, broadcast-join window, and
syntax-driven join order — with one estimator; each old env knob remains
as a hand override.
"""

from .cost import (
    CostModel,
    broadcast_build_limit,
    estimate_query_cost_bytes,
    padded_rows,
    prefer_wcoj,
    wcoj_threshold,
)
from .feedback import Calibration, get as get_calibration, observe
from .joinorder import maybe_reorder
from .stats import GraphStatistics

__all__ = [
    "Calibration",
    "CostModel",
    "GraphStatistics",
    "broadcast_build_limit",
    "estimate_query_cost_bytes",
    "get_calibration",
    "maybe_reorder",
    "observe",
    "padded_rows",
    "prefer_wcoj",
    "wcoj_threshold",
]
