"""Adaptive feedback: fold measured query profiles back into the model.

Every successfully executed traced query already stamps, per operator
span, the wall seconds and the true-vs-padded row pair (``obs/trace.py``).
This module reduces those spans to per-operator-class EMAs of

* **seconds per padded kilorow** — the empirical unit cost the
  :class:`~tpu_cypher.optimizer.cost.CostModel` weights with, and the
  ratio behind the measured WCOJ threshold;
* **occupancy** (true rows / padded rows) — how much of the padded work
  was real, surfaced in diagnostics.

Calibrations are **per graph**, keyed by the statistics fingerprint, and
persisted as one small JSON beside the compile cache
(``<TPU_CYPHER_COMPILE_CACHE_DIR>/optimizer_calibration.json``) so a
restarted process resumes with its measured weights; without a persistent
cache dir they are process-local. Everything here is advisory: any
failure degrades to the uncalibrated model (weights 1.0) and never takes
down the query that produced the profile.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from ..utils.config import OPT_FEEDBACK

# EMA smoothing: one observation moves the estimate 20% of the way
_ALPHA = 0.2
# operator classes whose per-krow cost is compared against the multiway
# intersect tier to place the measured WCOJ threshold
_BINARY_EXPAND_CLASSES = ("CsrExpandOp", "CsrExpandIntoOp")
_WCOJ_CLASS = "MultiwayIntersectOp"
_PERSIST_NAME = "optimizer_calibration.json"

_LOCK = threading.Lock()
_STORE: Dict[str, "Calibration"] = {}
_LOADED_DIRS: set = set()


class Calibration:
    """Per-graph learned unit costs. All reads are safe with zero samples
    (they return the neutral 1.0)."""

    def __init__(self):
        # op class -> [ema seconds-per-padded-kilorow, samples]
        self.sec_per_krow: Dict[str, list] = {}
        # op class -> [ema true/padded occupancy, samples]
        self.occ: Dict[str, list] = {}

    # -- updates ---------------------------------------------------------

    def observe_span(
        self, op_class: str, seconds: float, rows_padded: int, rows_true: int
    ) -> None:
        if seconds <= 0.0 or rows_padded <= 0:
            return
        krow = rows_padded / 1000.0
        self._ema(self.sec_per_krow, op_class, seconds / krow)
        self._ema(self.occ, op_class, min(rows_true / rows_padded, 1.0))

    @staticmethod
    def _ema(table: Dict[str, list], key: str, value: float) -> None:
        got = table.get(key)
        if got is None:
            table[key] = [float(value), 1]
        else:
            got[0] += _ALPHA * (float(value) - got[0])
            got[1] += 1

    # -- reads -----------------------------------------------------------

    def samples(self) -> int:
        return sum(n for _, n in self.sec_per_krow.values())

    def unit_cost(self, op_class: str) -> Optional[float]:
        got = self.sec_per_krow.get(op_class)
        return got[0] if got else None

    def occupancy(self, op_class: str) -> Optional[float]:
        got = self.occ.get(op_class)
        return got[0] if got else None

    def weight(self, op_class: str) -> float:
        """Measured cost of one padded row of ``op_class`` relative to the
        mean over all measured classes; 1.0 until both sides have data.
        Clipped so a single noisy profile cannot invert plan ranking."""
        mine = self.unit_cost(op_class)
        if mine is None or not self.sec_per_krow:
            return 1.0
        mean = sum(v[0] for v in self.sec_per_krow.values()) / len(
            self.sec_per_krow
        )
        if mean <= 0.0:
            return 1.0
        return max(0.25, min(4.0, mine / mean))

    def wcoj_scale(self) -> float:
        """Multiplier on the declared WCOJ row threshold: the measured
        per-padded-krow cost of the intersect tier over the binary expand
        tier. Intersect measured slower -> threshold rises (route later);
        faster -> drops (route earlier). 1.0 until both tiers have
        samples, which makes the uncalibrated decision identical to the
        hand-tuned ``TPU_CYPHER_WCOJ_MIN_ROWS`` default."""
        wcoj = self.unit_cost(_WCOJ_CLASS)
        bins = [
            self.unit_cost(c)
            for c in _BINARY_EXPAND_CLASSES
            if self.unit_cost(c) is not None
        ]
        if wcoj is None or not bins:
            return 1.0
        binary = sum(bins) / len(bins)
        if binary <= 0.0:
            return 1.0
        return max(0.25, min(8.0, wcoj / binary))

    # -- (de)serialization ----------------------------------------------

    def to_json(self) -> dict:
        return {"sec_per_krow": self.sec_per_krow, "occ": self.occ}

    @staticmethod
    def from_json(data: dict) -> "Calibration":
        cal = Calibration()
        for field in ("sec_per_krow", "occ"):
            table = getattr(cal, field)
            for k, v in (data.get(field) or {}).items():
                if (
                    isinstance(v, list)
                    and len(v) == 2
                    and isinstance(v[0], (int, float))
                ):
                    table[str(k)] = [float(v[0]), int(v[1])]
        return cal


# ---------------------------------------------------------------------------
# per-graph store + persistence
# ---------------------------------------------------------------------------


def _persist_path() -> Optional[str]:
    from ..backend.cuda import bucketing

    cache_dir = bucketing.persistent_cache_dir()
    if not cache_dir:
        return None
    return os.path.join(cache_dir, _PERSIST_NAME)


def _load_dir(path: str) -> None:
    """Merge the persisted calibration file into the in-memory store once
    per directory; in-memory entries win (they are newer)."""
    if path in _LOADED_DIRS:
        return
    _LOADED_DIRS.add(path)
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        for fp, entry in (data or {}).items():
            if fp not in _STORE and isinstance(entry, dict):
                _STORE[fp] = Calibration.from_json(entry)
    except (OSError, ValueError):  # fault-ok: missing/corrupt calibration file just means an uncalibrated start
        pass


def _save(path: str) -> None:
    tmp = path + ".tmp"
    payload = {fp: cal.to_json() for fp, cal in _STORE.items()}
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, sort_keys=True)
    os.replace(tmp, path)


def _fingerprint(graph, ctx) -> str:
    from .stats import GraphStatistics

    try:
        return GraphStatistics.of(graph, ctx).fingerprint()
    except Exception as exc:
        from ..errors import reraise_if_device

        reraise_if_device(exc, site="optimizer.feedback")
        return "default"


def get(graph, ctx) -> Calibration:
    """The calibration for this graph (by statistics fingerprint),
    loading any persisted state on first touch."""
    fp = _fingerprint(graph, ctx)
    with _LOCK:
        path = _persist_path()
        if path:
            _load_dir(path)
        cal = _STORE.get(fp)
        if cal is None:
            cal = _STORE[fp] = Calibration()
        return cal


def observe(trace, graph, ctx) -> None:
    """Fold one finished query trace into the graph's calibration.
    Called from the session's success path; must never raise into it."""
    if OPT_FEEDBACK.get().strip().lower() != "on" or trace is None:
        return
    try:
        spans = trace.spans()
    except Exception:  # fault-ok: a malformed trace only costs this one calibration update
        return
    updates = []
    for sp in spans:
        if getattr(sp, "kind", None) != "operator":
            continue
        padded = int(sp.attrs.get("rows_padded", 0) or 0)
        true = int(sp.attrs.get("rows_true", 0) or 0)
        if padded <= 0 or sp.seconds <= 0.0:
            continue
        updates.append((sp.name, float(sp.seconds), padded, true))
    if not updates:
        return
    try:
        cal = get(graph, ctx)
        with _LOCK:
            for name, seconds, padded, true in updates:
                cal.observe_span(name, seconds, padded, true)
            path = _persist_path()
            if path:
                _save(path)
    except Exception as exc:
        from ..errors import reraise_if_device

        reraise_if_device(exc, site="optimizer.feedback")


def reset_for_tests() -> None:
    """Drop all in-memory calibration state (tests only)."""
    with _LOCK:
        _STORE.clear()
        _LOADED_DIRS.clear()
