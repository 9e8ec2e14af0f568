"""Shape bucketing, memory admission and kernel-build telemetry.

The port of ``tpu_cypher/backend/tpu/bucketing.py``. The lattice
(``round_size``) and the pre-flight admission (``admit``) are unchanged:
a data-dependent materialize size rounds up the ``TPU_CYPHER_BUCKET``
lattice (``off`` by default), with the true count carried beside it and
pad lanes masked dead. PyTorch runs eagerly, so there is no compiled
program per shape to save; the lattice stays for parity (the pad-lane
discipline is what the kernels' tests pin) and for admission estimates.

The JAX compile listener becomes a count of kernel builds: every
``nvcc`` build of a ``csrc/`` source reports here (``note_build``), and
``result.compile_stats`` carries the builds that happened while a query
ran. The persistent cache directory only anchors the optimizer's
calibration file (``optimizer/feedback.py``).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional

import numpy as np

from ...obs import trace as _obs_trace
from ...obs.metrics import REGISTRY as _REGISTRY
from ...utils.config import BUCKET_MODE as MODE
from ...utils.config import MEM_BUDGET

# smallest nonzero bucket: tiny intermediates all share one shape
_BUCKET_FLOOR = 32

# 2^62: sorts/compares above every real element id or probe key (graph tags
# live at bits 54+); the pad sentinel for id-sorted device arrays
ID_SENTINEL = np.int64(1) << 62


def mode() -> str:
    m = MODE.get().strip().lower()
    return m if m in ("off", "pow2", "1.25") else "off"


def enabled() -> bool:
    return mode() != "off"


def round_up_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length() if n > 1 else 1


_LATTICE_125 = [_BUCKET_FLOOR]
_LATTICE_LOCK = threading.Lock()


def _round_125(n: int) -> int:
    with _LATTICE_LOCK:
        while _LATTICE_125[-1] < n:
            prev = _LATTICE_125[-1]
            _LATTICE_125.append(max(prev + 1, int(prev * 1.25)))
        return _LATTICE_125[bisect.bisect_left(_LATTICE_125, n)]


def predict_padded(n: int, m: str = "pow2") -> int:
    """The padded extent ``round_size`` produces for a true count ``n``
    under lattice ``m``, without recording telemetry — the optimizer's
    what-if estimates must not pollute measured profiles."""
    n = int(n)
    if n <= 0:
        return 0
    if m == "off":
        return n
    if m == "1.25":
        return _round_125(n)
    return round_up_pow2(n, _BUCKET_FLOOR)


_ROWS_TRUE = _REGISTRY.counter(
    "tpu_cypher_bucket_rows_true_total",
    "true (pre-pad) rows across bucketed materializes",
)
_ROWS_PADDED = _REGISTRY.counter(
    "tpu_cypher_bucket_rows_padded_total",
    "padded (post-lattice) rows across bucketed materializes",
)


def round_size(n: int) -> int:
    """Bucketed size for a data-dependent count ``n`` (0 stays 0; identity
    when bucketing is off). Records the padded-vs-true pair on the
    enclosing trace span and the registry counters."""
    n = int(n)
    if n <= 0:
        return 0
    return _note_rows(n, predict_padded(n, mode()))


def exact_size(n: int) -> int:
    """``round_size`` without the lattice, for a materialize that sizes
    its lanes exactly in every mode (``wcoj.MultiwayIntersectOp``): the
    same sums, with padded == true; the span keeps its pair apart from
    the lattice's (``exact_rows_pairs``)."""
    n = int(n)
    return _note_rows(n, n, exact=True) if n > 0 else 0


def _note_rows(n: int, out: int, exact: bool = False) -> int:
    _ROWS_TRUE.inc(n)
    _ROWS_PADDED.inc(out)
    _obs_trace.note_rows(n, out, exact=exact)
    return out


# ---------------------------------------------------------------------------
# pre-flight memory admission
# ---------------------------------------------------------------------------


def memory_budget_bytes() -> int:
    try:
        return max(int(MEM_BUDGET.get()), 0)
    except (TypeError, ValueError):
        return 0


def estimate_materialize_bytes(rows: int, bytes_per_row: int) -> int:
    """Padded device footprint of materializing ``rows`` output rows."""
    return round_size(int(rows)) * max(int(bytes_per_row), 1)


def admit(rows: int, bytes_per_row: int, site: str) -> None:
    """Reject BEFORE launching a materialize whose padded output would
    exceed the configured device-memory budget (``AdmissionRejected``
    reaches the caller typed)."""
    budget = memory_budget_bytes()
    if not budget:
        return
    est = estimate_materialize_bytes(int(rows), bytes_per_row)
    if est > budget:
        from ...errors import AdmissionRejected

        raise AdmissionRejected(
            f"materialize at site {site!r} needs ~{est} bytes padded "
            f"({rows} rows x {bytes_per_row} B/row on the {mode()!r} "
            f"lattice), over the {budget}-byte device-memory budget",
            site=site,
            estimated_bytes=est,
            budget_bytes=budget,
        )


# ---------------------------------------------------------------------------
# kernel-build telemetry (the counterpart of the XLA compile listener)
# ---------------------------------------------------------------------------

_BUILDS_TOTAL = _REGISTRY.counter(
    "tpu_cypher_kernel_builds_total",
    "nvcc builds of the port's CUDA kernel sources",
)
_BUILD_SECONDS_TOTAL = _REGISTRY.counter(
    "tpu_cypher_kernel_build_seconds_total",
    "seconds spent building the port's CUDA kernel sources",
)


def note_build(seconds: float) -> None:
    """Record one kernel-source build (``hopper/_build.py``)."""
    _BUILDS_TOTAL.inc()
    _BUILD_SECONDS_TOTAL.inc(float(seconds))


def install_compile_listener() -> None:
    """Nothing to hook: builds report through ``note_build``."""


def compile_snapshot() -> Dict[str, float]:
    return {
        "compiles": int(_BUILDS_TOTAL.value()),
        "compile_seconds": round(_BUILD_SECONDS_TOTAL.value(), 6),
        "persistent_cache_hits": 0,
        "persistent_cache_misses": 0,
    }


def compile_delta(before: Dict[str, float]) -> Dict[str, float]:
    now = compile_snapshot()
    return {
        "compiles": now["compiles"] - before.get("compiles", 0),
        "compile_seconds": round(
            now["compile_seconds"] - before.get("compile_seconds", 0.0), 6
        ),
        "persistent_cache_hits": 0,
        "persistent_cache_misses": 0,
    }


_CACHE_DIR: Optional[str] = None


def enable_persistent_cache(cache_dir: str) -> None:
    """Remember the cache directory (the optimizer keeps its calibration
    file there); kernels cache their builds by source hash on their own."""
    global _CACHE_DIR
    _CACHE_DIR = cache_dir


def persistent_cache_dir() -> Optional[str]:
    return _CACHE_DIR
