"""The yardstick of the kernels' roofline shares: the published peaks of the
card and the least bytes each hand-written kernel must move for a call.

Frozen copies of ``chip_smoke.py``'s byte bounds (``MEM_BYTES_PER_S``,
``expand_bound``'s and ``time_intersect``'s byte counts). Each input byte is
counted read once and each output byte written once. Their operation
counts stay below the byte bound at every shape PERF.md lists (for example
Q17's final hop 0.2714 against 1.2627 ms, Q6's arm-0 probe 0.3691 against
0.7779 ms), so the bound of a call is its byte time.
"""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str) -> dict:
    with open(os.path.join(_HERE, name)) as f:
        return json.load(f)


PEAKS = _load("h100_sxm.json")
KERNELS = _load("kernels.json")


def expand_bytes(frontier: int, lanes: int, with_orig: bool) -> int:
    """``expand_rows``, one call that materializes ``lanes`` lanes (all live)
    from ``frontier`` rows: per row its position, degree and row pointer
    (20 B); per lane the neighbour index and, with orig, the edge offset
    read (12 B, else 4) and the row, neighbour, orig and live flag written
    (25 B, else 17)."""
    return 20 * frontier + (12 + 25 if with_orig else 4 + 17) * lanes


def intersect_bytes(keys: int, queries: int) -> int:
    """``intersect``, one range count of ``queries`` int64 queries (and
    their valid flags) over ``keys`` sorted int64 keys, writing an int32
    insertion point and an int64 count a query: 8 B a key, 25 B a query."""
    return 8 * keys + 25 * queries


def bound_seconds(nbytes: float) -> float:
    """The least time the card needs to move ``nbytes`` through device
    memory at its published rate."""
    return nbytes / PEAKS["mem_bytes_per_s"]
