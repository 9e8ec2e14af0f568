"""Zero-dispatch result cache for the serving tier.

The serving workload repeats itself: dashboards re-issue the same
parameterized reads, and the micro-batcher already proves identical
in-flight queries are common enough to demux (``serve/batching.py``).
This module closes the remaining gap — identical queries that DON'T
overlap in time still pay a full device dispatch each. A hit here
returns the COMPLETE wire payload (the same encoded rows
``execute_payload`` produced, byte for byte) from host memory in
well under a millisecond, with zero device dispatch: no kernel
launches.

Keying and correctness:

* The cache key is the micro-batcher's demux key (``batching.batch_key``
  — plan-cache key + normalized parameter values + bucket signature), so
  "same key" already means "same plan and same logical result" by the
  batcher's proof obligations.
* Each entry additionally records the graph's STATISTICS FINGERPRINT
  (``optimizer.stats.GraphStatistics.fingerprint`` — node/rel/label/type
  counts). A lookup under a different fingerprint is a miss and evicts
  the stale entry: re-registering a changed graph invalidates its
  cached results without any explicit flush.
* Chaos-injected and deadline-carrying executions never populate (the
  server computes no batch key for them — same exclusion the
  micro-batcher relies on), and neither do payloads that report
  ``degraded`` (a last attempt off the ``device`` rung).

Sizing: one byte budget (``TPU_CYPHER_SERVE_CACHE_BYTES``), LRU-evicted.
Entry size is measured as the JSON text length of the stored payload —
the payload is JSON-safe by construction (it just traveled, or is about
to travel, the wire), so this is the honest serialized footprint.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..obs import trace as OT
from ..obs.metrics import REGISTRY
from ..utils.config import SERVE_CACHE_BYTES

HITS = REGISTRY.counter(
    "tpu_cypher_serve_cache_hits_total",
    "result-cache hits (payload served with zero device dispatch)",
)
MISSES = REGISTRY.counter(
    "tpu_cypher_serve_cache_misses_total",
    "result-cache misses (including fingerprint invalidations)",
)
EVICTIONS = REGISTRY.counter(
    "tpu_cypher_serve_cache_evictions_total",
    "result-cache entries evicted (LRU byte budget + invalidations)",
)
CACHE_BYTES = REGISTRY.gauge(
    "tpu_cypher_serve_cache_bytes",
    "bytes of encoded result payloads currently cached",
)


def graph_fingerprint(session, graph) -> str:
    """Statistics fingerprint of the SHARED stats target (the relational
    graph the optimizer also stamps), computed on the blocking setup path
    — lookups against it are then one string compare. Fallback: a
    per-object token, which still invalidates per registered instance —
    never a stale hit, at worst extra misses."""
    try:
        from ..optimizer.stats import GraphStatistics

        base = getattr(graph, "_graph", graph)
        own = getattr(base, "fingerprint", None)
        if callable(own):
            # mutable graphs chain their fingerprint per committed write
            # batch (storage.delta.advance_fingerprint) — the serving tier
            # refreshes its copy from each write payload, so cache entries
            # stored under older fingerprints simply stop matching
            return own()
        ctx = session._runtime_context({})
        return GraphStatistics.of(base, ctx).fingerprint()
    except Exception:  # fault-ok: degrade to identity-based invalidation
        return f"obj-{id(graph)}"


def cache_hit_payload(entry: Dict[str, Any], elapsed_s: float) -> Dict[str, Any]:
    """The wire payload for a cache hit: the stored payload with
    ``cached: true``, a fresh ``seconds``, and a synthesized single-span
    ``cache`` profile (the stored profile described the ORIGINAL device
    execution; re-serving it would misattribute time)."""
    out = dict(entry)
    tr = OT.QueryTrace()
    sp = OT.Span(1, "cache", "phase", {"hit": True})
    sp.seconds = elapsed_s
    tr.root.seconds = elapsed_s
    tr.root.children.append(sp)
    out["cached"] = True
    out["seconds"] = round(elapsed_s, 6)
    out["profile"] = tr.to_dict()
    out["compile_stats"] = {}
    return out


class ResultCache:  # shared-by: loop
    """Byte-budgeted LRU of encoded result payloads, keyed on the
    micro-batch demux key and guarded by the graph-statistics
    fingerprint. Event-loop-owned (single-threaded access); lookups and
    stores are dict operations on host data — no device work, ever."""

    def __init__(self, max_bytes: Optional[int] = None):
        self._max_bytes = max_bytes
        # key -> (fingerprint, size_bytes, payload)
        self._entries: "OrderedDict[Any, Tuple[str, int, Dict[str, Any]]]" = (
            OrderedDict()
        )
        self._bytes = 0

    @property
    def max_bytes(self) -> int:
        if self._max_bytes is not None:
            return int(self._max_bytes)
        return int(SERVE_CACHE_BYTES.get())

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def lookup(self, key: Any, fingerprint: str) -> Optional[Dict[str, Any]]:
        """The complete hit payload (``cached: true``, synthesized
        ``cache`` profile) or None. A fingerprint mismatch is a miss AND
        drops the stale entry — graph-change invalidation."""
        if key is None or not self.enabled:
            return None
        t0 = time.perf_counter()
        ent = self._entries.get(key)
        if ent is None:
            MISSES.inc()
            return None
        fp, size, payload = ent
        if fp != fingerprint:
            self._drop(key)
            EVICTIONS.inc()
            MISSES.inc()
            return None
        self._entries.move_to_end(key)
        HITS.inc()
        return cache_hit_payload(payload, time.perf_counter() - t0)

    def store(self, key: Any, fingerprint: str, payload: Dict[str, Any]) -> bool:
        """Insert (or refresh) one payload; LRU-evict down to the byte
        budget. Returns False without storing when caching is off, the
        key is None (uncacheable query), the payload is degraded, or the
        single entry exceeds the whole budget."""
        budget = self.max_bytes
        if key is None or budget <= 0 or payload.get("degraded"):
            return False
        entry = {
            k: v for k, v in payload.items()
            if k not in ("cached", "batched", "batch_leader")
        }
        try:
            size = len(json.dumps(entry))
        except (TypeError, ValueError):
            return False  # defensively: never cache a non-JSON-safe payload
        if size > budget:
            return False
        if key in self._entries:
            self._drop(key)
        self._entries[key] = (fingerprint, size, entry)
        self._bytes += size
        while self._bytes > budget and self._entries:
            old, (_, osize, _) = self._entries.popitem(last=False)
            self._bytes -= osize
            EVICTIONS.inc()
        CACHE_BYTES.set(self._bytes)
        return True

    def _drop(self, key: Any) -> None:
        _, size, _ = self._entries.pop(key)
        self._bytes -= size
        CACHE_BYTES.set(self._bytes)

    def flush(self) -> int:
        """Drop everything (the explicit ``/cache/flush`` endpoint).
        Returns the number of entries dropped."""
        n = len(self._entries)
        EVICTIONS.inc(n)
        self._entries.clear()
        self._bytes = 0
        CACHE_BYTES.set(0)
        return n

    def stats(self) -> Dict[str, Any]:
        """JSON-safe snapshot for the ``/cache`` endpoint and the soak
        harness's hit-ratio accounting."""
        hits = int(HITS.value())
        misses = int(MISSES.value())
        total = hits + misses
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "max_bytes": self.max_bytes,
            "hits": hits,
            "misses": misses,
            "evictions": int(EVICTIONS.value()),
            "hit_ratio": round(hits / total, 4) if total else 0.0,
        }
