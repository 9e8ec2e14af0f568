"""Query observability: per-operator trace spans + the unified metrics
registry + export surfaces.

The reference delegates engine observability to Spark UI /
``tableEnv.explain``; this package is the TPU stack's equivalent,
documented in ``docs/observability.md``:

* ``obs.trace`` — context-local span trees per query (phases, relational
  operators, kernel launches with their device time, bucket-lattice pad
  ratios, the timed ``sync:<site>`` spans at the device syncs), surfaced
  as ``CypherResult.profile()``, and as ``torch.profiler`` regions while
  a profiler records.
* ``obs.metrics`` — the process-global ``REGISTRY`` of counters / gauges /
  histograms with labeled series, context-local scoping, a cardinality
  cap, Prometheus text export (``CypherSession.metrics_text()``) and a
  JSON-lines sink (``TPU_CYPHER_METRICS_FILE``).
"""

from . import metrics, trace
from .metrics import REGISTRY, MetricsRegistry, MetricsScope
from .trace import QueryProfile, QueryTrace, current_span, current_trace, span

__all__ = [
    "metrics",
    "trace",
    "REGISTRY",
    "MetricsRegistry",
    "MetricsScope",
    "QueryProfile",
    "QueryTrace",
    "current_span",
    "current_trace",
    "span",
]
