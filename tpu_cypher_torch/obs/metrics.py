"""Unified metrics registry: counters, gauges, histograms with labeled series.

One coherent metrics subsystem for the whole engine: the kernel-build
counter (``backend/cuda/bucketing.py``), the per-kernel launch counters
(``backend/cuda/hopper/dispatch.py``) and the fault-site invocation counts
(``runtime/faults.py``) all emit through the process-global ``REGISTRY``
here, keeping their public read paths (``compile_snapshot``,
``dispatch.use_counts``, ``faults.counters``) as thin views over it.

Design points:

* **Labeled series** — a metric is a family; each distinct label tuple is a
  series. Cardinality is CAPPED per metric (``LABEL_CARDINALITY_CAP``):
  once a family holds that many series, new label tuples collapse into one
  ``__overflow__`` series instead of growing without bound (a production
  registry must never let a runaway label — e.g. a query string — eat the
  host).
* **Context-local scoping** — ``REGISTRY.scope()`` opens a contextvar-carried
  scope that accumulates only the mutations made in THIS context while open
  (threads / asyncio / nested view execution never cross-pollute). Scopes nest; each sees its own
  copy.
* **Histograms** — count/sum/min/max plus p50/p95 over a bounded window
  (the ``utils/measurement.py`` stage-timing role, folded in here).
* **Export sinks** — Prometheus text format (``prometheus_text`` /
  ``CypherSession.metrics_text()``) and JSON-lines events appended to
  ``TPU_CYPHER_METRICS_FILE`` (one line per query; see ``write_event``).
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

# PRINT_TIMINGS: the stage-timing echo flag, ONE declaration shared with
# the session's timing path; METRICS_FILE: the JSON-lines per-query sink.
# Both live in the typed registry (utils/config.py).
from ..utils.config import METRICS_FILE, PRINT_TIMINGS

# schema version stamped on every exported event/snapshot — consumers
# (the bench driver, log scrapers) key parsing off it
EVENT_SCHEMA_VERSION = 1

# max distinct label tuples per metric family before collapse
LABEL_CARDINALITY_CAP = 64
OVERFLOW_LABEL = "__overflow__"

# histogram quantile window (bounded memory per series)
_HIST_WINDOW = 1024


class MetricError(Exception):
    pass


# active scopes in THIS context (a tuple: scopes nest)
_SCOPES: contextvars.ContextVar[Tuple["MetricsScope", ...]] = (
    contextvars.ContextVar("tpu_cypher_metric_scopes", default=())
)


class _HistState:
    __slots__ = ("count", "sum", "min", "max", "window")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.window: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.window) >= _HIST_WINDOW:
            # bounded reservoir: overwrite round-robin so old observations
            # age out without an unbounded list
            self.window[self.count % _HIST_WINDOW] = v
        else:
            self.window.append(v)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
        }
        if self.window:
            w = sorted(self.window)
            out["p50"] = w[int(0.50 * (len(w) - 1))]
            out["p95"] = w[int(0.95 * (len(w) - 1))]
        else:
            out["p50"] = 0.0
            out["p95"] = 0.0
        return out


class Metric:  # shared-by: lanes
    """One metric family: (name, help, label names) plus its series map."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labels: Sequence[str]):
        self._reg = registry
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key_locked(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        """Series key for a label dict — caller holds the registry lock.
        Applies the cardinality cap: a NEW tuple past the cap collapses to
        the overflow series."""
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = tuple(str(labels[l]) for l in self.label_names)
        if key not in self._series and len(self._series) >= LABEL_CARDINALITY_CAP:
            key = tuple(OVERFLOW_LABEL for _ in self.label_names)
        return key

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.label_names, key))

    def items(self) -> List[Tuple[Dict[str, str], Any]]:
        """(label dict, value-or-histogram-summary) per series."""
        with self._reg._lock:
            return [
                (self._label_dict(k),
                 v.summary() if isinstance(v, _HistState) else v)
                for k, v in self._series.items()
            ]

    def reset(self, **labels) -> None:
        """Zero matching series (all series when no labels given). Series
        stay registered so zero-valued reads keep working."""
        with self._reg._lock:
            if not labels:
                keys = list(self._series)
            else:
                want = {k: str(v) for k, v in labels.items()}
                keys = [
                    k for k in self._series
                    if all(self._label_dict(k).get(n) == v
                           for n, v in want.items())
                ]
            for k in keys:
                self._series[k] = (
                    _HistState() if isinstance(self._series[k], _HistState)
                    else 0.0
                )


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> float:
        """Add ``amount`` (>= 0; 0 pre-seeds the series so it exports as an
        explicit zero) and return the NEW cumulative value — an atomic
        inc-and-get, which is what ``runtime/faults.py`` keys occurrence
        windows off."""
        if amount < 0:
            raise MetricError(f"{self.name}: counter increments must be >= 0")
        with self._reg._lock:
            key = self._key_locked(labels)
            v = self._series.get(key, 0.0) + amount
            self._series[key] = v
        if amount:
            for s in _SCOPES.get():
                s._add(self, key, amount)
        return v

    def value(self, **labels) -> float:
        with self._reg._lock:
            if not labels and not self.label_names:
                return self._series.get((), 0.0)
            key = self._key_locked(labels)
            return self._series.get(key, 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._reg._lock:
            self._series[self._key_locked(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._series.get(self._key_locked(labels), 0.0)


class Histogram(Metric):
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        with self._reg._lock:
            key = self._key_locked(labels)
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = _HistState()
            st.observe(value)
        for s in _SCOPES.get():
            s._observe(self, key, value)

    def summary(self, **labels) -> Dict[str, float]:
        """count / sum / min / max / p50 / p95 for one series (zeros when
        the series has never observed) — the ``utils/measurement.py``
        p50/p95/max histogram, per labeled series."""
        with self._reg._lock:
            st = self._series.get(self._key_locked(labels))
            return st.summary() if st is not None else _HistState().summary()


class MetricsScope:
    """Context-local accumulation of metric deltas: ``with REGISTRY.scope()
    as s:`` — ``s`` fills with only the counter increments and histogram
    observations recorded in THIS context while the scope is open. Readable
    both during and after the ``with`` block."""

    def __init__(self):
        # (metric name, series key) -> delta / (count, sum)
        self._counters: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        self._hists: Dict[Tuple[str, Tuple[str, ...]], Tuple[int, float]] = {}
        self._names: Dict[Tuple[str, Tuple[str, ...]], Tuple[str, ...]] = {}
        self._token = None

    def __enter__(self) -> "MetricsScope":
        self._token = _SCOPES.set(_SCOPES.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        _SCOPES.reset(self._token)

    def _add(self, metric: Metric, key: Tuple[str, ...], amount: float) -> None:
        k = (metric.name, key)
        self._counters[k] = self._counters.get(k, 0.0) + amount
        self._names[k] = metric.label_names

    def _observe(self, metric: Metric, key: Tuple[str, ...], v: float) -> None:
        k = (metric.name, key)
        c, s = self._hists.get(k, (0, 0.0))
        self._hists[k] = (c + 1, s + v)
        self._names[k] = metric.label_names

    def value(self, name: str, **labels) -> float:
        for (n, k), v in self._counters.items():
            if n != name:
                continue
            names = self._names[(n, k)]
            if set(names) == set(labels) and tuple(
                str(labels[l]) for l in names
            ) == k:
                return v
        return 0.0

    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """JSON-safe view of everything this scope captured."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for (n, k), v in sorted(self._counters.items()):
            out.setdefault(n, []).append(
                {"labels": dict(zip(self._names[(n, k)], k)), "value": v}
            )
        for (n, k), (c, s) in sorted(self._hists.items()):
            out.setdefault(n, []).append(
                {"labels": dict(zip(self._names[(n, k)], k)),
                 "count": c, "sum": round(s, 9)}
            )
        return out


class MetricsRegistry:  # shared-by: lanes
    """The metric namespace: get-or-create by name, idempotent (a second
    registration with a different kind or label set is an error, not a
    silent shadow)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "Dict[str, Metric]" = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str]) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise MetricError(
                        f"metric {name!r} re-registered as {cls.kind} "
                        f"labels={tuple(labels)} (was {m.kind} "
                        f"labels={m.label_names})"
                    )
                return m
            m = cls(self, name, help, labels)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def scope(self) -> MetricsScope:
        return MetricsScope()

    def reset(self, name: Optional[str] = None) -> None:
        """Zero one metric's series, or every metric's (tests)."""
        with self._lock:
            targets = (
                [self._metrics[name]] if name is not None and name in self._metrics
                else list(self._metrics.values()) if name is None else []
            )
        for m in targets:
            m.reset()

    def snapshot(self) -> Dict[str, Any]:
        """Nested JSON-safe dump of every family and series."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Any] = {"schema_version": EVENT_SCHEMA_VERSION}
        fams: Dict[str, Any] = {}
        for m in sorted(metrics, key=lambda m: m.name):
            fams[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "series": [
                    {"labels": lbl, "value": v} for lbl, v in m.items()
                ],
            }
        out["metrics"] = fams
        return out

    def flat(self) -> Dict[str, float]:
        """One flat {"name{a=b}": number} dict — the bench.py JSON-line
        shape (histograms flatten to _count/_sum/_p50/_p95/_max keys)."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            for lbl, v in sorted(m.items(), key=lambda kv: sorted(kv[0].items())):
                tag = ",".join(f"{k}={lbl[k]}" for k in sorted(lbl))
                base = f"{m.name}{{{tag}}}" if tag else m.name
                if isinstance(v, dict):  # histogram summary
                    for field in ("count", "sum", "p50", "p95", "max"):
                        out[f"{base}_{field}"] = v[field]
                else:
                    out[base] = v
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition text format. Counters and gauges export
        as-is; histograms export as summaries (quantile series + _sum and
        _count). Series are emitted in sorted order so output is
        deterministic (the golden test relies on it)."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            ptype = "summary" if m.kind == "histogram" else m.kind
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {ptype}")
            series = sorted(m.items(), key=lambda kv: sorted(kv[0].items()))
            for lbl, v in series:
                if isinstance(v, dict):  # histogram summary
                    for q, fld in (("0.5", "p50"), ("0.95", "p95")):
                        lines.append(
                            _sample(m.name, {**lbl, "quantile": q}, v[fld])
                        )
                    lines.append(_sample(m.name + "_sum", lbl, v["sum"]))
                    lines.append(_sample(m.name + "_count", lbl, v["count"]))
                else:
                    lines.append(_sample(m.name, lbl, v))
        return "\n".join(lines) + "\n"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sample(name: str, labels: Dict[str, str], value: Any) -> str:
    if labels:
        tag = ",".join(
            f'{k}="{_escape_label(str(labels[k]))}"' for k in sorted(labels)
        )
        name = f"{name}{{{tag}}}"
    v = float(value)
    return f"{name} {int(v) if v == int(v) else v}"


# the process-global registry every engine layer emits through
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# JSON-lines export sink
# ---------------------------------------------------------------------------


def sink_configured() -> bool:
    return bool(METRICS_FILE.get())


def write_event(event: Dict[str, Any]) -> None:
    """Append one schema-versioned JSON line to ``TPU_CYPHER_METRICS_FILE``.
    No-op when unconfigured; an export failure must never fail the query."""
    path = METRICS_FILE.get()
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps({"v": EVENT_SCHEMA_VERSION, **event}) + "\n")
    except (OSError, TypeError, ValueError):  # fault-ok: export is best-effort
        pass


# ---------------------------------------------------------------------------
# stage timing (folded in from utils/measurement.py)
# ---------------------------------------------------------------------------

STAGE_SECONDS = REGISTRY.histogram(
    "tpu_cypher_stage_seconds",
    "wall seconds per pipeline phase (parse/ir/logical/.../execute)",
    labels=("stage",),
)

_TIMINGS: List[Tuple[str, float]] = []


def record_stage(name: str, seconds: float) -> None:
    """One pipeline-phase timing: registry histogram + the bounded recent
    list ``last_timings`` reads + the ``TPU_CYPHER_PRINT_TIMINGS`` echo
    (reference ``Measurement.scala:36-56`` / ``PrintTimings``)."""
    STAGE_SECONDS.observe(seconds, stage=name)
    _TIMINGS.append((name, seconds))
    del _TIMINGS[:-64]
    if PRINT_TIMINGS.get():
        print(f"[timing] {name}: {seconds * 1000:.2f} ms")


def time_stage(name: str, fn: Callable, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    record_stage(name, time.perf_counter() - t0)
    return out


def last_timings() -> Dict[str, float]:
    return dict(_TIMINGS[-16:])


def clear_timings() -> None:
    _TIMINGS.clear()


# ---------------------------------------------------------------------------
# mapping views over labeled counters (legacy read-path adapters)
# ---------------------------------------------------------------------------


class CounterView(Mapping):
    """Dict-like live view over ONE label dimension of a counter — the
    compatibility shape for the old module-global tier dicts
    (``expand_op.MXU_TIER_COUNTS["tiled"]``, ``bench._tier_snapshot``'s
    ``.items()``) now that the values live in the registry."""

    def __init__(self, counter: Counter, label: str, keys: Sequence[str]):
        self._c = counter
        self._label = label
        self._keys = tuple(keys)
        for k in self._keys:  # pre-seed: zero series export explicitly
            counter.inc(0, **{label: k})

    def inc(self, key: str, amount: float = 1.0) -> float:
        return self._c.inc(amount, **{self._label: key})

    def __getitem__(self, key: str) -> int:
        return int(self._c.value(**{self._label: key}))

    def __iter__(self) -> Iterator[str]:
        seen = dict.fromkeys(self._keys)
        for lbl, _ in self._c.items():
            seen.setdefault(lbl[self._label])
        return iter(seen)

    def __len__(self) -> int:
        return len(list(iter(self)))
