"""Deprecated shim: stage timing moved into ``tpu_cypher.obs.metrics``.

The ``time_stage``/``last_timings``/``clear_timings`` trio (reference
``Measurement.scala:36-56`` + ``PrintTimings``) now lives in the unified
metrics registry, where each stage observation also lands in the
``tpu_cypher_stage_seconds`` histogram (p50/p95/max per stage). Import from
``tpu_cypher.obs.metrics`` instead."""

from __future__ import annotations

import warnings

from ..obs.metrics import clear_timings, last_timings, time_stage  # noqa: F401

warnings.warn(
    "tpu_cypher.utils.measurement is deprecated; use tpu_cypher.obs.metrics",
    DeprecationWarning,
    stacklevel=2,
)
