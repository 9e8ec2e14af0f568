"""Device-level observability: torch.profiler traces.

The counterpart of the JAX package's ``jax.profiler`` wiring. Gated by
``TPU_CYPHER_PROFILE_DIR``: when set, ``CypherSession.cypher`` executions
are wrapped in a ``torch.profiler`` trace that is exported as a Chrome
trace into that directory, AND the ``obs.trace`` span tree uses this
module as its device-trace backend — every engine span opens a matching
``torch.profiler.record_function`` region, so the phase/operator/kernel
tree shows up region-named inside the Perfetto timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional

from .config import PROFILE_DIR

_TRACE_IDS = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Wrap a block in a ``torch.profiler`` trace (CPU activity, plus CUDA
    when a card is present) and export it as ``trace_<pid>_<n>.json`` under
    the directory. No-op when no directory is configured or the profiler
    cannot start."""
    d = log_dir or PROFILE_DIR.get()
    if not d:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:  # pragma: no cover - fault-ok: profiler start is best-effort
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(d, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(d, f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json")
            )
        except Exception:  # pragma: no cover - fault-ok: best-effort profiler stop
            pass


def annotate(name: str):
    """Named profiler region for attribution inside traces."""
    import torch

    return torch.profiler.record_function(name)
