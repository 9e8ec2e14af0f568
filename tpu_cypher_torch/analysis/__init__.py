"""Engine-aware static analysis of the port: machine-check the invariants
the port's correctness rests on.

The port's counterpart of ``tpu_cypher/analysis`` (it imports nothing of
it): the same module, class and rule names and the same suppression
syntax, over ``tpu_cypher_torch/``. The invariants are the port's own
bring-up rules: device syncs must sit behind a ``fault_point`` so the
fault matrix and the query deadline see them (on the card a sync is a
stream stall, so the sync map is also where an idle share starts),
``TPU_CYPHER_*`` configuration must flow through the typed registry in
``utils.config``, broad excepts must re-raise device faults, every
hand-written kernel launches through the one gate
(``backend/cuda/hopper/dispatch.launch``), and the serving tier keeps
its concurrency disciplines.

* one parsed-AST + scope-resolution pass per file (``core.FileContext``),
  shared by every rule, so the whole port lints in seconds;
* a rule registry (``rules.ALL_RULES``) with the reference's twelve
  rules: ``host-sync`` (over a torch device-taint model,
  ``dataflow.py``), ``recompile-hazard`` (kernel builds, ``torch.compile``
  and config reads per call), ``pad-invariant``, ``env-var-registry``,
  ``exception-hygiene``, ``obs-emission`` (raw ``_build.lib`` / ctypes
  ``*_launch`` sites only in registered impls), ``async-blocking``,
  ``contextvar-discipline``, ``shared-state-race``, and the shape pack
  (``shape-stability``, ``pad-mask-discipline``, ``bucket-cardinality``)
  over the abstract shape interpreter (``shapes.py``), whose facts
  ``--facts-out`` writes;
* inline suppressions ``# tpulint: allow[rule-id] reason=...`` with the
  reason MANDATORY (an allow without a reason is itself a finding);
* a committed baseline (``analysis/baseline.json``) for grandfathered
  findings — kept EMPTY: new debt needs an inline reason, not a baseline
  entry;
* a CLI: ``python -m tpu_cypher_torch.analysis [--format text|json]
  [--baseline FILE] [paths...]`` — exit 0 only when every finding is
  fixed, suppressed-with-reason, or baselined.
"""

from __future__ import annotations

from .core import FileContext, Finding, Rule
from .runner import (
    ENGINE_ROOT,
    check_engine,
    engine_is_clean,
    engine_lint_summary,
    run_paths,
)
from .rules import ALL_RULES
from .shapes import collect_facts, engine_shape_summary, predict_padded

__all__ = [
    "ALL_RULES",
    "ENGINE_ROOT",
    "FileContext",
    "Finding",
    "Rule",
    "check_engine",
    "collect_facts",
    "engine_is_clean",
    "engine_lint_summary",
    "engine_shape_summary",
    "predict_padded",
    "run_paths",
]
