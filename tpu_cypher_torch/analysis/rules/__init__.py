"""The rule registry: seven engine-grounded invariants, one shared pass.

The port's counterpart of ``tpu_cypher/analysis/rules/__init__.py``, with
the same rule ids. Adding a rule = subclass ``core.Rule``, give it a
kebab-case ``id``, and list an instance here; every rule ships a
known-bad and a known-clean fixture (``tests/test_torch_analysis.py``).

Three rules are per-file (``env-var-registry``, ``exception-hygiene``,
``obs-emission``); ``host-sync`` and the concurrency pack
(``async-blocking``, ``contextvar-discipline``, ``shared-state-race``)
consume the interprocedural substrate (``callgraph.py`` /
``dataflow.py``) the ``ProjectContext`` builds lazily on first use. The
reference's shape pack (``shape-stability``, ``pad-mask-discipline``,
``bucket-cardinality``, ``pad-invariant``, ``recompile-hazard``) guards
XLA's compile cache and the bucket lattice; it is not ported (ROADMAP.md
item 12.2).
"""

from __future__ import annotations

from typing import Dict, List

from ..core import Rule
from .async_blocking import AsyncBlockingRule
from .contextvar_discipline import ContextvarDisciplineRule
from .env_registry import EnvVarRegistryRule
from .exception_hygiene import ExceptionHygieneRule
from .host_sync import HostSyncRule
from .obs_emission import ObsEmissionRule
from .shared_state_race import SharedStateRaceRule

ALL_RULES: List[Rule] = [
    HostSyncRule(),
    EnvVarRegistryRule(),
    ExceptionHygieneRule(),
    ObsEmissionRule(),
    AsyncBlockingRule(),
    ContextvarDisciplineRule(),
    SharedStateRaceRule(),
]

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
