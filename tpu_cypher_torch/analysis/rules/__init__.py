"""The rule registry: thirteen engine-grounded invariants, one shared pass.

The port's counterpart of ``tpu_cypher/analysis/rules/__init__.py``, with
the same rule ids in the same order, then the port's own ``sync-span``
(every device sync inside a timed ``obs.trace.sync`` span). Adding a rule = subclass
``core.Rule``, give it a kebab-case ``id``, and list an instance here;
every rule ships a known-bad and a known-clean fixture
(``tests/test_torch_analysis.py``, ``tests/test_torch_shapes.py``).

Five rules are per-file (``recompile-hazard``, ``pad-invariant``,
``env-var-registry``, ``exception-hygiene``, ``obs-emission``);
``host-sync``, ``sync-span`` and the concurrency pack (``async-blocking``,
``contextvar-discipline``, ``shared-state-race``) consume the
interprocedural substrate (``callgraph.py`` / ``dataflow.py``) the
``ProjectContext`` builds lazily on first use; the shape pack
(``shape-stability``, ``pad-mask-discipline``, ``bucket-cardinality``)
rides the abstract shape interpreter (``shapes.py``) on the same call
graph, with the port's kernel gate (``hopper/dispatch.launch`` and the
``hopper/*`` wrappers) as its boundary.
"""

from __future__ import annotations

from typing import Dict, List

from ..core import Rule
from .async_blocking import AsyncBlockingRule
from .bucket_cardinality import BucketCardinalityRule
from .contextvar_discipline import ContextvarDisciplineRule
from .env_registry import EnvVarRegistryRule
from .exception_hygiene import ExceptionHygieneRule
from .host_sync import HostSyncRule
from .obs_emission import ObsEmissionRule
from .pad_invariant import PadInvariantRule
from .pad_mask import PadMaskRule
from .recompile import RecompileHazardRule
from .shape_stability import ShapeStabilityRule
from .shared_state_race import SharedStateRaceRule
from .sync_span import SyncSpanRule

ALL_RULES: List[Rule] = [
    HostSyncRule(),
    RecompileHazardRule(),
    PadInvariantRule(),
    EnvVarRegistryRule(),
    ExceptionHygieneRule(),
    ObsEmissionRule(),
    AsyncBlockingRule(),
    ContextvarDisciplineRule(),
    SharedStateRaceRule(),
    ShapeStabilityRule(),
    PadMaskRule(),
    BucketCardinalityRule(),
    SyncSpanRule(),
]

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
