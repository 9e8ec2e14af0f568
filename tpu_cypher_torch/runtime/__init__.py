"""Query-execution runtime services: the execution guard (deadline,
rung) and deterministic fault injection. See
docs/robustness.md."""

from . import faults, guard  # noqa: F401
from .faults import fault_point  # noqa: F401
