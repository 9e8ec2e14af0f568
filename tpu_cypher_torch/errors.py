"""Typed error taxonomy for fault-tolerant query execution.

Raw device faults surface from the CUDA runtime as ``torch.OutOfMemoryError``
or ``torch.AcceleratorError`` (or a ``RuntimeError`` whose message names the
fault), and from the kernels' ctypes wrappers as a CUDA error code. This
module is the single classification point: every exception that crosses a
query boundary is either one of these types already, classifiable into one
(``classify``), or genuinely not a device fault (planner bugs, user type
errors) and propagates untouched.

The reference retries a fault down its degrade ladder; the port runs a
query once on the device and raises the typed fault to the caller
(``relational/session.py``):

* ``DeviceOOM``        — device memory exhausted
* ``CompileFailure``   — a kernel failed to build or load
* ``DeviceLost``       — the card or its context is gone
* ``QueryTimeout``     — per-query wall-clock deadline exceeded
* ``AdmissionRejected`` — pre-flight memory admission refused a materialize
                         (``backend/cuda/bucketing.admit``)

Injected faults (``runtime/faults.py``) raise messages carrying the same
status markers real faults carry, so this classifier is exercised
identically on the CPU.
"""

from __future__ import annotations

import re
from typing import Optional


class TpuCypherError(Exception):
    """Base of every typed engine error."""


class ExecutionFault(TpuCypherError):
    """A classified per-query execution fault.

    ``site``: the named fault site (join/expand/compact/...) when known.
    ``cause``: the raw underlying exception, preserved for diagnostics.
    """

    #: rung ladder may retry this fault at a degraded rung
    retryable = True

    def __init__(self, message: str, *, site: Optional[str] = None, cause=None):
        super().__init__(message)
        self.site = site
        self.cause = cause


class DeviceError(ExecutionFault):
    """A fault raised by the device runtime (vs. admission/deadline)."""


class DeviceOOM(DeviceError):
    """Device memory (HBM) exhausted during allocation or execution."""


class CompileFailure(DeviceError):
    """XLA (or Mosaic/plugin) failed to compile a program."""


class DeviceLost(DeviceError):
    """The device or its transport disappeared mid-query."""


class WorkerLost(DeviceLost):
    """An engine-worker PROCESS (serve/worker.py) died or its socket
    disconnected mid-query — the multi-process analogue of ``DeviceLost``.
    Reads are idempotent, so the router retries them transparently on a
    surviving replica (stamped ``RUNG_REPLICA`` in the execution log)
    instead of degrading down the in-process ladder.

    ``worker``: the worker id the router observed failing, when known."""

    def __init__(self, message: str, *, site: Optional[str] = None,
                 worker: Optional[str] = None, cause=None):
        super().__init__(message, site=site, cause=cause)
        self.worker = worker


class QueryTimeout(ExecutionFault):
    """The per-query wall-clock deadline expired. Terminal: the ladder does
    not retry (a degraded re-execution would only run further past the
    deadline the caller asked for)."""

    retryable = False


class AdmissionRejected(ExecutionFault):
    """Pre-flight memory admission refused a materialize whose padded
    footprint exceeds the configured HBM budget
    (``TPU_CYPHER_MEM_BUDGET`` / ``CypherSession.tpu(memory_budget_bytes=)``).
    Downgradable: chunked/host rungs execute under the budget."""

    def __init__(
        self,
        message: str,
        *,
        site: Optional[str] = None,
        estimated_bytes: int = 0,
        budget_bytes: int = 0,
        cause=None,
    ):
        super().__init__(message, site=site, cause=cause)
        self.estimated_bytes = estimated_bytes
        self.budget_bytes = budget_bytes


class MutationError(TpuCypherError):
    """A Cypher write failed validation or evaluation (deleting a node
    that still has relationships without DETACH, SET on an unbound or
    non-element variable, an unsupported write shape). A client error:
    the write is rolled back and never reaches the WAL."""


# ---------------------------------------------------------------------------
# classification of raw exceptions
# ---------------------------------------------------------------------------

# jaxlib's XlaRuntimeError messages lead with an absl status code; plugin
# and PJRT variants keep the same markers. Order matters: OOM messages often
# also contain "while compiling" context, so OOM wins over compile.
_OOM_PAT = re.compile(
    r"RESOURCE_EXHAUSTED|out of memory|OOM|Failed to allocate|"
    r"allocat\w* \d+ bytes",
    re.IGNORECASE,
)
_LOST_PAT = re.compile(
    r"device.{0,10}(lost|halted|unavailable)|UNAVAILABLE|ABORTED|"
    r"DEADLINE_EXCEEDED|tunnel|TPU driver|core dumped|chip reset",
    re.IGNORECASE,
)
_COMPILE_PAT = re.compile(
    r"compil|INVALID_ARGUMENT.*lower|Mosaic|XlaCompile|HloModule",
    re.IGNORECASE,
)

# exception type names that mark a raw device-runtime error; message
# patterns alone would misfire on e.g. a ValueError quoting an HLO dump
_RAW_TYPE_NAMES = frozenset(
    {
        "OutOfMemoryError",  # torch.cuda.OutOfMemoryError
        "AcceleratorError",  # torch's CUDA runtime error (launch/illegal access)
        "KernelLaunchError",  # a hand-written kernel's launch returned an error
        "InjectedFault",  # runtime/faults.py synthetic raw fault
    }
)


def _is_raw_device_exc(exc: BaseException) -> bool:
    for klass in type(exc).__mro__:
        if klass.__name__ in _RAW_TYPE_NAMES:
            return True
    return False


def classify(
    exc: BaseException, *, site: Optional[str] = None
) -> Optional[ExecutionFault]:
    """Map an exception to its typed fault, or None when it is not one.

    Already-typed faults pass through (site filled in if missing). Raw
    device-runtime exceptions classify by message markers; anything else —
    planner errors, Cypher type errors, assertion failures — returns None
    and must propagate to the caller unchanged."""
    if isinstance(exc, ExecutionFault):
        if site is not None and exc.site is None:
            exc.site = site
        return exc
    # worker-socket disconnect/EOF: the peer engine-worker process died
    # mid-conversation (serve/router.py observes exactly this when a child
    # takes a native libtpu abort). ConnectionError covers reset/refused/
    # broken-pipe/aborted; EOFError covers asyncio.IncompleteReadError.
    if isinstance(exc, (ConnectionError, EOFError)):
        return WorkerLost(
            f"{f'[site={site}] ' if site else ''}worker connection lost: "
            f"{type(exc).__name__}: {exc}",
            site=site,
            cause=exc,
        )
    if not _is_raw_device_exc(exc):
        return None
    if site is None:
        hint = getattr(exc, "site", None)
        site = hint if isinstance(hint, str) else None
    msg = str(exc)
    head = f"[site={site}] " if site else ""
    if _OOM_PAT.search(msg):
        return DeviceOOM(f"{head}device out of memory: {msg}", site=site, cause=exc)
    if _LOST_PAT.search(msg):
        return DeviceLost(f"{head}device lost: {msg}", site=site, cause=exc)
    if _COMPILE_PAT.search(msg):
        return CompileFailure(
            f"{head}device compile failure: {msg}", site=site, cause=exc
        )
    # a raw runtime error with no recognizable marker: still a device fault
    # (it came from the device runtime) — keep the message
    return DeviceError(f"{head}device fault: {msg}", site=site, cause=exc)


def reraise_if_device(exc: BaseException, *, site: Optional[str] = None) -> None:
    """For broad ``except Exception`` handlers in the backend: a genuine
    device fault must NOT be swallowed — re-raise it typed so it reaches
    the caller. Non-device exceptions return to the handler."""
    typed = classify(exc, site=site)
    if typed is not None:
        raise typed from exc
