"""Kernel dispatch: ONE gate between the engine and every Hopper kernel.

The port of ``tpu_cypher/backend/tpu/pallas/dispatch.py`` (``register`` /
``launch``), with the same registry (impls included), ``kernel_*`` fault
sites, trace spans and per-(kernel, tier) launch counters. It differs in
one place: the reference quietly gives way to jnp after a compiled-path
failure (its broken-once memo); this gate never does. The tier follows the device of the
tensors the caller hands it:

* ``plain``    — CPU tensors: the kernel's plain PyTorch version runs;
* ``kernel``   — CUDA tensors and an eligible call: the kernel runs,
                 with the tensors' device made the current one. A
                 build or launch error raises (typed when it is a device
                 fault) and is never memoized;
* ``fallback`` — CUDA tensors and an ineligible call (the semantic
                 ineligibility the reference has too, e.g. a float sum):
                 the plain version, which is the torch-op counterpart of
                 the reference's non-kernel path.

There is no ``off`` or ``interpret`` mode. ``use_counts()`` reads the
counters, which the obs registry serves as
``tpu_cypher_kernel_launch_total{kernel, tier}``. On the ``kernel`` tier
of a traced query each wrapper's ctypes launch runs inside
``device_timed(dev, stream)``, which keeps a pair of CUDA timing events
on the ``kernel:<name>`` span (``Span.device_seconds``); the other tiers
record none.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ....obs import trace as _obs_trace
from ....obs.metrics import REGISTRY as _REGISTRY

TIERS = ("kernel", "plain", "fallback")


@dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its fault site, the TPU kernel it replaces,
    its CUDA source under ``tpu_cypher_torch/csrc`` and its impls: the
    functions of the registering module that load the kernel's library
    or call its ctypes ``*_launch`` symbols, the only places the
    ``obs-emission`` rule (``tpu_cypher_torch/analysis``) lets them."""

    name: str
    site: str
    replaces: str
    source: str
    impls: Tuple[str, ...]


_KERNELS: Dict[str, KernelSpec] = {}

KERNEL_LAUNCH = _REGISTRY.counter(
    "tpu_cypher_kernel_launch_total",
    "kernel dispatch outcomes per (kernel, tier=kernel|plain|fallback)",
    labels=("kernel", "tier"),
)


def register(
    name: str, site: str, replaces: str, source: str, impls: Tuple[str, ...]
) -> None:
    _KERNELS[name] = KernelSpec(name, site, replaces, source, tuple(impls))
    for tier in TIERS:
        KERNEL_LAUNCH.inc(0, kernel=name, tier=tier)


def registry() -> Dict[str, KernelSpec]:
    return dict(_KERNELS)


def reset(name: Optional[str] = None) -> None:
    """Zero the launch counters (all kernels, or one)."""
    if name is None:
        KERNEL_LAUNCH.reset()
    else:
        KERNEL_LAUNCH.reset(kernel=name)


def use_counts() -> Dict[str, Dict[str, int]]:
    """{kernel: {"kernel": n, "plain": n, "fallback": n}}."""
    out: Dict[str, Dict[str, int]] = {
        name: {t: 0 for t in TIERS} for name in _KERNELS
    }
    for lbl, v in KERNEL_LAUNCH.items():
        out.setdefault(lbl["kernel"], {t: 0 for t in TIERS})[lbl["tier"]] = int(v)
    return out


def _current(device: torch.device):
    """``torch.cuda.device(device)``: the wrappers launch on
    ``_build.stream(device)`` through the CUDA runtime, which launches on
    its current device, so it must be the call's, or a tensor on cuda:1
    would meet a cuda:0 context. Without CUDA (a CPU build) no kernel can
    launch, and the gate's tests drive the tier with stand-in wrappers."""
    if torch.cuda.is_available():
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# torch stream objects by (device index, raw handle), for the timing events:
# ``torch.cuda.current_stream()`` builds a new one at each call, which cost
# more host time than the two event records of a timed launch
_STREAMS: Dict[Tuple[Optional[int], int], Any] = {}


class device_timed:
    """``with device_timed(dev, stream):`` around ONE ctypes launch of a
    kernel wrapper on ``dev``'s raw CUDA stream handle ``stream``: a pair
    of CUDA timing events on that stream, kept on the enclosing
    ``kernel:<name>`` span. Only the launch is inside the pair: the
    wrapper's allocations, its torch ops before and after (a contiguous
    copy, a total's reduction) and the host's marshalling of a later
    launch are not, so the device seconds are the kernels' own. Nothing
    is recorded outside a traced ``kernel``-tier call, or before CUDA is
    initialized (the CPU tests' stand-in wrappers)."""

    __slots__ = ("_dev", "_raw", "_span", "_events", "_stream")

    def __init__(self, dev: torch.device, stream: int):
        self._dev, self._raw = dev, stream
        self._span = None

    def __enter__(self) -> None:
        sp = _obs_trace.current_span()
        if isinstance(sp, _obs_trace.Span) and sp.kind == "kernel" and torch.cuda.is_initialized():
            key = (self._dev.index, self._raw)
            st = _STREAMS.get(key)
            if st is None:
                st = _STREAMS[key] = torch.cuda.current_stream(self._dev)
            self._span, self._stream = sp, st
            self._events = _obs_trace.device_events(st.device_index)
            self._events[0].record(st)

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None and exc_type is None:
            self._events[1].record(self._stream)
            self._span.add_events(self._events)
        return False


def launch(
    name: str,
    kernel_fn: Callable[[], Any],
    plain_fn: Callable[[], Any],
    *,
    device: torch.device,
    eligible: bool = True,
) -> Any:
    """Run ``kernel_fn()`` or ``plain_fn()`` by the tier rule above.
    ``device``: the device of the call's tensors; ``eligible``: the
    caller's per-call semantic verdict (only read on CUDA)."""
    spec = _KERNELS[name]
    with _obs_trace.span(f"kernel:{name}", kind="kernel") as sp:
        if device.type == "cpu":
            tier = "plain"
        elif device.type != "cuda":
            raise ValueError(f"kernel {name}: unsupported device {device}")
        else:
            tier = "kernel" if eligible else "fallback"
        sp.note("tier", tier)
        if tier != "kernel":
            KERNEL_LAUNCH.inc(kernel=name, tier=tier)
            return plain_fn()
        from ....runtime.faults import fault_point

        fault_point(spec.site)
        try:
            with _current(device):
                out = kernel_fn()
        except Exception as exc:
            from ....errors import reraise_if_device

            reraise_if_device(exc, site=spec.site)
            raise
        KERNEL_LAUNCH.inc(kernel=name, tier="kernel")
        return out
