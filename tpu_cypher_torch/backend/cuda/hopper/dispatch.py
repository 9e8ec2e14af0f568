"""Kernel dispatch: ONE gate between the engine and every Hopper kernel.

The port of ``tpu_cypher/backend/tpu/pallas/dispatch.py`` (``register`` /
``launch``), with the same registry, ``kernel_*`` fault sites, trace spans
and per-(kernel, tier) launch counters. It differs in one place: the
reference quietly gives way to jnp after a compiled-path failure (its
broken-once memo); this gate never does. The tier follows the device of the
tensors the caller hands it:

* ``plain``    — CPU tensors: the kernel's plain PyTorch version runs;
* ``kernel``   — CUDA tensors and an eligible call: the kernel runs. A
                 build or launch error raises (typed when it is a device
                 fault) and is never memoized;
* ``fallback`` — CUDA tensors and an ineligible call (the semantic
                 ineligibility the reference has too, e.g. a float sum):
                 the plain version, which is the torch-op counterpart of
                 the reference's non-kernel path.

There is no ``off`` or ``interpret`` mode. ``use_counts()`` reads the
counters, which the obs registry serves as
``tpu_cypher_kernel_launch_total{kernel, tier}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ....obs import trace as _obs_trace
from ....obs.metrics import REGISTRY as _REGISTRY

TIERS = ("kernel", "plain", "fallback")


@dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its fault site, the TPU kernel it replaces
    and its CUDA source under ``tpu_cypher_torch/csrc``."""

    name: str
    site: str
    replaces: str
    source: str


_KERNELS: Dict[str, KernelSpec] = {}

KERNEL_LAUNCH = _REGISTRY.counter(
    "tpu_cypher_kernel_launch_total",
    "kernel dispatch outcomes per (kernel, tier=kernel|plain|fallback)",
    labels=("kernel", "tier"),
)


def register(name: str, site: str, replaces: str, source: str) -> None:
    _KERNELS[name] = KernelSpec(name, site, replaces, source)
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
            out = kernel_fn()
        except Exception as exc:
            from ....errors import reraise_if_device

            reraise_if_device(exc, site=spec.site)
            raise
        KERNEL_LAUNCH.inc(kernel=name, tier="kernel")
        return out
