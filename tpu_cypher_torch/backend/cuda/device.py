"""The one place the CUDA backend's device is held.

Every tensor the backend makes is created on ``get()`` explicitly — no
module relies on PyTorch's default device. ``CypherSession.cuda(device=...)``
sets it through ``use``: ``None`` means ``cuda:0`` and requires CUDA;
``"cpu"`` (what the tests pass) runs every kernel's plain PyTorch version
on the host. Without CUDA and without an explicit CPU request ``use``
raises instead of carrying on quietly on the host.

Process-global, like the graph ingest it decides the placement of."""

from __future__ import annotations

from typing import Optional, Union

import torch

_DEVICE: Optional[torch.device] = None


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (explicitly or by default) but is not present."""


def resolve(device: Union[None, str, torch.device] = None) -> torch.device:
    """Turn a device request into a ``torch.device``: ``None`` -> ``cuda:0``.
    A CUDA device without CUDA raises ``DeviceUnavailable``."""
    d = torch.device("cuda", 0) if device is None else torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the host"
            )
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def use(device: Union[None, str, torch.device] = None) -> torch.device:
    """Make ``device`` the backend's device (see ``resolve``)."""
    global _DEVICE
    _DEVICE = resolve(device)
    return _DEVICE


def get() -> torch.device:
    """The backend's device; resolves the default (``cuda:0``) on first
    use, so a backend touched without a session still never lands on the
    host by accident."""
    if _DEVICE is None:
        return use(None)
    return _DEVICE
