"""The one place the CUDA backend's device is held.

Every tensor the backend makes is created on ``get()`` explicitly — no
module relies on PyTorch's default device. ``CypherSession.cuda(device=...)``
sets it through ``use``: ``None`` means ``cuda:0`` and requires CUDA;
``"cpu"`` (what the tests pass) runs every kernel's plain PyTorch version
on the host. Without CUDA and without an explicit CPU request ``use``
raises instead of carrying on quietly on the host.

Under a mesh (``parallel/mesh.py``) this device is the mesh's home
device: ``CypherSession.cuda(mesh=...)`` sets it to the mesh's first
device, tables stay whole here, and each sharded tier copies its slices
to the other devices of the mesh and combines their partials back here.
A kernel launches with its tensors' device made current
(``hopper/dispatch.py``), so a shard on another card launches there.

Process-global, like the graph ingest it decides the placement of.
Serving threads each run their queries on a stream of their own
(``serve/session_pool.py``); a cache filled on one thread's stream and
read from another's is published only after ``fence``."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ...obs.trace import sync as host_sync

_DEVICE: Optional[torch.device] = None
_GENERATORS: Dict[torch.device, torch.Generator] = {}


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


def generator(device: torch.device) -> torch.Generator:
    """The generator ``rand()`` draws from on ``device``: one per device,
    seeded once from the operating system's entropy, as Python's unseeded
    ``random`` module is."""
    g = _GENERATORS.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.seed()
        g = _GENERATORS.setdefault(device, g)
    return g


def fence() -> None:
    """Wait until the work this thread queued on the backend's device is
    done. Called before a lazily built device structure (a graph's CSR,
    a snapshot's scan tables) is published to other threads: they run on
    other CUDA streams, which do not wait for this thread's queue. Nothing
    to wait for on the CPU."""
    d = _DEVICE
    if d is not None and d.type == "cuda":
        with host_sync("fence"):
            # tpulint: allow[host-sync] reason=the fence is the contract: a lazily built structure is published to other streams only after its work is done
            torch.cuda.current_stream(d).synchronize()
