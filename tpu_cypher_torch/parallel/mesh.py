"""Device meshes for the sharded tiers.

The port of ``tpu_cypher/parallel/mesh.py``. The reference's mesh is a
``jax.sharding.Mesh``: under ``use_mesh`` every column and CSR array is
laid out ``P('rows')`` and GSPMD inserts the collectives. PyTorch has no
GSPMD, so the port keeps the reference's names and answers with this
layout (ROADMAP.md §3, differences by design):

* a ``Mesh`` is an ordered tuple of ``torch.device``s over one axis,
  ``ROW_AXIS``, hashable, so per-mesh caches key on it.
  A device list that repeats one device is a *virtual* mesh, the
  counterpart of the reference's forced 8-device CPU mesh;
* the home device is the mesh's first device (of this process), and it
  is the backend's device: tables, columns and every operator that is
  not a mesh tier stay whole there, with no pad rows;
* each tier splits what it reads into contiguous row slices, one per
  shard (``split``): on the home device a slice is a view, on another
  device a copy. Slices may be uneven, so there are no sentinel rows;
* collectives are explicit: ``combine`` moves per-shard partials to the
  home device and reduces them there in shard order (the reference's
  ``psum``/``pmin``/``pmax``), then, where the mesh spans processes,
  all-reduces them over ``torch.distributed`` (``multihost.py``);
* across processes every process holds the whole graph; the global
  mesh's shards are dealt to the processes in order (``Mesh.owners``)
  and a process computes only its own shards' partials.

The sharded SpMV, walk step and two-hop count stay torch ops, as the
reference's are jnp inside ``shard_map``; the range count runs each
shard's slice of the sorted keys through the ``intersect`` gate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.trace import sync as host_sync
from ..utils import config as _config

# engine-level row axis: the sharded tiers slice table rows and CSR edge
# arrays over it while a mesh is active
ROW_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one per shard. ``owners`` gives the
    process rank that computes each shard (empty: this process computes
    every shard) and ``rank`` this process's rank."""

    axis_names: ClassVar[Tuple[str, ...]] = (ROW_AXIS,)
    devices: Tuple[torch.device, ...]
    owners: Tuple[int, ...] = ()
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    def is_local(self, i: int) -> bool:
        """Does this process compute shard ``i``?"""
        return not self.owners or self.owners[i] == self.rank

    def local_shards(self) -> List[int]:
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def home(self) -> torch.device:
        """The first device of this process's shards: the backend's
        device, where tables live and partials combine."""
        return self.devices[self.local_shards()[0]]

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1


def _devices(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """Resolve a device list (``None``: every visible card; raises
    ``DeviceUnavailable`` without CUDA, as a CUDA entry does)."""
    from ..backend.cuda.device import DeviceUnavailable, resolve

    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available; pass an explicit device list "
                "(e.g. ['cpu'] * 8) for a virtual CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = tuple(resolve(d) for d in devices)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_row_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D engine mesh over ``ROW_AXIS``: the sharded tiers slice table
    rows and CSR edge arrays over it. ``devices`` defaults to every visible
    card; repeat a device for a virtual mesh (``["cpu"] * 8``)."""
    return Mesh(_devices(devices))


# the reference's constructor for its standalone sharded programs, which
# here take the same row mesh
make_mesh = make_row_mesh


_ACTIVE_MESH: Optional[Mesh] = None


class use_mesh:
    """Context manager activating the sharded tiers over ``mesh``; the
    previous mesh comes back on exit."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None

    def __enter__(self) -> Optional[Mesh]:
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc) -> None:
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev


def resolve_mesh(spec) -> Optional[Mesh]:
    """One mesh-construction chokepoint (``CypherSession.cuda(mesh=...)``,
    the ``TPU_CYPHER_MESH`` default). A ``Mesh`` passes through; a device
    list builds a row mesh over exactly those devices (the only way to a
    virtual mesh); an integer N takes the first N visible cards;
    ``"auto"``/``"all"`` takes every card. Anything that resolves to one
    device or fewer (``""``, ``"off"``, ``None``, 1, no CUDA) means
    single-device execution and returns None."""
    if spec is None:
        return None
    if isinstance(spec, Mesh):
        return spec
    if isinstance(spec, (list, tuple)):
        return make_row_mesh(spec)
    if isinstance(spec, int):
        n = spec
    else:
        s = str(spec).strip().lower()
        if s in ("", "off", "none", "0", "1"):
            return None
        if s in ("auto", "all"):
            n = _visible_cards()
        else:
            try:
                n = int(s)
            except ValueError:
                return None
    n = min(n, _visible_cards())
    if n <= 1:
        return None
    return make_row_mesh([torch.device("cuda", i) for i in range(n)])


def _visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def activate_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Set the process-global mesh (None deactivates). The session factory
    uses this; scoped activation should prefer ``use_mesh``."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


# env-default mesh, resolved lazily and memoized per spec string so the
# hot-path current_mesh() stays a dict probe after first use
_ENV_MESH_CACHE: dict = {}


def _env_default_mesh() -> Optional[Mesh]:
    spec = _config.MESH_SPEC.get()
    if spec not in _ENV_MESH_CACHE:
        _ENV_MESH_CACHE[spec] = resolve_mesh(spec)
    return _ENV_MESH_CACHE[spec]


def current_mesh() -> Optional[Mesh]:
    if _ACTIVE_MESH is not None:
        return _ACTIVE_MESH
    return _env_default_mesh()


def mesh_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size


# ---------------------------------------------------------------------------
# per-shard slices and the collectives
# ---------------------------------------------------------------------------


class ShardedRows(NamedTuple):
    """One array split into contiguous row slices, one per shard: shard i
    holds rows ``[bounds[i], bounds[i + 1])`` on its device (a view on the
    array's own device, else a copy), or None where another process
    computes it."""

    bounds: Tuple[int, ...]
    parts: Tuple[Optional[torch.Tensor], ...]


def shard_bounds(n: int, nsh: int) -> Tuple[int, ...]:
    """Contiguous, as even as integers allow: shard i takes rows
    ``[i * n // nsh, (i + 1) * n // nsh)``."""
    return tuple(i * n // nsh for i in range(nsh + 1))


def to_shard(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: itself where it already lies there, else a copy."""
    return x if x.device == dev else x.to(dev)


def split(mesh: Mesh, arr: torch.Tensor) -> ShardedRows:
    """``arr``'s rows as this process's per-shard slices over ``mesh``."""
    bounds = shard_bounds(int(arr.shape[0]), mesh.size)
    parts = tuple(
        to_shard(arr[bounds[i]:bounds[i + 1]], dev) if mesh.is_local(i) else None
        for i, dev in enumerate(mesh.devices)
    )
    return ShardedRows(bounds, parts)


def replicate(mesh: Mesh, x: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """``x`` once per shard (None for another process's), one copy per
    device it is not on."""
    copies: Dict[torch.device, torch.Tensor] = {x.device: x}
    out = []
    for i, dev in enumerate(mesh.devices):
        if not mesh.is_local(i):
            out.append(None)
            continue
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return tuple(out)


def as_sharded(mesh: Mesh, x: Union[torch.Tensor, ShardedRows]) -> ShardedRows:
    if isinstance(x, ShardedRows):
        if len(x.parts) != mesh.size:
            raise ValueError(f"{len(x.parts)} slices for a mesh of {mesh.size}")
        return x
    return split(mesh, x)


def fence(mesh: Mesh) -> None:
    """Wait for the work this thread queued on every CUDA device of the
    mesh's own shards (slices copied there are published after it)."""
    for dev in {mesh.devices[i] for i in mesh.local_shards()}:
        if dev.type == "cuda":
            with host_sync("fence"):
                # tpulint: allow[host-sync] reason=the fence is the contract: slices copied to a shard are published only after its work is done
                torch.cuda.current_stream(dev).synchronize()


_COMBINE: Dict[str, Callable] = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


def combine(mesh: Mesh, parts, op: str, device: torch.device) -> torch.Tensor:
    """The reference's ``psum``/``pmin``/``pmax`` over per-shard partials:
    this process's partials (None entries skipped) move to ``device`` and
    reduce there in shard order; a mesh that spans processes then
    all-reduces the result over ``torch.distributed``, so every process
    holds the same answer. Each partial is ordered after the launches that
    made it: the copy runs in stream order on its shard's device."""
    fn = _COMBINE[op]
    acc = None
    for p in parts:
        if p is None:
            continue
        p = to_shard(p, device)
        acc = p if acc is None else fn(acc, p)
    if acc is None:
        raise ValueError("combine: this process holds no shard of the mesh")
    if mesh.spans_processes:
        from . import multihost

        acc = multihost.all_reduce(acc, op)
    return acc


def shard_rows(arr):
    """An array's per-shard slices over the active mesh (a
    ``ShardedRows``); the array itself without a mesh, or when it has no
    rows. Slices may be uneven, so every length shards."""
    mesh = current_mesh()
    if mesh is None:
        return arr
    shape = getattr(arr, "shape", None)
    if not shape or shape[0] == 0:
        return arr
    return split(mesh, torch.as_tensor(arr))


def padded_to_mesh(host_arr) -> Tuple[object, int]:
    """A host array on the backend's device, split over the active mesh as
    ``shard_rows`` does. Returns ``(tensor or ShardedRows, pad)``; the pad
    is always 0: uneven slices need no fill rows."""
    from ..backend.cuda.column import to_device

    return shard_rows(to_device(np.asarray(host_arr))), 0


def pad_edges(src_idx: np.ndarray, col_idx: np.ndarray, num_shards: int):
    """The reference pads edge arrays to a multiple of the shard count with
    sentinel edges; uneven slices need none, so the arrays come back as
    they are, with a pad of 0."""
    return src_idx, col_idx, 0


def shard_edge_arrays(mesh: Mesh, *arrays) -> Tuple[ShardedRows, ...]:
    """Each array (host or device) split over ``mesh`` from its home
    device."""
    return tuple(split(mesh, torch.as_tensor(a, device=mesh.home)) for a in arrays)


# ---------------------------------------------------------------------------
# standalone sharded programs
# ---------------------------------------------------------------------------


def _local(mesh: Mesh, x: ShardedRows):
    """(shard index, device, slice, first row) of this process's shards."""
    for i in mesh.local_shards():
        yield i, mesh.devices[i], x.parts[i], x.bounds[i]


def _two_hop(mesh: Mesh, deg: torch.Tensor, col_idx) -> torch.Tensor:
    ci = as_sharded(mesh, col_idx)
    degs = replicate(mesh, deg)
    parts = [
        torch.sum(degs[i][c.to(torch.int64)].to(torch.int64))
        for i, _, c, _ in _local(mesh, ci)
    ]
    return combine(mesh, parts, "sum", deg.device)


def sharded_two_hop_count(mesh: Mesh, deg, col_idx):
    """sum over edges of outdeg(dst): each shard sums its slice of the
    edges, the partials combine. Returns an int64 scalar tensor."""
    return _two_hop(mesh, torch.as_tensor(deg), col_idx)


def _walk(mesh: Mesh, num_nodes: int, p: torch.Tensor, src, col) -> torch.Tensor:
    s_sh, c_sh = as_sharded(mesh, src), as_sharded(mesh, col)
    ps = replicate(mesh, p)
    parts = []
    for i, dev, s, _ in _local(mesh, s_sh):
        contrib = ps[i][s.to(torch.int64)]
        c = c_sh.parts[i].to(torch.int64)
        nxt = torch.zeros(num_nodes, dtype=contrib.dtype, device=dev)
        parts.append(nxt.index_add_(0, c, contrib))
    return combine(mesh, parts, "sum", p.device)


def sharded_walk_step(mesh: Mesh, num_nodes: int):
    """One frontier SpMM step: ``p'[v]`` = sum over the sharded edges
    (u, v) of ``p[u]``: per-shard partial next frontiers, combined."""

    def step(p, src, col):
        return _walk(mesh, num_nodes, torch.as_tensor(p), src, col)

    return step


def sharded_training_step(mesh: Mesh, num_nodes: int, hops: int):
    """The full multi-hop step: ``hops`` sharded SpMM steps and a final
    sharded 2-hop count. Returns ``(p_final, hop_counts, two_hop)``."""

    def step(p0, deg, src, col):
        src, col = as_sharded(mesh, src), as_sharded(mesh, col)
        p = torch.as_tensor(p0).to(torch.int64)
        counts = []
        for _ in range(hops):
            p = _walk(mesh, num_nodes, p, src, col)
            counts.append(torch.sum(p))
        hop_counts = torch.stack(counts) if counts else torch.zeros(0, dtype=torch.int64)
        return p, hop_counts, _two_hop(mesh, torch.as_tensor(deg), col)

    return step


def sharded_range_count(mesh: Mesh):
    """Per-query equal-key counts over the sorted keys split into
    contiguous slices, the mesh tier of the WCOJ intersect: range counts
    are additive over contiguous slices, so each shard counts its slice on
    the ``intersect`` gate and the counts sum. ``count(keys, q, qok)``:
    ``keys`` a sorted int64 tensor or its ``ShardedRows``; the queries and
    their mask are replicated to every shard."""
    from ..backend.cuda.hopper import intersect_range_count

    def count(keys, q, qok):
        ks = as_sharded(mesh, keys)
        qs, oks = replicate(mesh, q), replicate(mesh, qok)
        parts = []
        for i, _, k, _ in _local(mesh, ks):
            if int(k.shape[0]) == 0:  # an empty slice counts nothing
                parts.append(torch.zeros(q.shape, dtype=torch.int64, device=q.device))
                continue
            parts.append(intersect_range_count(k, qs[i], oks[i])[1])
        return combine(mesh, parts, "sum", q.device)

    return count
