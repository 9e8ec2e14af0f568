"""Multi-process orchestration over ``torch.distributed``.

The port of ``tpu_cypher/parallel/multihost.py``. The reference connects
its per-host processes with ``jax.distributed.initialize`` and builds ONE
global ``Mesh`` over every device of every process; GSPMD's collectives
then cross processes where the engine shuffles. The port keeps the
recipe and the names:

* ``initialize_distributed`` joins a ``torch.distributed`` process group
  from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) where the reference reads
  ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``.
  The collective backend follows the devices the processes name
  (``collective_backend``): NCCL when each process's cards are its own,
  else ``gloo`` with the partials on the host (the CPU, or processes
  sharing one card: NCCL refuses two ranks on one GPU);
* ``global_row_mesh`` deals the global mesh's shards to the processes in
  order: each process contributes its own devices, and computes only its
  own shards' partials (``Mesh.owners``);
* every process ingests the whole graph, as every process of the
  reference does before its ``device_put`` shards it; the mesh tiers
  all-reduce their partials (``mesh.combine``), so every process returns
  the same answer.

Single-process use degenerates cleanly: ``initialize_distributed`` is a
no-op, the global mesh is the local mesh, and collecting is the identity.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..obs.trace import sync as host_sync
from ..runtime.faults import fault_point
from .mesh import Mesh, make_row_mesh, use_mesh

_STATE: dict = {}


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence] = None,
) -> bool:
    """Join this process to the job's process group.

    Arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` make the coordinator address, ``WORLD_SIZE`` the
    process count, ``RANK`` this process's rank. ``local_device_ids``
    names this process's devices (card numbers or device names; default:
    card ``LOCAL_RANK`` where CUDA is present, else the CPU). Returns True
    when a multi-process group was joined, False for the single-process
    case (no coordinator, one process). Idempotent.

    The group starts on ``gloo``; once every process's devices are known
    (``collective_backend``), the mesh's collectives move to an NCCL group
    where each process's cards are its own."""
    import torch.distributed as dist

    if _STATE.get("initialized"):
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False  # single process: nothing to coordinate
    if local_device_ids is not None:
        devices = list(make_row_mesh(local_device_ids).devices)
    elif torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        devices = [torch.device("cuda", local_rank % torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    per_rank: List = [None] * num_processes
    dist.all_gather_object(per_rank, (socket.gethostname(), [str(d) for d in devices]))
    backend = collective_backend(per_rank)
    group = None
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
        group = dist.new_group(backend="nccl")
    _STATE.update(initialized=True, backend=backend, devices=devices, group=group)
    return True


def collective_backend(per_rank) -> str:
    """``nccl`` when every process's devices are cards and no card is named
    by two processes of one host, else ``gloo`` (the CPU, or processes
    sharing a card: NCCL refuses two ranks on one GPU). ``per_rank``: per
    process, (host name, its device names)."""
    seen = set()
    for host, names in per_rank:
        cards = {(host, n) for n in names}
        if any(not n.startswith("cuda") for n in names) or cards & seen:
            return "gloo"
        seen |= cards
    return "nccl"


def shutdown_distributed() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``); a no-op when none was joined."""
    import torch.distributed as dist

    if _STATE.pop("initialized", False):
        dist.destroy_process_group()
    _STATE.clear()


def backend() -> Optional[str]:
    """The collective backend that runs (``nccl`` or ``gloo``), or None
    in a single process."""
    return _STATE.get("backend")


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _STATE.get("initialized") else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _STATE.get("initialized") else 0


def is_host0() -> bool:
    return process_index() == 0


def global_row_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Row mesh over every process's devices, process 0's first.
    ``devices``: this process's own devices (default: the cards
    ``initialize_distributed`` chose, or in one process every visible
    card); a repeated device makes virtual shards."""
    import torch.distributed as dist

    if not _STATE.get("initialized"):
        return make_row_mesh(devices)
    local = make_row_mesh(devices if devices is not None else _STATE["devices"]).devices
    gathered: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    devs, owners = [], []
    for rank, names in enumerate(gathered):
        devs.extend(torch.device(n) for n in names)
        owners.extend([rank] * len(names))
    return Mesh(tuple(devs), tuple(owners), dist.get_rank())


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced by ``op`` (sum, min, max) over every process; gloo
    reduces a host copy."""
    import torch.distributed as dist

    red = getattr(dist.ReduceOp, _OPS[op])
    if backend() == "nccl":
        t = t.clone()
        dist.all_reduce(t, red, group=_STATE["group"])
        return t
    with host_sync("shuffle"):
        # tpulint: allow[host-sync] reason=gloo reduces host tensors; a fault point here could raise on one rank and leave the others waiting in the collective
        host = t.cpu().clone()
    if host.dtype == torch.bool:  # gloo reduces no bools
        host = host.to(torch.uint8)
        dist.all_reduce(host, red)
        return host.to(torch.bool).to(t.device)
    dist.all_reduce(host, red)
    return host.to(t.device)


def collect_on_host0(arr) -> Optional[np.ndarray]:
    """An array's global value on process 0 (None elsewhere), the
    collect step. Every process holds whole tables and the mesh
    tiers hand every process the same partials, so process 0's copy is
    the global value; single process: the identity."""
    if not is_host0():
        return None
    if isinstance(arr, torch.Tensor):
        fault_point("shuffle")  # the collect's host copy
        with host_sync("shuffle"):
            return arr.detach().cpu().numpy()
    return np.asarray(arr)


class multihost_session:
    """Context manager for the scale-out recipe: initialize (no-op in one
    process) -> global mesh -> the mesh tiers active. ``devices`` is this
    process's own device list (see ``global_row_mesh``), which also
    decides the collective backend; the other keywords go to
    ``initialize_distributed``."""

    def __init__(self, devices: Optional[Sequence] = None, **init_kwargs):
        self._devices = devices
        self._init_kwargs = init_kwargs
        self._mesh_ctx = None

    def __enter__(self) -> Mesh:
        kwargs = dict(self._init_kwargs)
        if self._devices is not None:
            kwargs.setdefault("local_device_ids", self._devices)
        initialize_distributed(**kwargs)
        self._mesh_ctx = use_mesh(global_row_mesh(self._devices))
        return self._mesh_ctx.__enter__()

    def __exit__(self, *exc):
        return self._mesh_ctx.__exit__(*exc)


def _dryrun_graph(s, scale: Optional[float]):
    """(graph, label, type, ids, src, dst) of the dry run: the reference's
    51-node graph, or ``io.ldbc.generate_snb(scale, seed=42)``; ``src`` and
    ``dst`` index ``ids``."""
    from ..api.mapping import NodeMappingBuilder, RelationshipMappingBuilder
    from ..relational.graphs import ElementTable

    if scale is not None:
        from ..io.ldbc import generate_snb
        from ..relational.session import PropertyGraph

        sg = generate_snb(scale, s, seed=42)
        node = next(et for et in sg.scans if et.is_node).table
        rel = next(et for et in sg.scans if not et.is_node).table
        ids = np.asarray(node._cols["id"]._np_cache)  # generated sorted
        src = np.searchsorted(ids, rel._cols["source"]._np_cache)
        dst = np.searchsorted(ids, rel._cols["target"]._np_cache)
        return PropertyGraph(s, sg), "Person", "KNOWS", ids, src, dst
    n, e = 51, 173  # uneven over any mesh of 2 to 50 shards
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64) * 3 + 1
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    nt = s.table_cls.from_arrays({"id": ids})
    nm = NodeMappingBuilder.on("id").with_implied_label("P").build()
    rt = s.table_cls.from_arrays(
        {"rid": np.arange(len(src), dtype=np.int64) + 10_000, "s": ids[src], "t": ids[dst]}
    )
    rm = (
        RelationshipMappingBuilder.on("rid").from_("s").to("t")
        .with_relationship_type("K").build()
    )
    return s.read_from(ElementTable(nm, nt), ElementTable(rm, rt)), "P", "K", ids, src, dst


def dryrun_multihost(devices: Optional[Sequence] = None, scale: Optional[float] = None) -> dict:
    """Run the whole multi-process path in whatever topology this process
    sees (one process included): a session inside ``multihost_session``, a
    2-hop count on the mesh's chain, a row query, the host-0 collect, on
    the reference's 51-node graph or (``scale``) an LDBC-SNB-shaped one.
    Both answers are checked against numpy here. Returns a small report
    that names the collective backend."""
    from ..relational.session import CypherSession

    with multihost_session(devices) as mesh:
        s = CypherSession.cuda(mesh=mesh)
        g, label, rtype, ids, src, dst = _dryrun_graph(s, scale)
        got = g.cypher(
            f"MATCH (a:{label})-[:{rtype}]->(b)-[:{rtype}]->(c) RETURN count(*) AS c"
        ).records.collect()
        rows = g.cypher(
            f"MATCH (a:{label})-[:{rtype}]->(b) RETURN id(a) AS x ORDER BY x LIMIT 5"
        ).records.collect()
        host_rows = collect_on_host0(torch.tensor([int(r["x"]) for r in rows]))
    outdeg = np.bincount(src, minlength=len(ids))
    expected = int(outdeg[dst].sum())
    count = int(got[0]["c"])
    if count != expected:
        raise AssertionError(f"two-hop {count} != numpy {expected}")
    expected_rows = sorted(int(i) for i in ids[src])[:5]
    got_rows = [int(r["x"]) for r in rows]
    if got_rows != expected_rows:
        raise AssertionError(f"rows {got_rows} != numpy {expected_rows}")
    if host_rows is not None and host_rows.tolist() != got_rows:
        raise AssertionError("host 0's collected rows differ")
    return {
        "processes": process_count(),
        "devices": mesh.size,
        "mesh_axes": dict(mesh.shape),
        "two_hop": count,
        "rows": got_rows,
        "host0": is_host0(),
        "backend": backend(),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_cypher_torch.parallel.multihost [--scale S]
    [DEVICE ...]``: one process of a ``dryrun_multihost`` job over this
    process's devices (default: its card), its process group from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). Prints ``REPORT {json}``."""
    import argparse
    import json

    # the package's module, not this ``__main__`` copy: the mesh tiers
    # read the process group's state from it
    from tpu_cypher_torch.parallel import multihost as M

    ap = argparse.ArgumentParser(prog="python -m tpu_cypher_torch.parallel.multihost")
    ap.add_argument("--scale", type=float, default=None,
                    help="an LDBC-SNB-shaped graph of this scale (default: 51 nodes)")
    ap.add_argument("devices", nargs="*", help="this process's devices, e.g. cpu cpu")
    args = ap.parse_args(argv)
    try:
        report = M.dryrun_multihost(args.devices or None, scale=args.scale)
    finally:
        M.shutdown_distributed()
    print("REPORT " + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
