"""The reference's shuffle API (``tpu_cypher/parallel/shuffle.py``), kept
for its names: the broadcast and hash-repartition equi-joins, the DISTINCT
count, and the key mixing they route by.

The reference needs these tiers because its rows really are sharded
``P('rows')``: equal keys must meet on one device. The port's tables stay
whole on the home device (``mesh.py``), so every process holds every row
and equal keys already meet there; routing them to shards would add a
mix, a sort and the copies to the single device's own probe or sort. So
under a mesh the joins and the DISTINCT count run the single-device path
(ROADMAP.md §3, differences by design), and the engine never calls these
functions. They keep the reference's contract: None when no mesh of more
than one shard is active (and, for ``broadcast_join``, when the build
side is over the broadcast window), else the same pairs or count the
single program gives.

``_mix64`` and ``combine_keys`` are the reference's uint64 arithmetic in
int64: multiplication wraps to the same bits, and every right shift is
made logical, since ``>>`` on int64 is arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs.trace import sync as host_sync
from ..runtime.faults import fault_point
from .mesh import mesh_size


def _s64(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)
_GOLDEN = _s64(0x9E3779B97F4A7C15)


def _srl(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def _mix64(k: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over the uint64 bits of int64 keys (returned
    as int64 of the same bits): equal keys mix equal, and structured key
    sets (strided ids, even-only ids, tag bits) spread evenly."""
    k = k.to(torch.int64)
    k = (k ^ _srl(k, 30)) * _M1
    k = (k ^ _srl(k, 27)) * _M2
    return k ^ _srl(k, 31)


def combine_keys(keys) -> torch.Tensor:
    """Fold several int64 key columns into one mixed 61-bit join key (the
    composite-key join). Collisions are possible: callers verify every key
    column on the matched pairs."""
    acc = torch.zeros(keys[0].shape, dtype=torch.int64, device=keys[0].device)
    for k in keys:
        acc = (acc * _GOLDEN) ^ k.to(torch.int64)
        acc = (acc ^ _srl(acc, 30)) * _M1
        acc = acc ^ _srl(acc, 31)
    return acc & ((1 << 61) - 1)


def _join_pairs(l_key, l_valid, r_key, r_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single program's inner equi-join pairs of int64 keys: build the
    right side, probe it on the ``join_probe`` gate, materialize."""
    from ..backend.cuda import jit_ops as J
    from ..backend.cuda.hopper import join_probe

    lvalids = () if l_valid is None else (l_valid,)
    rvalids = () if r_valid is None else (r_valid,)
    rd_s, r_order, nvalid = J.join_build(r_key, rvalids, is_f64=False, is_bool=False)
    fault_point("shuffle")  # the build and pair counts read below
    with host_sync("shuffle_build"):
        build_rows = int(nvalid)
    r_idx, lo, counts, total = join_probe(
        rd_s, r_order, l_key, lvalids, build_rows, is_f64=False, is_bool=False
    )
    with host_sync("shuffle"):
        pairs = int(total)
    return J.join_materialize(r_idx, lo, counts, pairs)


def broadcast_join(l_key, l_valid, r_key, r_valid) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Inner equi-join row pairs (left rows, right rows) under a mesh whose
    build (right) side fits the broadcast window
    (``optimizer.cost.broadcast_build_limit``: at least
    ``TPU_CYPHER_BROADCAST_LIMIT`` rows, default 4,096); None without a
    mesh of more than one shard, for an empty side, or over the window."""
    nsh = mesh_size()
    if nsh <= 1:
        return None
    from ..optimizer.cost import broadcast_build_limit

    n_l, n_r = int(l_key.shape[0]), int(r_key.shape[0])
    if n_l == 0 or n_r == 0 or n_r > broadcast_build_limit(n_l, nsh):
        return None
    return _join_pairs(l_key, l_valid, r_key, r_valid)


def hash_repartition_join(l_key, l_valid, r_key, r_valid) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Inner equi-join row pairs (left rows, right rows) under a mesh; None
    without a mesh of more than one shard or when a side is empty."""
    if mesh_size() <= 1 or int(l_key.shape[0]) == 0 or int(r_key.shape[0]) == 0:
        return None
    return _join_pairs(l_key, l_valid, r_key, r_valid)


def sharded_distinct_count(keys, valid=None) -> Optional[int]:
    """Distinct count of int64 keys (the valid ones) under a mesh; None
    without a mesh of more than one shard."""
    if mesh_size() <= 1:
        return None
    if valid is None:
        k = keys.to(torch.int64)
    else:
        with host_sync("shuffle_keys"):
            k = keys[valid].to(torch.int64)
    if int(k.shape[0]) == 0:
        return 0
    s = torch.sort(k).values
    fault_point("shuffle")  # the count read below
    steps = torch.sum(s[1:] != s[:-1], dtype=torch.int64)
    with host_sync("shuffle"):
        return int(steps) + 1
