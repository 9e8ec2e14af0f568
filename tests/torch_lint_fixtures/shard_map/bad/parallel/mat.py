"""known-bad: shape disciplines violated INSIDE per-shard bodies.

The per-shard closure a sharded tier runs on each local shard (the
``parallel/agg.py`` partials, the ``parallel/shuffle.py`` exchanges) is a
boundary like any other: the rules must look through the nesting and
judge the closure body itself, not just top-level functions.
"""
import torch
import torch.distributed as dist

from backend.cuda import bucketing
from backend.cuda import jit_ops as J


def unmasked_partial_sum(mesh, count_dev):
    def per_shard(mask):
        size = bucketing.round_size(int(count_dev))
        vals = J.mask_nonzero(mask, size=size)
        # pad lanes of the local shard ride the collective combine
        local = torch.sum(vals)
        dist.all_reduce(local)
        return local

    return [per_shard(m) for m in mesh.local_parts()]


def unmasked_shard_sort(mesh, count_dev):
    def per_shard(keys_dev):
        size = bucketing.round_size(int(count_dev))
        keys = J.mask_nonzero(keys_dev, size=size)
        # garbage lanes interleave with live rows before the exchange
        return keys.sort().values

    return [per_shard(m) for m in mesh.local_parts()]


def data_dependent_local_extent(mesh):
    def per_shard(mask):
        n = int(mask.sum())
        # a synced per-shard count baked into the extent: one launch
        # shape per distinct local cardinality
        return J.mask_nonzero(mask, size=n)

    return [per_shard(m) for m in mesh.local_parts()]
