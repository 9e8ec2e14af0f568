"""known-clean: per-shard bodies holding the shape disciplines.

Per-shard extents round the bucket lattice, pad lanes are masked to the
combine identity before any reduction, and sort keys force pads last via
the sentinel discipline.
"""
import torch
import torch.distributed as dist

from backend.cuda import bucketing
from backend.cuda import jit_ops as J

ID_SENTINEL = 1 << 62


def masked_partial_sum(mesh, count_dev):
    def per_shard(mask):
        n = int(count_dev)
        size = bucketing.round_size(n)
        vals = J.mask_nonzero(mask, size=size)
        live = torch.arange(size, device=vals.device) < n
        # pads contribute the combine identity to the all-reduce
        local = torch.sum(torch.where(live, vals, 0))
        dist.all_reduce(local)
        return local

    return [per_shard(m) for m in mesh.local_parts()]


def sentinel_shard_sort(mesh, count_dev):
    def per_shard(keys_dev):
        n = int(count_dev)
        size = bucketing.round_size(n)
        keys = J.mask_nonzero(keys_dev, size=size)
        live = torch.arange(size, device=keys.device) < n
        # sorted-pads-last before the exchange
        return torch.where(live, keys, ID_SENTINEL).sort().values

    return [per_shard(m) for m in mesh.local_parts()]


def bucketed_local_extent(mesh, count_dev):
    def per_shard(mask):
        size = bucketing.round_size(int(count_dev))
        # the per-shard extent is a lattice point: one launch shape total
        return J.mask_nonzero(mask, size=size)

    return [per_shard(m) for m in mesh.local_parts()]
