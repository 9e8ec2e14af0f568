"""known-bad: sized materializes that skip the bucket lattice."""
import torch

from backend.cuda import jit_ops as J
from backend.cuda.hopper import expand_materialize_counted


def unsized_nonzero(mask):
    # value-dependent output shape: the compaction syncs for its extent
    return torch.nonzero(mask, as_tuple=True)[0]


def unrounded_size(mask):
    n = int(torch.sum(mask))
    # a locally synced count passed straight down: one launch shape per
    # distinct n
    return J.mask_nonzero(mask, size=n)


def unrounded_gate_size(rp, ci, eo, pos, deg):
    count_dev = deg.sum()
    n = int(count_dev)
    return expand_materialize_counted(rp, ci, eo, pos, deg, n, size=n)


def unrounded_repeat(vals, counts):
    total = int(torch.sum(counts))
    return torch.repeat_interleave(vals, counts, output_size=total)
