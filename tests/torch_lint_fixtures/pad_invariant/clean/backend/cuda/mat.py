"""known-clean: sizes round the lattice or are primitive parameters."""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J
from backend.cuda.hopper import expand_materialize_counted


def counted_primitive(mask, size: int):
    # the *_counted shape: size is a parameter, callers round it
    return J.mask_nonzero(mask, size=size)


def rounded_call_site(rp, ci, eo, pos, deg, count_dev):
    n = int(count_dev)
    return expand_materialize_counted(
        rp, ci, eo, pos, deg, n, size=bucketing.round_size(n)
    )


def rounded_through_assignment(vals, counts, count_dev):
    total = bucketing.round_up_pow2(int(count_dev), 32)
    return torch.repeat_interleave(vals, counts, output_size=total)


def shape_derived_size(mask, other):
    # shape-derived sizes are already padded/static
    return J.mask_nonzero(mask, size=other.shape[0])
