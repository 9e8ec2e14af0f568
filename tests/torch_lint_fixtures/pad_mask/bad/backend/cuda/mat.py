"""known-bad: bucket-padded tensors reaching pad-sensitive ops unmasked."""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J


def unmasked_sum(mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    vals = J.mask_nonzero(mask, size=size)
    # pad lanes past the true count pollute the total
    return vals.sum()


def unmasked_sort(keys_dev, count_dev):
    size = bucketing.round_size(int(count_dev))
    padded = J.mask_nonzero(keys_dev, size=size)
    # garbage keys interleave with live rows
    return torch.sort(padded).values


def unmasked_searchsorted(table_dev, probes, count_dev):
    size = bucketing.round_size(int(count_dev))
    tbl = J.mask_nonzero(table_dev, size=size)
    # padded keys shift every rank
    return torch.searchsorted(tbl, probes)
