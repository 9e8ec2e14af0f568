"""known-clean: every padded lane is masked before its consumer."""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J

ID_SENTINEL = 1 << 62


def masked_sum(mask, count_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    vals = J.mask_nonzero(mask, size=size)
    live = torch.arange(size, device=vals.device) < n
    # the liveness-mask idiom: pads selected to the neutral element
    return torch.where(live, vals, 0).sum()


def mask_argument_sum(mask, count_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    vals = J.mask_nonzero(mask, size=size)
    live = J._live_lanes(size, n, vals)
    # the sanctioned in-place form: the reduction's own mask
    return torch.masked.sum(vals, mask=live)


def sentinel_sort(keys_dev, count_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    keys = J.mask_nonzero(keys_dev, size=size)
    live = torch.arange(size, device=keys.device) < n
    # the sorted-pads-last discipline: pads forced to the sentinel
    return torch.sort(torch.where(live, keys, ID_SENTINEL)).values
