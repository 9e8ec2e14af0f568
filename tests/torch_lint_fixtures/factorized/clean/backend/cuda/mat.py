"""known-clean: the factorized run layout under full lattice discipline.

Lane and flat extents both round the bucket lattice, dead-lane prefix
sums are masked to the sentinel before the rank search, and weighted
totals mask pad lanes to the neutral element first. (The port's own
decode, ``backend/cuda/factorized.decode_lanes``, sizes every chunk
exactly on the ``expand_rows`` gate and declares it.)
"""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J

ID_SENTINEL = 1 << 62


def decode_rounded_total(cnts, flat_mask):
    tot = bucketing.round_size(int(torch.sum(cnts)))
    return J.mask_nonzero(flat_mask, size=tot)


def search_masked_prefix(run_mask, count_dev, total_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    cnts = J.mask_nonzero(run_mask, size=size)
    live = torch.arange(size, device=cnts.device) < n
    # re-establish the mask cumsum forfeited: dead lanes to the sentinel
    # so the rank search never lands on them
    prefix = torch.where(live, torch.cumsum(cnts, 0), ID_SENTINEL)
    flat = torch.arange(bucketing.round_size(int(total_dev)), device=cnts.device)
    return torch.searchsorted(prefix, flat, right=True)


def sum_masked_run_counts(run_mask, count_dev):
    n = int(count_dev)
    size = bucketing.round_size(n)
    cnts = J.mask_nonzero(run_mask, size=size)
    live = J._live_lanes(size, n, cnts)
    return torch.where(live, cnts, 0).sum()
