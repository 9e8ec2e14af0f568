"""known-bad: the factorized run layout decoded without lattice discipline."""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J


def decode_exact_total(cnts, flat_mask):
    # the flat total (sum of run counts) baked unrounded into the decode
    # materialize: one launch shape per distinct factorization
    tot = int(torch.sum(cnts))
    return J.mask_nonzero(flat_mask, size=tot)


def search_unmasked_prefix(run_mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    cnts = J.mask_nonzero(run_mask, size=size)
    # cumsum forfeits the mask: pad lanes absorb the running total, so
    # the rank search binds flat rows to dead lanes
    prefix = torch.cumsum(cnts, 0)
    flat = torch.arange(size, device=cnts.device)
    return torch.searchsorted(prefix, flat, right=True)


def sum_unmasked_run_counts(run_mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    cnts = J.mask_nonzero(run_mask, size=size)
    # pad-lane run counts pollute the flat-row total
    return cnts.sum()
