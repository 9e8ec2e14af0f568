"""known-clean: delta-overlay extents round on the bucket lattice.

The overlay pads to ``max(round_size(n), min_bucket)`` — one launch shape
per bucket, shared by every write batch that fits, so delta fill never
re-keys a warm scan.
"""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J

MIN_BUCKET = 8


def overlay_pad_target(n: int) -> int:
    # the overlay's lattice home: round up, never below the min bucket
    return max(bucketing.round_size(n), MIN_BUCKET)


def overlay_live_rows(live_mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    return J.mask_nonzero(live_mask, size=size)


def overlay_gather_counted(live_mask, count, k: int):
    # *_counted discipline: k is a bucketed parameter, the true count
    # travels as a tensor and masks the tail
    pos = J.mask_nonzero(live_mask, size=k)
    return pos, torch.arange(k, dtype=torch.int64, device=pos.device) < count


def overlay_tombstone_repeat(vals, counts, dead_dev):
    total = bucketing.round_up_pow2(int(dead_dev), MIN_BUCKET)
    return torch.repeat_interleave(vals, counts, output_size=total)
