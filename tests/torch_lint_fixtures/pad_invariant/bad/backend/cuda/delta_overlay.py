"""known-bad: delta-overlay tables sized off the bucket lattice.

The delta overlay holds the rows written since the last compaction. Its
extents must round on the same lattice as the base tables — sizing them
to the exact live row count gives one scan/union launch shape per
distinct delta fill. The first case is the lexical rule's known blind
spot, kept one for one with the reference's corpus: ``len()`` of a
parameter passes as caller-sized.
"""
import torch

from backend.cuda import jit_ops as J


def overlay_exact_rows(live_mask, delta_rows):
    # delta extent = exact number of live overlay rows: every committed
    # write changes the scan shape
    n = len(delta_rows)
    return J.mask_nonzero(live_mask, size=n)


def overlay_synced_count(live_mask):
    # device-synced live count passed straight down as the size
    n = int(torch.sum(live_mask))
    return J.mask_nonzero(live_mask, size=n)


def overlay_tombstone_repeat(vals, counts):
    # tombstone expansion sized to the exact dead-row total
    dead_total = int(counts.sum())
    return torch.repeat_interleave(vals, counts, output_size=dead_total)
