"""known-bad: data-dependent gate extents -> unbounded launch shapes."""
import torch

from backend.cuda import jit_ops as J
from backend.cuda.hopper import dispatch


def sized_gather(mask, *, size: int):
    return dispatch.launch(
        "expand_rows", lambda: _kernel(mask, size),
        lambda: J.mask_nonzero(mask, size=size), device=mask.device,
    )


def sized_repeat(vals, counts, total: int):
    return dispatch.launch(
        "expand_rows", lambda: _kernel(vals, total),
        lambda: torch.repeat_interleave(vals, counts, output_size=total),
        device=vals.device,
    )


def unbounded_signatures(mask):
    n = int(torch.sum(mask))
    # an unrounded count as a launch extent: unbounded launch shapes
    return sized_gather(mask, size=n)


def unbounded_positional(vals, counts):
    t = int(counts.sum())
    # same hazard through the positional extent
    return sized_repeat(vals, counts, t)
