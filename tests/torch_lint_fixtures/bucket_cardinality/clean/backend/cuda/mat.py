"""known-clean: every gate extent routes the lattice (bounded shapes)."""
from backend.cuda import bucketing
from backend.cuda import jit_ops as J
from backend.cuda.hopper import dispatch


def sized_gather(mask, *, size: int):
    return dispatch.launch(
        "expand_rows", lambda: _kernel(mask, size),
        lambda: J.mask_nonzero(mask, size=size), device=mask.device,
    )


def bounded_signatures(mask, count_dev):
    # at most one launch shape per lattice rung
    n = bucketing.round_size(int(count_dev))
    return sized_gather(mask, size=n)


def literal_signature(mask):
    # exactly one launch shape
    return sized_gather(mask, size=128)
