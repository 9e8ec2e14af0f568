"""known-clean: bucketed or static extents at every kernel boundary."""
import torch

from backend.cuda import bucketing
from backend.cuda import jit_ops as J
from backend.cuda.hopper import dispatch

dispatch.register(
    "intersect", "kernel_intersect", replaces="pallas/intersect.py:106",
    source="csrc/range_count.cu", impls=("_launch",),
)


def bucketed_size_kwarg(mask, count_dev):
    n = bucketing.round_size(int(count_dev))
    return J.mask_nonzero(mask, size=n)


def unsized_away_from_the_gate(mask):
    # host-side exact compaction: legal away from the kernel boundary
    return torch.nonzero(mask, as_tuple=True)[0]


def _launch(mask, size):
    return J.mask_nonzero(mask, size=size)


def _consume(x):
    return dispatch.launch(
        "intersect", lambda: _launch(x, x.shape[0]), lambda: x, device=x.device
    )


def bucketed_array_into_gate(mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    idx = J.mask_nonzero(mask, size=size)
    return _consume(idx)


def bucketed_array_into_launch(mask, count_dev):
    size = bucketing.round_size(int(count_dev))
    idx = J.mask_nonzero(mask, size=size)
    return dispatch.launch(
        "intersect", lambda: _launch(idx, size), lambda: idx, device=idx.device
    )
