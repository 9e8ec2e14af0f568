"""known-bad: data-dependent shapes reaching the kernel launch gate."""
import torch

from backend.cuda import jit_ops as J
from backend.cuda.hopper import dispatch

dispatch.register(
    "intersect", "kernel_intersect", replaces="pallas/intersect.py:106",
    source="csrc/range_count.cu", impls=("_launch",),
)


def data_dependent_size_kwarg(mask):
    n = int(torch.sum(mask))
    # a synced data-dependent count baked into the materialize extent:
    # one launch shape per distinct n
    return J.mask_nonzero(mask, size=n)


def _launch(mask):
    # a registered kernel impl: the launch extent comes from the data
    return torch.nonzero(mask, as_tuple=True)[0]


def _consume(x):
    return dispatch.launch("intersect", lambda: _launch(x), lambda: x, device=x.device)


def data_array_into_gate(mask):
    idx = torch.nonzero(mask, as_tuple=True)[0]
    # data-dependent leading dim passed to a kernel gate
    return _consume(idx)


def data_array_into_launch(mask):
    idx = mask.nonzero().squeeze(1)
    # data-dependent leading dim crossing the dispatch gate itself
    return dispatch.launch("intersect", lambda: _launch(idx), lambda: idx, device=idx.device)
