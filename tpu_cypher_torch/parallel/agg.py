"""Run-length weighted segment partials for the factorized tier.

The port of ``tpu_cypher/parallel/agg.py``'s
``weighted_segment_partials`` (``:155-196``). The rest of that module, the
sharded aggregates over a device mesh, comes with the mesh layer
(ROADMAP.md queue 1, item 9); without a mesh there is no sharded tier.
"""

from __future__ import annotations

import torch

from ..backend.cuda.column import F64, I64


def _segment_sum(x, seg_j, k: int):
    """Per-group sums of ``x`` (``seg_j`` None: one group) through the
    ``segment_agg`` gate: an int64 sum over at most its group cap runs the
    kernel, a float sum or more groups its plain version (the ``fallback``
    tier on the card)."""
    from ..backend.cuda.hopper import segment_aggregate

    kind = F64 if x.is_floating_point() else I64
    return segment_aggregate(x, None, None, seg_j, name="sum", kind=kind, k=k)[0]


def weighted_segment_partials(data, valid, weight, seg_j, k: int):
    """``(weighted_sum_or_None, weighted_count)`` per group: every source
    row aggregates as ``weight`` identical flat rows without decompressing
    them. ``data`` None computes the count partial only (``count(*)``,
    ``count(expr)``). A row's count term is its weight (0 when invalid),
    its sum term ``data * weight``; integer terms sum exactly in int64 on
    the kernel, as the reference's sharded tier keeps them exact."""
    w = weight if valid is None else torch.where(valid, weight, torch.zeros_like(weight))
    wcnt = _segment_sum(w, seg_j, k)
    if data is None:
        return None, wcnt
    d = data if valid is None else torch.where(valid, data, torch.zeros_like(data))
    return _segment_sum(d * w.to(data.dtype), seg_j, k), wcnt
