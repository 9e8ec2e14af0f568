"""Sharded segment aggregates and run-length weighted partials.

The port of ``tpu_cypher/parallel/agg.py``. ``sharded_segment_agg`` is the
mesh tier of grouped aggregation: each shard's contiguous slice of the
rows reduces to a k-sized partial on the ``segment_agg`` gate, and the
partials combine as sum, min or max (``mesh.combine``, the reference's
``psum``/``pmin``/``pmax``), so no shard reads the whole row set.

Eligibility is the reference's: integer data (I64, BOOL) and the
aggregates whose combine is exact over the integers (count, sum, min,
max, and avg as an integer sum over an integer count). Float addition is
not associative, so float aggregates keep the single-program path, and
the sharded answers are bit-identical to it. ``TPU_CYPHER_MESH_AGG=off``
turns the tier off.

``weighted_segment_partials`` (``:155-196`` of the reference) is the
factorized tier's weighted partial.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..backend.cuda.column import F64, I64
from ..obs import trace as _obs_trace
from ..obs.metrics import REGISTRY as _REGISTRY
from ..runtime.faults import fault_point
from .mesh import combine, current_mesh, split

_MESH_AGG_TOTAL = _REGISTRY.counter(
    "tpu_cypher_mesh_agg_total",
    "grouped aggregates executed on the sharded (per-shard partial + "
    "tree combine) tier",
)

# aggregate names whose per-shard combine is exact over the integers
_INT_NAMES = ("count", "sum", "min", "max", "avg")


def _gate_open() -> bool:
    from ..utils.config import MESH_AGG

    return MESH_AGG.get().strip().lower() == "auto"


def _partials(mesh, data, valid, seg_j, name: str, k: int):
    """One ``(out, out_valid)`` per local shard: ``name`` over the shard's
    slice of the rows on the ``segment_agg`` gate, as kind I64 (min and
    max start from ``iinfo.max``/``iinfo.min`` and fill a null row with
    ``iinfo.max``/``-iinfo.max``, the reference's identities)."""
    from ..backend.cuda.hopper import segment_aggregate

    d = split(mesh, data)
    v = split(mesh, valid) if valid is not None else None
    s = split(mesh, seg_j) if seg_j is not None else None
    out = []
    for i in mesh.local_shards():
        vi = v.parts[i] if v is not None else None
        si = s.parts[i] if s is not None else None
        got = segment_aggregate(d.parts[i], vi, None, si, name=name, kind=I64, k=k)
        out.append(got[:2])
    return out


def sharded_segment_agg(
    data, valid, seg_j, name: str, is_bool: bool, k: int
) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """One grouped aggregate as per-shard partials and their combine.

    ``data``/``seg_j`` (None: one group) over the same rows, ``valid`` an
    optional mask. Returns ``(out_data, out_valid_or_None)`` in the
    single-program ``segment_aggregate`` contract, or None where the tier
    does not apply (no mesh of more than one shard, an aggregate that is
    not exact over the integers, the ``TPU_CYPHER_MESH_AGG=off`` gate, no
    rows): the caller keeps the single-program path. BOOL min and max
    reduce 0/1 as int32, as the reference reduces them as int8: every
    group's bool comes out as the single program's."""
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1 or name not in _INT_NAMES or k <= 0:
        return None
    if not _gate_open():
        return None
    if int(data.shape[0]) == 0:
        return None
    fault_point("agg")
    home = data.device
    d = data.to(torch.int32) if is_bool else data

    def run(op):
        parts = _partials(mesh, d, valid, seg_j, op, k)
        return parts, combine(mesh, [p[0] for p in parts], "sum" if op in ("count", "sum") else op, home)

    _MESH_AGG_TOTAL.inc()
    _obs_trace.note("agg_shards", mesh.size)
    if name in ("count", "sum"):
        return run(name)[1], None
    if name == "avg":
        ssum, cnt = run("sum")[1], run("count")[1]
        return ssum.to(torch.float64) / torch.clamp(cnt, min=1), cnt > 0
    parts, agged = run(name)
    # a group is valid where any shard saw a valid row in it
    any_valid = combine(mesh, [p[1] for p in parts], "max", home)
    return (agged.to(torch.bool) if is_bool else agged), any_valid


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
