"""The standalone kernel API: 2-hop, triangle and walk counts on a CSR.

The port of ``tpu_cypher/backend/tpu/kernels.py``: the hot query shapes as
functions over a compacted CSR, outside the query engine, for counting
workloads and benchmarks.

* ``CsrGraph``       — compacted int32-indexed CSR of one relationship set
                       (ids stay int64), built by the native C++ tier
                       (``native.build_csr_native``: two counting sorts)
                       or, where that did not build, by numpy with the
                       same contract
* ``two_hop_count``  — 2-hop path count: the ``frontier_deg_sum`` gate
                       with ``pos = col_idx`` and every slot present, as
                       the reference calls its Pallas gate
* ``two_hop_expand`` — every 2-hop pair (a, c) and the distinct count; the
                       lanes come from the ``expand_rows`` gate, as the
                       fused expand takes them
* ``triangle_count`` — the closing probe of every 2-hop pair on the
                       ``intersect`` gate (the reference's two
                       ``searchsorted`` calls compute the same function)
* ``walk_counts``    — the iterated sparse frontier propagation; the
                       reference's ``lax.scan`` is a Python loop of
                       ``index_select`` and ``index_add_``

Every function runs on the device of the tensors it is given; a
``CsrGraph`` lives on the card unless ``build`` is asked for the CPU
(``device="cpu"``), where each gate runs its kernel's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from . import device as _device


@dataclass
class CsrGraph:
    """Compacted CSR over one relationship type.

    ``node_ids``: sorted unique int64 element ids (index = compact id)
    ``row_ptr``:  (N+1,) int32 offsets into ``col_idx``
    ``col_idx``:  (E,) int32 target compact ids, sorted within each row
    ``src_idx``:  (E,) int32 source compact id per edge (row-expanded)
    """

    node_ids: torch.Tensor
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    src_idx: torch.Tensor
    _max_deg: Optional[int] = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.col_idx.shape[0])

    @staticmethod
    def build(
        node_ids: np.ndarray,
        src: np.ndarray,
        dst: np.ndarray,
        device: Union[None, str, torch.device] = None,
    ) -> "CsrGraph":
        """The CSR of the edges ``src[i] -> dst[i]`` (element ids) over
        ``node_ids`` (deduplicated), on ``device`` (default: the card).
        Raises ValueError when an endpoint is not among ``node_ids``."""
        from ... import native

        dev = _device.resolve(device)
        built = native.build_csr_native(node_ids, src, dst)
        if built is None:
            built = _build_csr_numpy(node_ids, src, dst)
        ids, row_ptr, col_idx, src_idx = (
            torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in built
        )
        return CsrGraph(ids, row_ptr, col_idx, src_idx)

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def max_degree(self) -> int:
        """Host-cached max out-degree: one device read per graph."""
        if self._max_deg is None:
            self._max_deg = int(self.degrees.max()) if self.num_nodes else 0
        return self._max_deg


def _build_csr_numpy(node_ids, src, dst):
    """``native.build_csr_native``'s contract by numpy: (unique ids,
    row_ptr, col_idx, src_idx) lexsorted by (src, dst)."""
    node_ids = np.unique(np.asarray(node_ids, dtype=np.int64))
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n = len(node_ids)
    s = np.searchsorted(node_ids, src)
    d = np.searchsorted(node_ids, dst)
    if len(s) and (
        s.max(initial=0) >= n
        or d.max(initial=0) >= n
        or not (node_ids[s] == src).all()
        or not (node_ids[d] == dst).all()
    ):
        raise ValueError("Edge endpoint id not present in node_ids")
    s, d = s.astype(np.int32), d.astype(np.int32)
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    row_ptr = np.searchsorted(s, np.arange(n + 1)).astype(np.int32)
    return node_ids, row_ptr, d, s


# ---------------------------------------------------------------------------
# 2-hop (Expand -> Expand)
# ---------------------------------------------------------------------------


def two_hop_count(row_ptr: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """Number of 2-hop paths a->b->c = sum over edges (a, b) of outdeg(b),
    as a 0-d int64 tensor: the frontier degree-sum shape (frontier =
    ``col_idx``, every slot present) on the ``frontier_deg_sum`` gate."""
    from .hopper import csr_frontier_degree_sum

    pos = col_idx.to(torch.int64)
    present = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    return csr_frontier_degree_sum(row_ptr, pos, present)


def _two_hop_lanes(row_ptr, col_idx, src_idx, total: int):
    """(a, c) compact ids of every 2-hop path, ``total`` of them: the second
    hop's lanes over the first hop's edges from the ``expand_rows`` gate
    (``row`` = the first edge, ``nbr`` = c)."""
    from .hopper import expand_materialize_counted

    pos = col_idx.to(torch.int64)
    deg = (row_ptr[pos + 1] - row_ptr[pos]).to(torch.int64)
    row, c, _, _ = expand_materialize_counted(
        row_ptr, col_idx, None, pos, deg, total, size=total, with_orig=False
    )
    return src_idx[row].to(torch.int64), c


def two_hop_expand(
    row_ptr: torch.Tensor,
    col_idx: torch.Tensor,
    src_idx: torch.Tensor,
    total: int,
    count_distinct: bool = True,
):
    """Every 2-hop pair (a, c) as int64 compact ids, and with
    ``count_distinct`` the 0-d int64 count of distinct pairs. ``total``
    must equal ``two_hop_count`` (read once on the host)."""
    total = int(total)
    if total == 0:  # before the gate: it takes no empty frontier
        a = c = torch.zeros(0, dtype=torch.int64, device=col_idx.device)
        zero = torch.zeros((), dtype=torch.int64, device=col_idx.device)
        return (a, c, zero) if count_distinct else (a, c)
    a, c = _two_hop_lanes(row_ptr, col_idx, src_idx, total)
    if not count_distinct:
        return a, c
    n = int(row_ptr.shape[0]) - 1
    key, _ = torch.sort(a * n + c)
    distinct = 1 + torch.count_nonzero(key[1:] != key[:-1])
    return a, c, distinct


def triangle_count(
    row_ptr: torch.Tensor,
    col_idx: torch.Tensor,
    src_idx: torch.Tensor,
    total: int,
) -> torch.Tensor:
    """Directed triangles a->b->c->a (the ExpandInto closure) as a 0-d
    int64 tensor: every 2-hop path's closing edge (c, a) counted, with
    multiplicity, in the sorted ``src*N + dst`` edge keys on the
    ``intersect`` gate."""
    from .hopper import intersect_range_count

    dev = col_idx.device
    if int(total) == 0 or int(col_idx.shape[0]) == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    a, c = two_hop_expand(row_ptr, col_idx, src_idx, total, count_distinct=False)
    n = int(row_ptr.shape[0]) - 1
    # edges are lexsorted by (src, dst), so the keys come out sorted
    keys = src_idx.to(torch.int64) * n + col_idx.to(torch.int64)
    probe = c * n + a
    del a, c
    ok = torch.ones(probe.shape[0], dtype=torch.bool, device=dev)
    return intersect_range_count(keys, probe, ok)[2]


# ---------------------------------------------------------------------------
# var-length frontier loop
# ---------------------------------------------------------------------------


def walk_counts(
    src_idx: torch.Tensor,
    col_idx: torch.Tensor,
    start,
    hops: int,
    num_nodes: int,
) -> torch.Tensor:
    """Iterated sparse frontier propagation ``p_{k+1}[v] = sum_{(u,v)}
    p_k[u]``: (hops, N) int64 walk counts for k = 1..hops, on the device
    of ``src_idx`` (walks, not trails: edge distinctness is the query
    engine's)."""
    dev = src_idx.device
    p = torch.as_tensor(start, device=dev).to(torch.int64)
    src, dst = src_idx.to(torch.int64), col_idx.to(torch.int64)
    out = torch.zeros((hops, num_nodes), dtype=torch.int64, device=dev)
    for k in range(hops):
        out[k].index_add_(0, dst, torch.index_select(p, 0, src))
        p = out[k]
    return out
