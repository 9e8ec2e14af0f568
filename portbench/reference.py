"""The plain reference: every answer worked out again from the edge arrays.

Plain PyTorch on whatever device it is given (the card after the window,
the CPU in the tests). It imports nothing of the program and takes nothing
the program built: it sorts the edges itself and counts with dense int32
blocks of the path matrix, filled by adding one for every 2-walk (the
program sorts and probes lanes, or multiplies bf16 adjacency blocks).
``truths.py`` holds the numpy witnesses these are tested against.

``two_path_blocks`` yields, for a block of sources ``[lo, hi)``, the int32
matrix ``M[a - lo, c]`` = the number of 2-walks a -> b -> c. From it, per
source a (a query over a window of sources sums its sources' counts):

* distinct (a, c) pairs: the nonzeros of row a;
* directed triangles a -> b -> c -> a: ``M[a, c]`` summed over the edges
  c -> a (trace(A^3) over all a);
* the 2-walks closed by an undirected KNOWS between c and a: the same sum
  over the edges c -> a and over the edges a -> c. The graphs have no
  self-loops, so distinct endpoints force distinct relationships and no
  relationship uniqueness check is needed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

# a block's M holds at most this many cells (int32: 1 GiB)
BLOCK_CELLS = 1 << 28
# and its source rows expand to at most this many 2-walk lanes
BLOCK_LANES = 1 << 26


class EdgeIndex:
    """The reference's own CSR of ``src -> dst`` over ``n`` nodes, on
    ``device``, sorted by source and by target."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int, device):
        self.n = n
        self.device = device
        s = torch.from_numpy(np.ascontiguousarray(src, dtype=np.int64)).to(device)
        d = torch.from_numpy(np.ascontiguousarray(dst, dtype=np.int64)).to(device)
        order = torch.argsort(s, stable=True)
        self.s_by_src, self.d_by_src = s[order], d[order]
        bounds = torch.arange(n + 1, device=device)
        self.rp = torch.searchsorted(self.s_by_src, bounds)
        order = torch.argsort(d, stable=True)
        self.s_by_dst, self.d_by_dst = s[order], d[order]
        self.rp_in = torch.searchsorted(self.d_by_dst, bounds)
        self.out_deg = self.rp[1:] - self.rp[:-1]


def _gather_ranges(starts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Concatenated ``arange(starts[i], starts[i] + lengths[i])``."""
    total = int(lengths.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    which = torch.repeat_interleave(torch.arange(len(lengths), device=starts.device),
                                    lengths, output_size=total)
    first = torch.cumsum(lengths, 0) - lengths
    return starts[which] + torch.arange(total, device=starts.device) - first[which]


def _blocks(ix: EdgeIndex) -> Iterator[Tuple[int, int]]:
    """Source blocks within both the cell and the lane budget (a block is
    at least one row)."""
    lanes_per_row = torch.zeros(ix.n, dtype=torch.int64, device=ix.device)
    lanes_per_row.index_add_(0, ix.s_by_src, ix.out_deg[ix.d_by_src])
    cum = torch.cumsum(lanes_per_row, 0).cpu().numpy()
    max_rows = max(1, BLOCK_CELLS // max(ix.n, 1))
    lo = 0
    while lo < ix.n:
        base = cum[lo - 1] if lo else 0
        hi = int(np.searchsorted(cum, base + BLOCK_LANES, side="right"))
        hi = min(max(hi, lo + 1), lo + max_rows, ix.n)
        yield lo, hi
        lo = hi


def two_path_blocks(ix: EdgeIndex) -> Iterator[Tuple[int, int, torch.Tensor]]:
    for lo, hi in _blocks(ix):
        e = torch.arange(int(ix.rp[lo]), int(ix.rp[hi]), device=ix.device)
        a, b = ix.s_by_src[e], ix.d_by_src[e]
        lanes = _gather_ranges(ix.rp[b], ix.out_deg[b])
        rows = torch.repeat_interleave(a - lo, ix.out_deg[b], output_size=len(lanes))
        m = torch.zeros((hi - lo) * ix.n, dtype=torch.int32, device=ix.device)
        m.index_add_(0, rows * ix.n + ix.d_by_src[lanes],
                     torch.ones(len(lanes), dtype=torch.int32, device=ix.device))
        yield lo, hi, m.view(hi - lo, ix.n)


def _closed(ix: EdgeIndex, lo: int, hi: int, m: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Per source a of the block, the sum of ``M[a, c]`` over the edges
    c -> a (``reverse``) or a -> c."""
    if reverse:
        sl = slice(int(ix.rp_in[lo]), int(ix.rp_in[hi]))
        a, c = ix.d_by_dst[sl], ix.s_by_dst[sl]
    else:
        sl = slice(int(ix.rp[lo]), int(ix.rp[hi]))
        a, c = ix.s_by_src[sl], ix.d_by_src[sl]
    out = torch.zeros(hi - lo, dtype=torch.int64, device=ix.device)
    return out.index_add_(0, a - lo, m[a - lo, c].to(torch.int64))


def path_counts(ix: EdgeIndex) -> dict:
    """{"distinct_pairs", "triangles", "undirected_closes"}, each an int64
    numpy array over the sources a: the count of the 2-walks from a."""
    out = {k: np.zeros(ix.n, np.int64) for k in ("distinct_pairs", "triangles", "undirected_closes")}
    for lo, hi, m in two_path_blocks(ix):
        out["distinct_pairs"][lo:hi] = torch.count_nonzero(m, dim=1).cpu().numpy()
        back = _closed(ix, lo, hi, m, reverse=True)
        out["triangles"][lo:hi] = back.cpu().numpy()
        out["undirected_closes"][lo:hi] = (back + _closed(ix, lo, hi, m, reverse=False)).cpu().numpy()
        del m
    return out


# ---------------------------------------------------------------------------
# relationship-unique walks from a window of sources
# ---------------------------------------------------------------------------


def walk_counts(ix: EdgeIndex, window: torch.Tensor, k: int) -> Tuple[list, list]:
    """(homomorphic, relationship-unique) walk counts of each length 1..k
    (k <= 4) from the sources where ``window`` (bool[n]) is set, of a
    loop-free multigraph. Homomorphic counts by a segment sum per node;
    the unique ones by rule: without loops adjacent edges differ, so only
    e1 = e3 (a->b->a->b), e2 = e4 and e1 = e4 can coincide; length 4 takes
    them by inclusion-exclusion (e1 = e3 with e2 = e4 is a->b->a->b->a;
    every other pair of coincidences forces a loop)."""
    if bool((ix.s_by_src == ix.d_by_src).any()):
        raise ValueError("walk_counts needs a loop-free graph")
    w = [ix.out_deg.clone()]
    for _ in range(k - 1):
        c = torch.cat([w[-1].new_zeros(1), torch.cumsum(w[-1][ix.d_by_src], 0)])
        w.append(c[ix.rp[1:]] - c[ix.rp[:-1]])
    hom = [int(x[window].sum()) for x in w]
    uniq = hom[:2]
    if k < 3:
        return hom, uniq[:k]
    keys = torch.sort(ix.s_by_src * ix.n + ix.d_by_src).values

    def mult(u, v):
        q = u * ix.n + v
        return (torch.searchsorted(keys, q, right=True)
                - torch.searchsorted(keys, q, right=False))

    sel = window[ix.s_by_src]
    sa, sb = ix.s_by_src[sel], ix.d_by_src[sel]  # the window's first edges
    back = mult(sb, sa)  # edges b -> a
    uniq.append(hom[2] - int(back.sum()))  # e1 = e3
    if k == 3:
        return hom, uniq
    s13 = int((back * ix.out_deg[sb]).sum())  # a->b->a->b->?, e3 = e1
    r = torch.zeros(ix.n, dtype=torch.int64, device=ix.device)
    r.index_add_(0, ix.s_by_src, mult(ix.d_by_src, ix.s_by_src))
    s24 = int(r[sb].sum())  # a->b->c->b->c, e4 = e2
    lanes = _gather_ranges(ix.rp[sb], ix.out_deg[sb])
    first = torch.repeat_interleave(torch.arange(len(sb), device=ix.device),
                                    ix.out_deg[sb], output_size=len(lanes))
    s14 = int(mult(ix.d_by_src[lanes], sa[first]).sum())  # a->b->c->a->b, e4 = e1
    uniq.append(hom[3] - s13 - s24 - s14 + int(back.sum()))
    return hom, uniq


def window_mask(ids: np.ndarray, lo: int, hi: int, device) -> torch.Tensor:
    """bool[n]: the persons with ``lo <= id < hi``."""
    t = torch.from_numpy(ids).to(device)
    return (t >= lo) & (t < hi)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 (arithmetic shifts; wrapping products)."""
    z = (z ^ (z >> 30)) * -4658895280553007687
    z = (z ^ (z >> 27)) * -7723592293110705685
    return z ^ (z >> 31)


def _hash32(keys: torch.Tensor) -> torch.Tensor:
    return _mix64(keys) & 0xFFFFFFFF


def pair_hashes32(ix: EdgeIndex) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, 32 bits of a hash of the key ``a * n + c``) of every distinct
    pair (a, c), ascending in a."""
    rows, hashes = [], []
    for lo, _hi, m in two_path_blocks(ix):
        r, c = torch.nonzero(m, as_tuple=True)
        rows.append(r + lo)
        hashes.append(_hash32((r + lo) * ix.n + c))
        del m
    return torch.cat(rows), torch.cat(hashes)


def distinct_pairs_hashed32(pairs, lo: int, hi: int) -> int:
    """The control of the distinct-pair count over the sources with node
    index in ``[lo, hi)``: the pairs told apart only by their 32-bit hash
    (``pairs`` from ``pair_hashes32``)."""
    rows, hashes = pairs
    a, b = (int(x) for x in torch.searchsorted(rows, torch.tensor([lo, hi], device=rows.device)))
    return int(torch.unique(hashes[a:b]).numel())


def closes_hashed32(ix: EdgeIndex) -> dict:
    """The control of the closing counts: ``path_counts``'s triangles and
    undirected closes per source with the closing KNOWS found by 32 bits of
    a hash of its key ``source * n + target``, as a probe over 4-byte keys
    would: a 2-walk a -> b -> c closes as often as edge keys share the
    hash of c -> a (and, undirected, of a -> c)."""
    table = torch.sort(_hash32(ix.s_by_src * ix.n + ix.d_by_src)).values

    def hits(keys):
        h = _hash32(keys)
        return (torch.searchsorted(table, h, right=True)
                - torch.searchsorted(table, h, right=False))

    out = {k: np.zeros(ix.n, np.int64) for k in ("triangles", "undirected_closes")}
    for lo, hi, m in two_path_blocks(ix):
        r, c = torch.nonzero(m, as_tuple=True)
        w = m[r, c].to(torch.int64)
        a = r + lo
        back = torch.zeros(hi - lo, dtype=torch.int64, device=ix.device)
        back.index_add_(0, r, w * hits(c * ix.n + a))
        fwd = torch.zeros(hi - lo, dtype=torch.int64, device=ix.device)
        fwd.index_add_(0, r, w * hits(a * ix.n + c))
        out["triangles"][lo:hi] = back.cpu().numpy()
        out["undirected_closes"][lo:hi] = (back + fwd).cpu().numpy()
        del m
    return out
