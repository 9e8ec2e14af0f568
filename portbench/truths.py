"""numpy and scipy truths, frozen copies of ``chip_smoke.py``'s.

The tests hold ``reference.py`` to these and to brute force at small sizes;
the harness itself does not run them (at SF10 they take longer than a run's
window). Copied rather than imported, so that no change to the smoke script
can change what the benchmark is checked against.
"""


def check(cond, msg):
    if not cond:
        raise ValueError(msg)


def two_hop_distinct_pairs(s, d, n) -> int:
    """(distinct (a, c), 2-hop paths) over the paths a->b->c of the edges
    (s, d) (node indices), from numpy: each edge's far end's out-edges,
    packed as a * n + c."""
    import numpy as np

    out = np.bincount(s, minlength=n)
    order = np.argsort(s, kind="stable")
    starts = np.concatenate([[0], np.cumsum(out)])
    reps = out[d]
    total = int(reps.sum())
    base = np.repeat(starts[d] - np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
    c = d[order][base + np.arange(total)]
    a = np.repeat(s, reps)
    return len(np.unique(a.astype(np.int64) * n + c)), total


def two_hop_distinct_scipy(s, d, n, step=8192) -> int:
    """Distinct (a, c) over the 2-walks a->b->c: the nonzeros of A @ A on
    the binary adjacency, by row block (scipy)."""
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    A.data[:] = 1  # duplicates summed: binary again
    A = A.astype(np.int32)
    return sum(int((A[lo:lo + step] @ A).nnz) for lo in range(0, n, step))


def walk_window(est, budget: int, start: int) -> int:
    """bench.py's source window rule: from ``start``, the number of sources
    whose walk estimates ``est`` sum to ``budget`` (at least one)."""
    import numpy as np

    cum = np.cumsum(est[start:])
    return min(max(1, int(np.searchsorted(cum, budget))), len(est) - start)


def walk_estimates(s, d, n, k):
    """[w_1, ..., w_k]: w_j[v] = directed j-walks from v with edge
    multiplicity, exact int64 (a segment sum per node over its out-edges
    in CSR order)."""
    import numpy as np

    order = np.argsort(s, kind="stable")
    rp = np.searchsorted(s[order], np.arange(n + 1))
    dsort = d[order]
    w = [np.bincount(s, minlength=n).astype(np.int64)]
    for _ in range(k - 1):
        c = np.concatenate([[0], np.cumsum(w[-1][dsort])])
        w.append(c[rp[1:]] - c[rp[:-1]])
    return w


def edge_multiplicity(s, d, n):
    """A vectorized ``mult(u, v)``: how many edges run u->v."""
    import numpy as np

    keys = np.sort(s.astype(np.int64) * n + d)

    def mult(u, v):
        q = u.astype(np.int64) * n + v
        return np.searchsorted(keys, q, side="right") - np.searchsorted(keys, q, side="left")

    return mult


def unique_walk_counts(s, d, n, window, k):
    """Relationship-unique directed walks of each length 1..k (k <= 4) from
    the sources in ``window`` (bool[n]) of a loop-free multigraph, by rule:
    the homomorphic count less the walks that reuse an edge. Without loops
    adjacent edges differ, so only e1 = e3 (a->b->a->b), e2 = e4 and
    e1 = e4 can coincide; length 4 takes them by inclusion-exclusion
    (e1 = e3 with e2 = e4 is a->b->a->b->a; every other pair of
    coincidences forces a loop)."""
    import numpy as np

    check(not (s == d).any(), "unique_walk_counts needs a loop-free graph")
    w = walk_estimates(s, d, n, k)
    hom = [int(x[window].sum()) for x in w]
    out = hom[:2]
    if k < 3:
        return out[:k]
    mult = edge_multiplicity(s, d, n)
    ew = window[s]
    sa, sb = s[ew], d[ew]  # the window's first edges (a, b)
    back = mult(sb, sa)  # edges b->a
    out.append(hom[2] - int(back.sum()))  # e1 = e3
    if k == 3:
        return out
    outdeg = w[0]
    s13 = int((back * outdeg[sb]).sum())  # a->b->a->b->?, e3 = e1
    r = np.bincount(s, weights=mult(d, s), minlength=n).astype(np.int64)
    s24 = int(r[sb].sum())  # a->b->c->b->c, e4 = e2
    order = np.argsort(s, kind="stable")
    rp = np.searchsorted(s[order], np.arange(n + 1))
    deg = outdeg[sb]
    first = np.repeat(np.arange(len(sb)), deg)
    off = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    c = d[order][rp[sb][first] + off]  # each window edge's b->c
    s14 = int(mult(c, sa[first]).sum())  # a->b->c->a->b, e4 = e1
    out.append(hom[3] - s13 - s24 - s14 + int(back.sum()))
    return out


def brute_walks(steps, n, sources, k, pairs=False, uses=False):
    """Brute force: enumerate every relationship-unique walk of length
    1..k from each source over ``steps`` = (src, dst, relationship id) of
    each traversable step (an undirected graph lists both orientations of
    a relationship under one id), level by level, a source at a time.
    Returns the walk count per length; with ``pairs`` also the sorted
    (source * n + end) keys of each length, with ``uses`` instead the
    number of walks each relationship is on."""
    import numpy as np

    src, dst, rid = steps
    order = np.argsort(src, kind="stable")
    rp = np.searchsorted(src[order], np.arange(n + 1))
    counts = [0] * k
    keys = [[] for _ in range(k)]
    on = np.zeros(int(rid.max()) + 1 if len(rid) else 0, np.int64)
    for a in sources:
        walks = np.zeros((1, 0), np.int64)
        ends = np.array([a], np.int64)
        for level in range(k):
            deg = rp[ends + 1] - rp[ends]
            row = np.repeat(np.arange(len(ends)), deg)
            off = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
            step = order[rp[ends][row] + off]
            prev = walks[row]
            ok = (prev != rid[step][:, None]).all(axis=1)
            walks = np.concatenate([prev[ok], rid[step][ok][:, None]], axis=1)
            ends = dst[step][ok]
            counts[level] += len(ends)
            if pairs:
                keys[level].append(int(a) * n + ends)
            if uses:
                on += np.bincount(walks.ravel(), minlength=len(on))
            if not len(ends):
                break
    if uses:
        return counts, on
    if not pairs:
        return counts
    return counts, [np.sort(np.concatenate(x)) if x else np.zeros(0, np.int64)
                    for x in keys]


def directed_steps(s, d):
    import numpy as np

    return s, d, np.arange(len(s), dtype=np.int64)


def triangle_truth(ids, src, dst, rows_and_cliques):
    """scipy ground truth over the generator's arrays, with edge
    multiplicity: the directed triangle count trace(A^3), the per-edge
    sum of min(out(b), in(a)) (the count tier's expanded lanes), and per
    node a the 2-paths a->b->c closed by an undirected c-a edge (A^2 o A^T
    plus A^2 o A, by row: Q22 and Q24); with ``rows_and_cliques`` also the
    triangle rows (a, b, c, multiplicity) and the 4-clique count. The
    graphs are loop-free (checked), so distinct endpoints force distinct
    relationships, and no undirected close is a self-loop."""
    import numpy as np
    import scipy.sparse as sp

    check(not (src == dst).any(), "generated graph has a self-loop")
    n = len(ids)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    A = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
    A.sum_duplicates()
    AT = A.T.tocsr()
    out_deg = np.bincount(s, minlength=n)
    in_deg = np.bincount(d, minlength=n)
    truth = {"min_lanes": int(np.minimum(out_deg[d], in_deg[s]).sum())}
    tri = 0
    step = 4096
    close_rows = np.zeros(n, np.int64)
    for lo in range(0, n, step):  # trace(A^3) = sum(A^2 o A^T), by row block
        paths = A[lo:lo + step] @ A
        closed = np.asarray(paths.multiply(AT[lo:lo + step]).sum(axis=1)).ravel()
        tri += int(closed.sum())
        close_rows[lo:lo + step] = closed + np.asarray(
            paths.multiply(A[lo:lo + step]).sum(axis=1)).ravel()
    truth["triangles"] = tri
    truth["close_rows"] = close_rows
    if rows_and_cliques:
        pa, pb = A.nonzero()
        M = A[pb].multiply(AT[pa]).tocoo()  # per (a, b) pair: c with b->c->a
        w = M.data * np.asarray(A[pa[M.row], pb[M.row]]).ravel()
        # scipy's indices are int32: widen before the row code (a*n+b)*n+c
        ta, tb, tc = (x.astype(np.int64) for x in (pa[M.row], pb[M.row], M.col))
        check(int(w.sum()) == tri, "the two triangle counts disagree")
        truth["rows"] = np.sort(np.repeat((ta * n + tb) * n + tc, w))
        closes = np.asarray(A[ta].multiply(A[tb]).multiply(A[tc]).sum(axis=1)).ravel()
        truth["cliques"] = int((w * closes).sum())
        # the 4-clique count tier's lanes over the triangle rows: per row
        # the smallest of out(a), out(b), out(c)
        m3 = np.minimum(np.minimum(out_deg[ta], out_deg[tb]), out_deg[tc])
        truth["clique_min_lanes"] = int((w * m3).sum())
        truth["pivot_lanes"] = int(out_deg[d].sum())
    return truth
