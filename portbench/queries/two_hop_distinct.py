"""bench.py TWO_HOP_DISTINCT over a window of source persons: the distinct
(a, c) pairs two KNOWS apart with a in the window (chip_smoke.py's Q13 and
Q17, there over the whole graph)."""

from portbench import reference as R
from portbench.roofline import expand_bytes

QUERY = (
    "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
    "MATCH (a)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "WITH DISTINCT a, c RETURN count(*) AS pairs"
)
COLUMN = "pairs"


def params(ctx):
    return ctx.source_windows()


def reference(ctx, p):
    return ctx.source_sum(ctx.path_counts()["distinct_pairs"], p)


def control(ctx, p):
    """Exact DISTINCT broken: the pairs told apart by a 32-bit hash of
    their key, as a sort over 4-byte keys would."""
    return R.distinct_pairs_hashed32(ctx.pair_hashes32(), *ctx.span(p))


def work(ctx, p):
    """The chain walk's two hops: the window's persons to their out-edges,
    then each edge's far end to its out-edges; neither keeps the edge
    offsets."""
    w = ctx.walk_estimates()
    lo, hi = ctx.span(p)
    f, l1, l2 = hi - lo, int(w[0][lo:hi].sum()), int(w[1][lo:hi].sum())
    return {"expand_rows": expand_bytes(f, l1, False) + expand_bytes(l1, l2, False)}
