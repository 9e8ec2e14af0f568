"""chip_smoke.py's Q22 over a window of source persons: the 2-walks
a -> b -> c with a in the window, closed by a KNOWS between c and a in
either direction (LDBC SNB's KNOWS is undirected), counted."""

from portbench.roofline import expand_bytes, intersect_bytes

QUERY = (
    "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
    "MATCH (a)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]-(a) "
    "RETURN count(*) AS t"
)
COLUMN = "t"


def params(ctx):
    return ctx.source_windows()


def reference(ctx, p):
    return ctx.source_sum(ctx.path_counts()["undirected_closes"], p)


def control(ctx, p):
    """Exact matching broken: the closing KNOWS found by a 32-bit hash of
    its key, as a probe over 4-byte keys would."""
    return ctx.source_sum(ctx.closes_hashed32()["undirected_closes"], p)


def work(ctx, p):
    """The chain walk's two hops (no edge offsets), then one range count of
    every 2-walk against the edge keys for each orientation of the close."""
    g, w = ctx.graph, ctx.walk_estimates()
    lo, hi = ctx.span(p)
    f, l1, l2 = hi - lo, int(w[0][lo:hi].sum()), int(w[1][lo:hi].sum())
    return {
        "expand_rows": expand_bytes(f, l1, False) + expand_bytes(l1, l2, False),
        "intersect": 2 * intersect_bytes(g.e, l2),
    }
