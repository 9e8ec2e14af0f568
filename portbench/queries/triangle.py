"""bench.py TRIANGLE (chip_smoke.py's Q6) over a window of source persons:
directed triangles a -> b -> c -> a with a in the window, counted."""

from portbench.roofline import expand_bytes, intersect_bytes

QUERY = (
    "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
    "MATCH (a)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
    "RETURN count(*) AS triangles"
)
COLUMN = "triangles"


def params(ctx):
    return ctx.source_windows()


def reference(ctx, p):
    return ctx.source_sum(ctx.path_counts()["triangles"], p)


def control(ctx, p):
    """Exact matching broken: the closing KNOWS found by a 32-bit hash of
    its key, as a probe over 4-byte keys would."""
    return ctx.source_sum(ctx.closes_hashed32()["triangles"], p)


def work(ctx, p):
    """The first hop with its edge offsets, from the window's persons; then
    per edge a -> b the shorter of out(b) and in(a) expanded (two arms,
    each over every first-hop row) and range-counted against the other
    list's edge keys."""
    g, w = ctx.graph, ctx.walk_estimates()
    lo, hi = ctx.span(p)
    l1 = int(w[0][lo:hi].sum())
    arms = [int(a[lo:hi].sum()) for a in ctx.wcoj_arm_rows()]
    return {
        "expand_rows": expand_bytes(hi - lo, l1, True) + sum(expand_bytes(l1, a, False) for a in arms),
        "intersect": sum(intersect_bytes(g.e, a) for a in arms),
    }
