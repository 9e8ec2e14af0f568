"""bench.py VAR_LENGTH: the relationship-unique walks of one to three KNOWS
from a window of source persons, counted (chip_smoke.py's Q18)."""

from portbench.roofline import expand_bytes

K = 3
QUERY = (
    "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
    "MATCH (a)-[:KNOWS*1..3]->(b:Person) RETURN count(*) AS walks"
)
COLUMN = "walks"


def params(ctx):
    return ctx.walk_windows(K)


def reference(ctx, p):
    return sum(ctx.walk_counts(p, K)[1])


def control(ctx, p):
    """Relationship uniqueness broken: every walk counted, an edge used
    twice or not."""
    return sum(ctx.walk_counts(p, K)[0])


def work(ctx, p):
    """One hop a length, with edge offsets (the uniqueness check reads
    them): hop j's frontier is hop j-1's lanes."""
    lanes = ctx.walk_lanes(p, K)
    return {"expand_rows": sum(expand_bytes(lanes[j], lanes[j + 1], True) for j in range(K))}
