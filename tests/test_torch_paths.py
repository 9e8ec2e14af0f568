"""Paths, nested and mixed lists, list and map equality and order, and
``reduce`` on the device: the port against the JAX package, on the CPU.

Each query runs through the port (``CypherSession.cuda(device="cpu")``),
the reference's ``CypherSession.tpu()`` and its ``local()`` oracle, and
the three bags of rows must be identical (lists compared element by
element); a query with ``ORDER BY`` must also give its rows in the same
order as the oracle. The port answers each on the device rung, and a
named path over a var-length pattern plans ``CsrVarExpandOp``. Where the
oracle raises, the port raises the oracle's error class.
"""

import pytest
import torch

from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD

from test_torch_lists import ORDERED, _bag, _creates, _three, _value

torch.set_num_threads(1)

CREATE = (
    "CREATE (a:P {n: 1, s: 'x', f: 1.5})-[:K {w: 2}]->(b:P {n: 2, f: 2.0}),"
    "(b)-[:K {w: 3}]->(c:P:Q {n: 3, s: 'y'}), (c)-[:K {w: 4}]->(a),"
    "(c)-[:L {w: 5}]->(d:Q {n: 4, s: 'x'}), (d)-[:K {w: 6}]->(d)"
)


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


@pytest.fixture(scope="module")
def engines():
    return _creates(CREATE)


PATHS = [
    "MATCH p = (a:P)-[:K]->(b) RETURN length(p) AS l, nodes(p) AS ns, relationships(p) AS rs",
    "MATCH p = (a:P)<-[:K]-(b)<-[:K]-(c) RETURN [x IN nodes(p) | x.n] AS ns, "
    "[r IN relationships(p) | r.w] AS ws, p",
    "MATCH p = (a:P)-[:K*1..2]->(b) RETURN length(p) AS l, [x IN nodes(p) | x.n] AS ns, "
    "[r IN relationships(p) | r.w] AS ws, p",
    "MATCH p = (a)-[:K*0..2]-(b:P) RETURN length(p) AS l, [x IN nodes(p) | x.n] AS ns, "
    "[r IN relationships(p) | r.w] AS ws, p",
    "MATCH p = (a:Q)-[*1..3]->(b) RETURN length(p) AS l, nodes(p)[-1].n AS last, "
    "size(relationships(p)) AS rs",
    "MATCH (a:P) OPTIONAL MATCH p = (a)-[:L]->(b) RETURN a.n AS a, length(p) AS l, "
    "nodes(p) AS ns, p",
    "MATCH p = (a:P {n: 1})-[:K*]->(b) WITH p, length(p) AS l WHERE l > 1 "
    "RETURN l, [x IN nodes(p) | x.n] AS ns",
    "MATCH p = (a:P)-[:K]->(b) RETURN count(p) AS c, count(DISTINCT length(p)) AS d",
    "MATCH p = (a)-[:K*0..1]->(b) RETURN length(p) AS l, count(*) AS c",
]

LISTS = [
    # nested and mixed list values, literal and per row
    "RETURN [1, [2, 'a'], null, {k: [1.5, true]}] AS x, [[1, 2], [3]] AS y",
    "MATCH (a:P) RETURN [a.n, [a.s, a.f], a] AS x, [[a.n], []] AS y",
    "UNWIND [[1, 2], [3], []] AS x RETURN x, size(x) AS n",
    "UNWIND [[1, [2]], ['a', null]] AS x UNWIND x AS y RETURN y",
    "MATCH (a:P) UNWIND [a.n, a.s, null, [a.n]] AS x RETURN x",
    "MATCH (a:P)-[:K]->(b) WITH a, collect([b.n, b.s]) AS ps UNWIND ps AS pr "
    "RETURN a.n AS a, pr[0] AS n, pr[1] AS s",
    "MATCH (a:P) RETURN collect([a.n, [a.s]]) AS l",
    "MATCH (a:P) RETURN [x IN [a.n, a.s] | [x, x]] AS l, [a.n] + [[a.s]] AS m, "
    "[a.s] + [a.n] AS o",
    "MATCH (a:P) RETURN CASE WHEN a.n > 1 THEN a.s ELSE a.n END AS c, "
    "coalesce(a.s, a.f, [a.n]) AS d",
    # equality, IN and joins on lists and maps
    "MATCH (a:P) RETURN [a.n, 1] = [1, 1] AS e, [a.n, null] = [1, null] AS f, "
    "[a.n] = [a.f] AS g, {k: a.n} = {k: 1} AS h, {k: a.s} <> {k: 'x'} AS i, "
    "[a.n] = a.n AS j",
    "MATCH (a:P) RETURN [a.n, 2] IN [[1, 2], [2, 2]] AS i, [[a.n]] IN [[[1]], null] AS j",
    "MATCH (a:P), (b:P) WHERE [a.n % 2, a.s] = [b.n % 2, b.s] RETURN a.n AS a, b.n AS b",
    "MATCH (a:P), (b:P) WHERE {k: a.n % 2} = {k: b.n % 2} RETURN a.n AS a, b.n AS b",
    # lists, maps and elements as keys
    "MATCH (a:P)-[:K]->(b) RETURN [a.n % 2, b.n % 2] AS k, count(*) AS c",
    "MATCH (a:P)-[:K]->(b) RETURN {m: a.n % 2} AS k, count(*) AS c, collect(b.n) AS bs",
    "MATCH (a:P) RETURN DISTINCT {s: a.s} AS m",
    "MATCH (a:P)-[:K]->(b) RETURN min([b.n, b.s]) AS lo, max({k: b.n}) AS hi, "
    "count(DISTINCT [b.s]) AS d",
    # reduce
    "MATCH (a:P) RETURN reduce(t = 0, x IN [a.n, 2, 3] | t + x * 2) AS r",
    "MATCH (a:P) RETURN reduce(t = a.n, x IN [a.n, null] | t + x) AS r",
    "MATCH (a:P) RETURN reduce(s = '', x IN [a.s, 'b'] | s + coalesce(x, '-')) AS r",
    "MATCH (a:P) RETURN reduce(m = 0, x IN range(0, a.n) | CASE WHEN x % 3 > m "
    "THEN x % 3 ELSE m END) AS r",
    "MATCH (a:P) RETURN reduce(f = 0.1, x IN [a.f, 0.2, 0.3] | f + coalesce(x, 0.0)) AS r",
    "MATCH (a:P) RETURN reduce(l = [], x IN [a.n, a.s] | l + [x]) AS r",
    "MATCH (a:P) WITH a, CASE WHEN a.n > 2 THEN null ELSE [a.n] END AS l "
    "RETURN reduce(t = 0, x IN l | t + x) AS r",
    # the rest
    "MATCH (a:P) RETURN properties({k: a.n, v: null}) AS p, a{.*} AS m, a{.*, s: 0} AS m2",
    "MATCH (a:P) RETURN left(a.s, a.n) AS l, a.s STARTS WITH a.s AS b, "
    "'xy' CONTAINS a.s AS c",
]

ORDERS = [
    "MATCH (a:P) RETURN [a.n % 2, a.s] AS k ORDER BY k",
    "MATCH (a:P) RETURN [a.s, a.n] AS k ORDER BY k DESC",
    "MATCH (a:P) RETURN {m: a.n % 2, s: a.s} AS k ORDER BY k, a.n",
    "MATCH (a:P) RETURN a ORDER BY a DESC",
    "UNWIND [1, 'a', 2.5, null, [1], true, {k: 1}, [0, 'z']] AS x RETURN x ORDER BY x",
    "MATCH (a:P) RETURN a.n AS n UNION ALL MATCH (a:P) RETURN a.s AS n",
    "MATCH (a:P) RETURN a.n AS n UNION MATCH (a:Q) RETURN a.s AS n",
]


def _rows_in_order(result):
    return [tuple(sorted((c, _value(v, ORDERED)) for c, v in dict(r).items()))
            for r in result.records.collect()]


@pytest.mark.parametrize("query", PATHS)
def test_path_values(engines, query):
    result, got = _three(engines, query, ORDERED)
    assert sum(got.values()) > 0
    if "*" in query:
        assert "CsrVarExpandOp" in result.plans


@pytest.mark.parametrize("query", LISTS)
def test_nested_mixed_and_reduce(engines, query):
    _, got = _three(engines, query, ORDERED)
    assert sum(got.values()) > 0


@pytest.mark.parametrize("query", ORDERS)
def test_lists_maps_and_mixed_in_order(engines, query):
    result, _ = _three(engines, query, ORDERED)
    if "ORDER BY" in query:
        assert _rows_in_order(result) == _rows_in_order(engines[2].cypher(query))


@pytest.mark.parametrize("query", [
    "RETURN 'a' + [1] AS x",
    "MATCH (a:P) RETURN a.s + {k: 1} AS x",
    "MATCH (a:P) RETURN [a.n] + 'b' AS x",
])
def test_string_plus_list_raises_the_oracles_error(engines, query):
    port, _, local = engines
    with pytest.raises(Exception) as want:
        local.cypher(query).records.collect()
    with pytest.raises(Exception) as got:
        port.cypher(query).records.collect()
    assert got.type.__name__ == want.type.__name__ == "CypherTypeError"


def test_undirected_path_orients_its_relationships(engines):
    """An undirected walk's relationship walked from its end comes out
    with start and end swapped, as in the classic cascade, and each node
    after the first is the end its relationship leads to."""
    port = engines[0]
    rows = port.cypher("MATCH p = (a:P {n: 1})-[:K*2..2]-(b) RETURN nodes(p) AS ns, "
                       "relationships(p) AS rs").records.collect()
    assert rows
    for r in rows:
        ns, rs = r["ns"], r["rs"]
        assert len(ns) == len(rs) + 1
        for x, rel, y in zip(ns, rs, ns[1:]):
            assert (rel.start, rel.end) == (x.id, y.id)


def test_reduce_over_a_long_list_folds_in_order(engines):
    """The general fold steps over every position of the longest list."""
    q = ("UNWIND range(1, 40) AS i WITH collect(i) AS l "
         "RETURN reduce(s = '', x IN l | CASE WHEN x % 7 = 0 THEN s + 'x' ELSE s END) AS r, "
         "reduce(t = 1, x IN l | (t * 31 + x) % 1000003) AS h")
    _, got = _three(engines, q, ORDERED)
    assert sum(got.values()) == 1
    assert _bag(engines[0].cypher(q), ORDERED) == got
