"""Lists, maps and elements as values: the port against the JAX package, on
the CPU.

* The list queries of ``tests/test_tpu_backend.py`` (its lines 39, 45, 51,
  84, 85, 88, 90 and 91), ``tests/test_rel_uniqueness.py``'s
  ``min(size(rs))`` case, a ``RETURN rs`` and a ``RETURN p`` over a
  ``*1..2``, and this slice's list expressions (comprehensions,
  quantifiers, ``split``, ``range``, ``keys``, ``properties``, map
  literals, string ``+``, indexing, slicing, ``IN``, ``collect`` and
  ``UNWIND``) across the reference's ``CypherSession.tpu()``, its
  ``local()`` oracle and the port: bag-identical. Each case says how its
  lists compare: ``ORDERED`` element by element, where the order is
  defined (literals, ``split``, ``range``, sorted ``keys`` and
  ``labels``, a walk's relationships in path order, a list after
  ``ORDER BY``); ``MULTISET`` as sorted multisets, where it follows the
  engine's row order (``collect``).
* ``LST`` and ``STRUCT`` columns' ``take``, ``take_or_null``, ``concat``,
  ``slice`` and ``null_like`` against Python's list operations.
* No query of this file reaches the local evaluator.
* ``chip_smoke.py``'s Q31-Q35 at ``generate_snb(0.02)``, against its numpy
  truth and, but for the windowed Q33, the two reference engines.
"""

import struct
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke as CS
import tpu_cypher as R
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda.column import Column
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.local import eval as LOCAL_EVAL
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb
from tpu_cypher_torch.relational.session import PropertyGraph

torch.set_num_threads(1)

ORDERED, MULTISET = True, False

CREATE = (
    "CREATE (a:Person {name:'Alice', age:23, score: 1.5})-[:KNOWS {since:2019}]->"
    "(b:Person {name:'Bob', age:42}),"
    "(b)-[:KNOWS {since:2020}]->(c:Person {name:'Carol', age:55, score: 2.5}),"
    "(a)-[:KNOWS {since:2021}]->(c),"
    "(a)-[:READS]->(k:Book {title:'Graphs'}),"
    "(c)-[:READS]->(k),"
    "(c)-[:KNOWS]->(a)"
)
TWO_CYCLE = "CREATE (a:N)-[:K]->(b:N), (b)-[:K]->(a)"


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


def _value(v, ordered):
    """A value in a form the two packages' values share: elements by kind,
    id and printed form, floats by their bits, lists in order or as sorted
    multisets, maps by their type's name and sorted items."""
    name = type(v).__name__
    if name in ("Node", "Relationship"):
        return (name, v.id, repr(v))
    if name == "Path":
        return (name, repr(v))
    if isinstance(v, (list, tuple)):
        items = [_value(x, ordered) for x in v]
        return ("list", tuple(items if ordered else sorted(items, key=repr)))
    if isinstance(v, dict):
        return (name, tuple(sorted((k, _value(x, ordered)) for k, x in v.items())))
    if isinstance(v, float):
        return ("float", struct.pack("<d", v))
    return (name, v)


def _bag(result, ordered):
    return Counter(tuple(sorted((c, _value(v, ordered)) for c, v in dict(r).items()))
                   for r in result.records.collect())


def _three(engines, query, ordered, params=None):
    """Bag-identical rows across the port, the reference and the oracle,
    on the device rung; returns the port's result and rows."""
    port, ref, local = engines
    result = port.cypher(query, params)
    got = _bag(result, ordered)
    assert got == _bag(ref.cypher(query, params), ordered), query
    assert got == _bag(local.cypher(query, params), ordered), query
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    return result, got


def _creates(create):
    return (
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
    )


@pytest.fixture(scope="module")
def engines():
    return _creates(CREATE)


# tests/test_tpu_backend.py's list queries, by line
BACKEND_LIST_QUERIES = [
    ("MATCH (a:Person)-[r:KNOWS*1..2]->(b) RETURN a.name, b.name, size(r) AS hops", ORDERED),
    ("UNWIND [3,1,2] AS x RETURN x ORDER BY x", ORDERED),
    ("MATCH (p) RETURN labels(p) AS l, count(*) AS c", ORDERED),
    ("MATCH (a:Person) RETURN collect(a.age) AS ages", MULTISET),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name, collect(b.name) AS friends "
     "ORDER BY a.name", MULTISET),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name, collect(DISTINCT b.name) AS ns "
     "ORDER BY a.name", MULTISET),
    ("MATCH (x:Nope) RETURN stDev(x.v) AS sd, percentileCont(x.v, 0.5) AS p, "
     "collect(x.v) AS c", MULTISET),
    ("MATCH (a:Person) RETURN a.score AS s, collect(a.name) AS names ORDER BY s", MULTISET),
]

# this slice's list, map and element expressions
LIST_QUERIES = [
    # var-length relationship lists from the walk, and a path over them
    ("MATCH (a:Person)-[rs:KNOWS*1..2]->(b) RETURN a.name AS a, rs", ORDERED),
    ("MATCH p = (a:Person)-[:KNOWS*1..2]->(b) RETURN p", ORDERED),
    ("MATCH (a:Person)-[rs:KNOWS*0..2]-(b) WHERE none(x IN rs WHERE x.since = 2020) "
     "RETURN a.name AS a, [r IN rs | r.since] AS s, size(rs) AS n", ORDERED),
    # comprehensions and quantifiers
    ("MATCH (a:Person) RETURN [x IN range(1, a.age % 7) WHERE x % 2 = 1 | x * 10] AS l, "
     "any(x IN [a.age, 5] WHERE x > 40) AS q, all(x IN [a.age, null] WHERE x > 1) AS al, "
     "none(x IN [] WHERE x) AS nn, single(x IN [1, a.age] WHERE x = 23) AS sg", ORDERED),
    # split, range, keys, properties, a map literal and projection, STR + STR
    ("MATCH (a:Person) RETURN split(a.name + ' x', ' ') AS s, range(a.age, 60, 10) AS r, "
     "{id: a.name, b: a.age % 7} AS m, keys(a) AS k, properties(a) AS p, "
     "a{.name, .score, n: 1} AS mp", ORDERED),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name + ' knows ' + b.name AS s, "
     "b.name + a.age AS t, 'x' + a.score AS u", ORDERED),
    ("MATCH (a:Person)-[r:KNOWS]->(b) RETURN keys(r) AS k, properties(r) AS p, "
     "r['since'] AS s, a['name'] AS n", ORDERED),
    # indexing, slicing, IN and list + over per-row lists
    ("MATCH (a:Person) WITH a, [a.age, a.age + 1, null] AS l RETURN l[0] AS f, l[-1] AS g, "
     "l[5] AS h, l[1..] AS t, l[..-1] AS u, head(l) AS hd, last(l) AS ls, tail(l) AS tl, "
     "reverse(l) AS rv, size(l) AS sz, 42 IN l AS i, 7 IN l AS j, l + [1] AS p, "
     "a.name + l[0] AS q", ORDERED),
    # collect then UNWIND, a WHERE on the collected size, elements collected
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b.age) AS bs UNWIND bs AS x "
     "RETURN a.name AS a, x", ORDERED),
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b.age) AS bs WHERE size(bs) > 1 "
     "RETURN a.name AS a, bs", MULTISET),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name AS a, collect(b) AS fs, "
     "collect(DISTINCT b) AS ds", MULTISET),
    ("MATCH (a:Person) WITH collect(a) AS ps UNWIND ps AS p RETURN p.name AS n, "
     "labels(p) AS l", ORDERED),
    ("UNWIND [1, null, 3] AS x UNWIND range(1, x) AS y RETURN x, y", ORDERED),
    ("MATCH (a:Person) RETURN [a.age, 1] AS l ORDER BY l DESC", ORDERED),
    ("MATCH (a:Person)-[:KNOWS]->(b) RETURN DISTINCT [a.name, b.name][0] AS n, "
     "size(collect(b)) AS c", ORDERED),
    # count over lists and maps with nulls among them: a null list or map
    # is not counted, and DISTINCT compares lists element by element
    ("MATCH (a:Person) RETURN count(CASE WHEN a.age > 30 THEN [a.age] END) AS c, "
     "count(DISTINCT CASE WHEN a.age > 30 THEN [a.age % 2] END) AS d, "
     "count(DISTINCT [a.age % 2, null]) AS e, count([a.age]) AS f", ORDERED),
    ("MATCH (a:Person) OPTIONAL MATCH (a)-[:READS]->(k) RETURN count(properties(k)) AS c, "
     "count(k{.title}) AS m, count(DISTINCT k) AS d, count(CASE WHEN k IS NULL THEN null "
     "ELSE [k.title] END) AS l", ORDERED),
    # element lists: IN compares by id, a comprehension and a quantifier
    # read the outer row's columns beside each element
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b) AS fs MATCH (c:Person) "
     "RETURN a.name AS a, c.name AS c, c IN fs AS i, c IN fs + [null] AS j", MULTISET),
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b) AS fs RETURN a.name AS a, "
     "[f IN fs WHERE f.age > a.age | f.name] AS older, any(f IN fs WHERE f = a) AS me",
     MULTISET),
    # a list grouped beside its own UNWIND: rows share each list's range
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b.age) AS fs UNWIND fs AS x "
     "RETURN fs, count(x) AS c", MULTISET),
]


@pytest.mark.parametrize("query,ordered", BACKEND_LIST_QUERIES)
def test_backend_list_queries_across_engines(engines, query, ordered):
    _three(engines, query, ordered)


@pytest.mark.parametrize("query,ordered", LIST_QUERIES)
def test_list_queries_across_engines(engines, query, ordered):
    _three(engines, query, ordered)


def test_rel_list_case_of_rel_uniqueness():
    """``tests/test_rel_uniqueness.py``'s last ``VARLEN_CASES`` entry: the
    walk emits the relationship list, the fixed rel enforced inside it."""
    q = ("MATCH (x)-[r:K]->(y), (c)-[rs:K*1..2]->(d) "
         "RETURN count(*) AS c, min(size(rs)) AS m")
    result, got = _three(_creates(TWO_CYCLE), q, ORDERED)
    assert got == Counter({(("c", ("int", 2)), ("m", ("int", 1))): 1})
    assert "CsrVarExpandOp" in result.plans


def test_rel_list_emitted_by_the_walk(engines):
    """``RETURN rs`` over a ``*1..2`` plans ``CsrVarExpandOp``; every lane
    of the list's build runs on the ``expand_rows`` gate."""
    result, got = _three(engines, "MATCH (a:Person)-[rs:KNOWS*1..2]->(b) RETURN rs", ORDERED)
    assert "CsrVarExpandOp" in result.plans and sum(got.values()) == 9
    assert PD.use_counts()["expand_rows"]["plain"] > 0


def _lists():
    return [[1, 2, 3], None, [], [4], [5, 6], [None, 7]]


@pytest.mark.parametrize("values", [
    _lists(),
    [["a", "b"], [], None, ["c"]],
    [[1.5, 2], None, [0.0, -0.0]],
    [{"a": 1, "b": "x"}, None, {"a": 2, "b": "y"}],
], ids=["ints", "strings", "numbers", "maps"])
def test_nested_column_round_trips(values):
    """Order is defined throughout: every result is compared element by
    element with Python's list operations."""
    c = Column.from_values(values)
    assert c.kind in ("lst", "struct") and c.to_values() == values
    n = len(values)
    idx = torch.tensor([n - 1, 0, 1, 0, n - 2])
    assert c.take(idx).to_values() == [values[i] for i in idx.tolist()]
    ok = torch.tensor([True, False, True, True, False])
    assert c.take_or_null(idx, ok).to_values() == [
        values[i] if k else None for i, k in zip(idx.tolist(), ok.tolist())]
    for lo, hi in ((0, n), (1, 3), (2, 2), (n - 1, n)):
        assert c.slice(lo, hi).to_values() == values[lo:hi]
        assert c.to_values_range(lo, hi) == values[lo:hi]
    assert c.concat(c.slice(1, n)).to_values() == values + values[1:]
    assert c.concat(Column.from_values([None, None])).to_values() == values + [None, None]
    assert c.null_like(2).to_values() == [None, None]
    empty = Column.from_values([[]])
    if c.kind == "lst":
        assert empty.concat(c).to_values() == [[]] + values
        assert c.take(torch.zeros(0, dtype=torch.int64)).to_values() == []


def test_list_rank_orders_lists_as_cypher():
    """``lists.list_rank`` over rows that share child ranges, lists up to
    40 long (six doubling rounds), null elements and null lists: equal
    ranks for equal lists, and ranks in Cypher's list order (element by
    element, a shorter prefix first, a null element after every value)."""
    from tpu_cypher_torch.backend.cuda import lists as LS

    rng = np.random.default_rng(7)
    values = [None if rng.random() < 0.1 else
              [None if rng.random() < 0.1 else int(rng.integers(-2, 3))
               for _ in range(int(rng.choice([0, 1, 3, 40])) if rng.random() < 0.2
                              else int(rng.integers(0, 4)))]
              for _ in range(200)]
    idx = torch.from_numpy(rng.integers(0, len(values), 400))
    rank = LS.list_rank(Column.from_values(values).take(idx))
    rows = [values[i] for i in idx.tolist()]
    assert rank.valid_mask().tolist() == [v is not None for v in rows]
    live = [(tuple((1, x) if x is not None else (2, 0) for x in v), r)
            for v, r in zip(rows, rank.data.tolist()) if v is not None]
    keys, ranks = sorted({k for k, _ in live}), sorted({r for _, r in live})
    assert [ranks.index(r) for _, r in live] == [keys.index(k) for k, _ in live]


def test_from_rows_builds_device_columns():
    from tpu_cypher_torch.backend.cuda.table import CudaTable

    rows = [[1, [2, 3], {"k": "a"}], [4, None, {"k": "b"}], [None, [], None]]
    t = CudaTable.from_rows(["i", "l", "m"], rows)
    assert [t._cols[c].kind for c in ("i", "l", "m")] == ["i64", "lst", "struct"]
    assert [[r[c] for c in ("i", "l", "m")] for r in t.rows()] == rows


def test_count_distinct_of_a_map_raises(engines):
    """A map is a key (it raised, naming item 6.4, before maps had a dense
    rank): ``count(DISTINCT`` of one answers as the two references do."""
    _three(engines, "MATCH (a:Person) RETURN count(DISTINCT {n: a.name}) AS c, "
           "count(DISTINCT {n: a.age % 2}) AS d", ORDERED)


def test_no_list_query_reaches_the_local_evaluator(engines, monkeypatch):
    """The port answers every list query on the device: the local
    evaluator is never built."""
    built = []
    inner = LOCAL_EVAL.Evaluator.__init__

    def spy(self, *args, **kwargs):
        built.append(1)
        inner(self, *args, **kwargs)

    monkeypatch.setattr(LOCAL_EVAL.Evaluator, "__init__", spy)
    port = engines[0]
    for query, _ in BACKEND_LIST_QUERIES + LIST_QUERIES:
        port.cypher(query).records.collect()
    assert not built


# ---------------------------------------------------------------------------
# chip_smoke.py's Q31-Q35 at generate_snb(0.02)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snb():
    port_session = CypherSession.cuda(device="cpu")
    ref_session = R.CypherSession.tpu()
    local_session = R.CypherSession.local()
    port = PropertyGraph(port_session, port_generate_snb(0.02, port_session))
    engines = (
        port,
        RefPropertyGraph(ref_session, ref_generate_snb(0.02, ref_session)),
        RefPropertyGraph(local_session, ref_generate_snb(0.02, local_session)),
    )
    ids, bday, src, dst = CS.graph_arrays(port)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    start, w = len(ids) // 2, 20
    counts, _ = CS.brute_walks(CS.directed_steps(s, d), len(ids),
                               np.arange(start, start + w), 2, pairs=True)
    truth = CS.list_truth(ids, bday, s, d, counts)
    truth["Q33 params"] = CS.window_params(ids, start, w)
    truth["Q54 rows params"] = CS.undirected_window(ids, s, d, 20_000)
    truth["edges"] = set(zip(src.tolist(), dst.tolist()))
    return engines, truth


@pytest.mark.parametrize("qname", sorted(CS.LIST_QUERIES))
def test_chip_smoke_list_queries(snb, qname):
    """Each query against ``chip_smoke.list_truth`` (Q33 rows: each list
    chains from a to b over the graph's KNOWS), the plan operator and the
    kernels ``chip_smoke.py`` expects (CPU tier: ``plain``); but for the
    windowed Q33, against the two reference engines too (collected lists
    as multisets)."""
    engines, truth = snb
    query, plan_op, kernels = CS.LIST_QUERIES[qname]
    params = truth["Q33 params"] if qname.startswith("Q33") else truth.get(f"{qname} params")
    result = engines[0].cypher(query, params)
    rows = [dict(r) for r in result.records.collect()]
    assert plan_op in result.plans
    for name in kernels:
        assert PD.use_counts()[name]["plain"] > 0, (qname, name)
    if qname == "Q33 rows":
        assert len(rows) == min(1000, sum(r["c"] for r in truth["Q33"]))
        CS.check_rel_lists(rows, truth["edges"])
    elif qname == "Q54 rows":  # a LIMIT without ORDER BY: rows of the port's choice
        assert rows
        CS.check_path_rows(rows, truth["edges"])
    elif qname == "Q34 values":
        assert sorted(rows, key=lambda r: r["id"]) == truth[qname]
    elif qname == "Q35":
        assert {r["a"]: sorted(n.id for n in r["fs"]) for r in rows} == truth[qname]
    else:
        assert CS.list_surface_rows(qname, rows) == truth[qname]
    if not qname.startswith("Q33") and qname != "Q54 rows":
        _three(engines, query, MULTISET, params)
