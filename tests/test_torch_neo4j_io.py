"""The Neo4j IO of the port against the JAX package's.

The counterpart of ``tests/test_neo4j_io.py``: the query and statement
builders (each string equal to the reference's on the same inputs), the
driver gate, and the bulk CSV sink, whose export of one graph has the same
``import.sh``, ``schema.csv`` files and (sorted) part rows as the
reference's. A stub ``neo4j`` module, put in ``sys.modules``, answers the
reference's read queries from fixed records and takes its write
statements: both packages' ``graph()`` give bag-identical graphs, and both
``store()``s send the same statements and batches.
"""

import csv
import os
import sys
import types
from collections import Counter

import pytest

import tpu_cypher as R
from tpu_cypher.io import neo4j as RN

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.api import types as T
from tpu_cypher_torch.io import neo4j as N
from tpu_cypher_torch.io.datasource import DataSourceError
from tpu_cypher_torch.io.neo4j import (
    Neo4jBulkCSVDataSink,
    Neo4jConfig,
    Neo4jPropertyGraphDataSource,
    create_index_statement,
    exact_label_match_query,
    merge_node_statement,
    merge_relationship_statement,
    rel_type_query,
)

SOCIAL = (
    "CREATE (a:Person {name:'Alice', age:23})-[:KNOWS {since:2019}]->"
    "(b:Person {name:'Bob', age:42}), (a)-[:READS]->(:Book {title:'G'})"
)
MIXED = (
    "CREATE (a:P:Admin {name:'Alice', age:23, score:1.5, tags:['x','y']})"
    "-[:R {w:0.5, n:3}]->(b:P {name:'Bob'}), (b)-[:R {n:4}]->(c {x:1}), "
    "(c)-[:S]->(a)"
)


@pytest.fixture(scope="module")
def sessions():
    return CypherSession.local(), R.CypherSession.local()


@pytest.fixture(scope="module")
def g(sessions):
    return sessions[0].create_graph_from_create_query(SOCIAL)


class TestQueryBuilders:
    def test_exact_label_query(self):
        q = exact_label_match_query(["Person", "Admin"], ["name", "age"])
        assert "MATCH (n:`Admin`:`Person`)" in q
        assert "size(labels(n)) = 2" in q
        assert q.index("n.`age`") < q.index("n.`name`")

    def test_rel_type_query(self):
        q = rel_type_query("KNOWS", ["since"])
        assert "-[r:`KNOWS`]->" in q
        assert "id(s) AS" in q and "id(t) AS" in q and "r.`since`" in q

    def test_create_index(self):
        modern = create_index_statement("Person", ["name"])
        assert "IF NOT EXISTS" in modern
        assert "FOR (n:`Person`) ON (n.`name`)" in modern
        assert (
            N.create_index_statement_legacy("Person", ["name"])
            == "CREATE INDEX ON :`Person`(`name`)"
        )

    def test_merge_node(self):
        s = merge_node_statement(["Person"], ["id"], ["name", "age"])
        assert s.startswith("UNWIND $batch AS row MERGE (n:`Person` {`id`: row.`id`})")
        assert "SET n.`age` = row.`age`, n.`name` = row.`name`" in s

    def test_merge_relationship(self):
        s = merge_relationship_statement(
            "KNOWS", ["Person"], ["Person"], ["id"], ["id"], [], ["since"]
        )
        assert "MATCH (s:`Person` {`id`: row.`source_id`})" in s
        assert "MERGE (s)-[r:`KNOWS`]->(t)" in s
        assert "SET r.`since` = row.`since`" in s

    @pytest.mark.parametrize("name, args", [
        ("exact_label_match_query", (["Person", "Admin"], ["name", "age"])),
        ("exact_label_match_query", ([], [])),
        ("rel_type_query", ("KNOWS", ["since", "a b"])),
        ("node_schema_query", ()),
        ("rel_schema_query", ()),
        ("create_index_statement", ("Per-son", ["name", "x.y"])),
        ("create_index_statement_legacy", ("Person", ["name", "age"])),
        ("merge_node_statement", (["B", "A"], ["id", "k"], ["z", "a"])),
        ("merge_node_statement", (["A"], ["id"], [])),
        ("merge_relationship_statement",
         ("R", ["A"], [], ["id"], ["id", "k"], ["id"], ["w", "n"])),
        ("merge_relationship_statement", ("R", [], [], ["id"], ["id"], [], [])),
    ])
    def test_builder_equals_reference(self, name, args):
        assert getattr(N, name)(*args) == getattr(RN, name)(*args)

    def test_bulk_types_equal_reference(self):
        pairs = [(T.CTString, RN.T.CTString), (T.CTInteger.nullable, RN.T.CTInteger.nullable),
                 (T.CTFloat, RN.T.CTFloat), (T.CTBoolean, RN.T.CTBoolean),
                 (T.CTList(T.CTInteger), RN.T.CTList(RN.T.CTInteger)),
                 (T.CTDate, RN.T.CTDate), (None, None)]
        for p, r in pairs:
            assert N._bulk_type(p) == RN._bulk_type(r)
        names = (["String"], ["Long", "Double"], ["StringArray"], ["Point"], [])
        for ts in names:
            for mandatory in (True, False):
                assert (str(N._cypher_type_for(ts, mandatory))
                        == str(RN._cypher_type_for(ts, mandatory)))


class TestDriverGate:
    def test_live_source_needs_driver(self, sessions, monkeypatch):
        monkeypatch.setitem(sys.modules, "neo4j", None)
        src = Neo4jPropertyGraphDataSource(Neo4jConfig())
        with pytest.raises(DataSourceError, match="neo4j"):
            src.graph("graph", sessions[0])

    def test_gate_does_not_block_metadata(self):
        src = Neo4jPropertyGraphDataSource(Neo4jConfig(), graph_name="g1")
        assert src.has_graph("g1") and not src.has_graph("other")
        assert src.graph_names() == ["g1"]


def _export(sink_cls, graph, root, name):
    sink_cls(str(root)).store(name, graph)
    out = {}
    for d, _, files in os.walk(root / name):
        for f in files:
            p = os.path.join(d, f)
            with open(p, newline="") as fh:
                text = fh.read().replace(str(root), "<root>")
            rel = os.path.relpath(p, root)
            out[rel] = sorted(text.splitlines()) if f == "part_0.csv" else text
    return out


class TestBulkCSVSink:
    def test_export_layout_and_content(self, g, tmp_path):
        Neo4jBulkCSVDataSink(str(tmp_path)).store("social", g._graph)
        base = tmp_path / "social"
        script = (base / "import.sh").read_text()
        assert "neo4j-admin import" in script
        assert "--database=social" in script
        assert "--nodes:Person" in script and "--relationships:KNOWS" in script
        assert os.access(base / "import.sh", os.X_OK)
        person_dir = base / "nodes" / "Person"
        head = (person_dir / "schema.csv").read_text().strip().split(",")
        assert head[0] == "id:ID"
        assert "age:int" in head and "name:string" in head
        with open(person_dir / "part_0.csv") as f:
            rows = list(csv.reader(f))
        assert len(rows) == 2
        assert {r[head.index("name:string")] for r in rows} == {"Alice", "Bob"}
        knows_dir = base / "relationships" / "KNOWS"
        khead = (knows_dir / "schema.csv").read_text().strip().split(",")
        assert ":START_ID" in khead and ":END_ID" in khead and "since:int" in khead
        with open(knows_dir / "part_0.csv") as f:
            krows = list(csv.reader(f))
        assert len(krows) == 1
        assert krows[0][khead.index("since:int")] == "2019"

    def test_optional_int_property_stays_int(self, sessions, tmp_path):
        g = sessions[0].create_graph_from_create_query(
            "CREATE (:P {name:'Alice', age:23}), (:P {name:'Bob'})"
        )
        Neo4jBulkCSVDataSink(str(tmp_path)).store("opt", g._graph)
        d = tmp_path / "opt" / "nodes" / "P"
        head = (d / "schema.csv").read_text().strip().split(",")
        with open(d / "part_0.csv") as f:
            rows = list(csv.reader(f))
        assert sorted(r[head.index("age:int")] for r in rows) == ["", "23"]

    def test_unlabeled_nodes_plain_nodes_arg(self, sessions, tmp_path):
        g = sessions[0].create_graph_from_create_query("CREATE ({x:1})")
        Neo4jBulkCSVDataSink(str(tmp_path)).store("nolabel", g._graph)
        script = (tmp_path / "nolabel" / "import.sh").read_text()
        assert "--nodes:" not in script
        assert "--nodes " in script

    @pytest.mark.parametrize("create", [SOCIAL, MIXED], ids=["social", "mixed"])
    def test_export_equals_reference(self, sessions, tmp_path, create):
        """One graph exported by both packages (the port's from ``local()``
        and from the device backend): the same files, scripts and schema
        headers, and the same part rows once sorted."""
        port, ref = sessions
        want = _export(RN.Neo4jBulkCSVDataSink,
                       ref.create_graph_from_create_query(create)._graph,
                       tmp_path / "ref", "g")
        got = _export(Neo4jBulkCSVDataSink,
                      port.create_graph_from_create_query(create)._graph,
                      tmp_path / "port", "g")
        assert got == want and "g/import.sh" in got
        dev = CypherSession.cuda(device="cpu")
        assert _export(Neo4jBulkCSVDataSink,
                       dev.create_graph_from_create_query(create)._graph,
                       tmp_path / "dev", "g") == want


# -- the live source over a stub driver ----------------------------------

NODE_SCHEMA = [
    {"nodeLabels": ["Person"], "propertyName": "name", "propertyTypes": ["String"],
     "mandatory": True},
    {"nodeLabels": ["Person"], "propertyName": "age", "propertyTypes": ["Long"],
     "mandatory": False},
    {"nodeLabels": ["Person", "Admin"], "propertyName": "name",
     "propertyTypes": ["String"], "mandatory": True},
    {"nodeLabels": ["Book"], "propertyName": "tags", "propertyTypes": ["StringArray"],
     "mandatory": True},
    {"nodeLabels": ["Thing"], "propertyName": None, "propertyTypes": [],
     "mandatory": False},
]
REL_SCHEMA = [
    {"relType": ":`KNOWS`", "propertyName": "since", "propertyTypes": ["Long"],
     "mandatory": True},
    {"relType": ":`READS`", "propertyName": "rating", "propertyTypes": ["Double"],
     "mandatory": False},
]
NODES = {
    ("Person",): [{"___id": 1, "n.`age`": 23, "n.`name`": "Alice"},
                  {"___id": 2, "n.`age`": None, "n.`name`": "Bob"}],
    ("Admin", "Person"): [{"___id": 3, "n.`name`": "Carl"}],
    ("Book",): [{"___id": 4, "n.`tags`": ["x", "y"]}, {"___id": 5, "n.`tags`": []}],
    ("Thing",): [{"___id": 6}],
}
RELS = {
    "KNOWS": [{"___id": 10, "___source": 1, "___target": 2, "r.`since`": 2019},
              {"___id": 11, "___source": 3, "___target": 1, "r.`since`": 2020}],
    "READS": [{"___id": 12, "___source": 1, "___target": 4, "r.`rating`": 4.5},
              {"___id": 13, "___source": 2, "___target": 5, "r.`rating`": None}],
}


def _stub_neo4j(log):
    """A ``neo4j`` module whose sessions answer ``RN``'s read queries from
    the records above and log every statement they are given."""
    answers = {RN.node_schema_query(): NODE_SCHEMA, RN.rel_schema_query(): REL_SCHEMA}
    for combo, rows in NODES.items():
        keys = sorted({k[3:-1] for r in rows for k in r if k.startswith("n.")})
        answers[RN.exact_label_match_query(list(combo), keys)] = rows
    for rt, rows in RELS.items():
        keys = sorted({k[3:-1] for r in rows for k in r if k.startswith("r.")})
        answers[RN.rel_type_query(rt, keys)] = rows

    class Session:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def run(self, query, **params):
            log.append((query, params))
            return [dict(r) for r in answers.get(query, [])]

    class Driver:
        def session(self, database=None):
            return Session()

        def close(self):
            pass

    mod = types.ModuleType("neo4j")
    mod.GraphDatabase = types.SimpleNamespace(driver=lambda uri, auth=None: Driver())
    mod.answers = answers
    return mod


def _bag(rows):
    return Counter(tuple(sorted((k, str(v)) for k, v in dict(r).items())) for r in rows)


LIVE_QUERIES = (
    "MATCH (n) RETURN id(n) AS i, labels(n) AS l, n.name AS name, n.age AS age, "
    "n.tags AS tags",
    "MATCH (a)-[r]->(b) RETURN id(r) AS i, type(r) AS t, id(a) AS a, id(b) AS b, "
    "r.since AS s, r.rating AS x",
)


def test_live_graph_equals_reference(monkeypatch, sessions):
    """Both packages read the stub's database into bag-identical graphs with
    the same schema; the port's on the device backend too. The reference's
    ``graph()`` ends in ``ScanGraph(tables, schema, table_cls)``, which
    raises ``TypeError`` (``ScanGraph`` takes no table class); the port
    builds ``ScanGraph(tables, schema)``, so the reference is read here
    with that one call mended for the duration of the test."""
    log = []
    stub = _stub_neo4j(log)
    monkeypatch.setitem(sys.modules, "neo4j", stub)
    port, ref = sessions
    dev = CypherSession.cuda(device="cpu")
    pg = Neo4jPropertyGraphDataSource(Neo4jConfig()).graph("graph", port)
    dg = Neo4jPropertyGraphDataSource(Neo4jConfig()).graph("graph", dev)
    with pytest.raises(TypeError):
        RN.Neo4jPropertyGraphDataSource(RN.Neo4jConfig()).graph("graph", ref)
    from tpu_cypher.relational import graphs as RG

    scan_graph = RG.ScanGraph
    monkeypatch.setattr(RG, "ScanGraph",
                        lambda tables, schema, *table_cls: scan_graph(tables, schema))
    rg = RN.Neo4jPropertyGraphDataSource(RN.Neo4jConfig()).graph("graph", ref)
    assert pg.schema.to_json() == rg.schema.to_json()
    from tpu_cypher.relational.session import PropertyGraph as RPG

    from tpu_cypher_torch.relational.session import PropertyGraph

    for q in LIVE_QUERIES:
        want = RPG(ref, rg).cypher(q).records.collect()
        assert _bag(PropertyGraph(port, pg).cypher(q).records.collect()) == _bag(want)
        assert _bag(PropertyGraph(dev, dg).cypher(q).records.collect()) == _bag(want)
    assert sum(len(v) for v in NODES.values()) == len(
        PropertyGraph(port, pg).cypher(LIVE_QUERIES[0]).records.collect())
    # every query the port sent is one the reference's builders make
    assert {q for q, _ in log} == set(stub.answers)


def test_live_store_sends_the_reference_statements(monkeypatch, sessions):
    """``store`` over the stub: the index statements, MERGE statements and
    batches equal the reference's for one graph."""
    port, ref = sessions
    logs = []
    for pkg, sess in ((N, port), (RN, ref)):
        log = []
        monkeypatch.setitem(sys.modules, "neo4j", _stub_neo4j(log))
        graph = sess.create_graph_from_create_query(MIXED)
        pkg.Neo4jPropertyGraphDataSource(pkg.Neo4jConfig()).store("graph", graph._graph)
        logs.append(log)
    norm = [[(q, {k: sorted(map(str, v)) for k, v in p.items()}) for q, p in log]
            for log in logs]
    assert sorted(norm[0], key=str) == sorted(norm[1], key=str)
    assert any("MERGE" in q for q, _ in logs[0])
