"""Graph DDL and the SQL source of the port against the JAX package's.

The counterpart of ``tests/test_graph_ddl.py``: each of its tests runs on
``tpu_cypher_torch.graph_ddl`` and ``tpu_cypher_torch.io.sql``, and every
DDL text it parses is parsed by both packages, whose statements must print
alike and whose resolved schemas must serialize alike
(``PropertyGraphSchema.to_json``). The SQL source, under both id
strategies, gives rows bag-identical to the reference's on ``local()``, and
the same hashed ids from ``InMemoryTables`` and from ``FileTables``
(parquet and CSV); one query per strategy runs through the port's
``CypherSession.cuda(device="cpu")`` and the reference's ``tpu()``.
"""

from collections import Counter

import pytest

import tpu_cypher as R
from tpu_cypher import graph_ddl as RDDL
from tpu_cypher.io import sql as RSQL

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.api import types as T
from tpu_cypher_torch.graph_ddl import (
    ElementTypeDefinition,
    GraphDdl,
    GraphDdlError,
    GraphDdlParseError,
    GraphDefinition,
    GraphTypeDefinition,
    NodeType,
    NodeTypeDefinition,
    RelationshipType,
    RelationshipTypeDefinition,
    SetSchemaDefinition,
    parse_ddl,
)
from tpu_cypher_torch.io import DataSourceError
from tpu_cypher_torch.io.sql import (
    FileTables,
    IdGenerationStrategy,
    InMemoryTables,
    SqlPropertyGraphDataSource,
    hash64,
)

FOO_DDL = """
SET SCHEMA dataSourceName.fooDatabaseName

CREATE GRAPH TYPE fooSchema (
 Person ( name STRING, age INTEGER ),
 Book   ( title STRING ) ,
 READS  ( rating FLOAT ) ,
 (Person),
 (Book),
 (Person)-[READS]->(Book)
)
CREATE GRAPH fooGraph OF fooSchema (
  (Person) FROM personView1 ( person_name1 AS name )
           FROM personView2 ( person_name2 AS name ),
  (Book)   FROM bookView    ( book_title AS title ),

  (Person)-[READS]->(Book)
    FROM readsView1 e ( value1 AS rating )
      START NODES (Person) FROM personView1 p JOIN ON p.person_id1 = e.person
      END   NODES (Book)   FROM bookView    b JOIN ON e.book       = b.book_id
    FROM readsView2 e ( value2 AS rating )
      START NODES (Person) FROM personView2 p JOIN ON p.person_id2 = e.person
      END   NODES (Book)   FROM bookView    b JOIN ON e.book       = b.book_id
)
"""

EXTENDS_DDL = """
CREATE ELEMENT TYPE Person ( name STRING )
CREATE ELEMENT TYPE Employee EXTENDS Person ( dept STRING )
CREATE GRAPH g (
  (Employee) FROM v
)
"""

PGDS_DDL = """
SET SCHEMA sql.db

CREATE GRAPH TYPE library (
  Person ( name STRING, age INTEGER ),
  Book   ( title STRING ),
  READS  ( rating FLOAT ),
  (Person), (Book),
  (Person)-[READS]->(Book)
)
CREATE GRAPH books OF library (
  (Person) FROM persons,
  (Book)   FROM books,
  (Person)-[READS]->(Book)
    FROM reads e
      START NODES (Person) FROM persons p JOIN ON p.person_id = e.person
      END   NODES (Book)   FROM books   b JOIN ON b.book_id   = e.book
)
"""

TABLES = {
    "db.persons": {
        "person_id": [1, 2, 3],
        "name": ["Alice", "Bob", "Carl"],
        "age": [23, 42, 19],
    },
    "db.books": {
        "book_id": [10, 20],
        "title": ["Morpheus", "Okapi"],
    },
    "db.reads": {
        "person": [1, 1, 2],
        "book": [10, 20, 10],
        "rating": [5.0, 3.5, 4.0],
    },
}

STRATEGIES = ["HASHED_ID", "SERIALIZED_ID"]


def _same_parse(text):
    """Both packages parse ``text`` into statements that print alike."""
    port = parse_ddl(text)
    assert repr(port) == repr(RDDL.parse_ddl(text))
    return port


def _same_schemas(text):
    """Both packages resolve ``text`` into the same graphs, whose schemas
    serialize alike."""
    port, ref = GraphDdl.parse(text), RDDL.GraphDdl.parse(text)
    assert sorted(port.graphs) == sorted(ref.graphs)
    for name, g in port.graphs.items():
        assert g.schema.to_json() == ref.graphs[name].schema.to_json()
    return port


def _bag(rows):
    return Counter(tuple(sorted(dict(r).items())) for r in rows)


def _mount(strategy, tables=TABLES, provider=InMemoryTables, ref_provider=None):
    """The port's and the reference's sessions with the SQL source of
    ``PGDS_DDL`` mounted under ``sql``."""
    port = CypherSession.local()
    port.register_source("sql", SqlPropertyGraphDataSource(
        PGDS_DDL, {"sql": provider(tables)},
        id_strategy=IdGenerationStrategy[strategy]))
    ref = R.CypherSession.local()
    ref.register_source("sql", RSQL.SqlPropertyGraphDataSource(
        PGDS_DDL, {"sql": (ref_provider or RSQL.InMemoryTables)(tables)},
        id_strategy=RSQL.IdGenerationStrategy[strategy]))
    return port, ref


def _both(strategy, query):
    port, ref = _mount(strategy)
    got = port.graph("sql.books").cypher(query).records.collect()
    want = ref.graph("sql.books").cypher(query).records.collect()
    assert _bag(got) == _bag(want)
    return got


class TestParser:
    def test_set_schema(self):
        ddl = _same_parse("SET SCHEMA ds.db;")
        assert ddl.statements == (SetSchemaDefinition("ds", "db"),)

    def test_element_type(self):
        ddl = _same_parse("CREATE ELEMENT TYPE Person ( name STRING, age INTEGER? )")
        (et,) = ddl.statements
        assert et == ElementTypeDefinition(
            "Person",
            properties=(
                ("name", T.CTString),
                ("age", T.CTInteger.nullable),
            ),
        )

    def test_element_type_extends_and_key(self):
        ddl = _same_parse(
            "CREATE ELEMENT TYPE Employee EXTENDS Person, Worker "
            "( dept STRING ) KEY pk (dept)"
        )
        (et,) = ddl.statements
        assert et.parents == ("Person", "Worker")
        assert et.key == ("pk", ("dept",))

    def test_graph_type(self):
        ddl = _same_parse(
            "CREATE GRAPH TYPE gt ( A (x INTEGER), B, (A), (B), (A)-[B]->(A) )"
        )
        (gt,) = ddl.statements
        assert isinstance(gt, GraphTypeDefinition)
        kinds = [type(s).__name__ for s in gt.statements]
        assert kinds == [
            "ElementTypeDefinition",
            "ElementTypeDefinition",
            "NodeTypeDefinition",
            "NodeTypeDefinition",
            "RelationshipTypeDefinition",
        ]
        assert gt.statements[-1] == RelationshipTypeDefinition(
            NodeTypeDefinition(("A",)), ("B",), NodeTypeDefinition(("A",))
        )

    def test_full_script(self):
        ddl = _same_parse(FOO_DDL)
        assert [type(s).__name__ for s in ddl.statements] == [
            "SetSchemaDefinition",
            "GraphTypeDefinition",
            "GraphDefinition",
        ]
        graph = ddl.statements[2]
        assert isinstance(graph, GraphDefinition)
        assert graph.graph_type_name == "fooSchema"
        node_map, book_map, rel_map = graph.statements
        assert len(node_map.node_to_view) == 2
        assert len(rel_map.rel_type_to_view) == 2
        rtv = rel_map.rel_type_to_view[0]
        assert rtv.view_def.alias == "e"
        assert rtv.property_mapping == (("rating", "value1"),)
        assert rtv.start_node.join_on.join_predicates == (
            (("p", "person_id1"), ("e", "person")),
        )

    def test_comments_and_backticks(self):
        ddl = _same_parse(
            """
            -- line comment
            /* block
               comment */
            CREATE ELEMENT TYPE X ( `weird prop` STRING )
            // another
            """
        )
        (et,) = ddl.statements
        assert et.properties == (("weird prop", T.CTString),)

    def test_parse_error(self):
        with pytest.raises(GraphDdlParseError):
            parse_ddl("CREATE GRAPH TYPE ( broken")
        with pytest.raises(RDDL.GraphDdlParseError):
            RDDL.parse_ddl("CREATE GRAPH TYPE ( broken")


class TestModel:
    def test_resolution(self):
        g = _same_schemas(FOO_DDL).graphs["fooGraph"]
        gt = g.graph_type
        assert set(gt.element_types_by_name) == {"Person", "Book", "READS"}
        assert NodeType.of("Person") in gt.node_types
        assert RelationshipType.of("Person", "READS", "Book") in gt.rel_types
        person1 = next(
            m for m in g.node_to_view_mappings if m.view.table_name == "personView1"
        )
        assert dict(person1.property_mappings) == {"name": "person_name1", "age": "age"}
        assert person1.view.resolved == (
            "dataSourceName", "fooDatabaseName", "personView1",
        )
        assert g.node_id_columns_for(person1.key) == ("person_id1",)
        evm = g.edge_to_view_mappings[0]
        assert evm.start_node.join_predicates[0].node_column == "person_id1"
        assert evm.start_node.join_predicates[0].edge_column == "person"
        assert evm.end_node.join_predicates[0].node_column == "book_id"
        assert evm.end_node.join_predicates[0].edge_column == "book"
        ref = RDDL.GraphDdl.parse(FOO_DDL).graphs["fooGraph"]
        assert [repr(m) for m in g.edge_to_view_mappings] == [
            repr(m) for m in ref.edge_to_view_mappings]

    def test_schema_lowering(self):
        s = _same_schemas(FOO_DDL).graphs["fooGraph"].schema
        assert s.node_property_keys(("Person",)) == {
            "name": T.CTString,
            "age": T.CTInteger,
        }
        assert s.relationship_property_keys("READS") == {"rating": T.CTFloat}

    def test_extends_expands_labels_and_merges_properties(self):
        g = _same_schemas(EXTENDS_DDL).graphs["g"]
        nt = g.node_to_view_mappings[0].node_type
        assert nt.labels == frozenset({"Employee", "Person"})
        assert g.graph_type.node_property_keys(nt) == {
            "name": T.CTString,
            "dept": T.CTString,
        }

    @pytest.mark.parametrize("text, match", [
        ("""
         CREATE ELEMENT TYPE A EXTENDS B ( )
         CREATE ELEMENT TYPE B EXTENDS A ( )
         CREATE GRAPH g ( (A) FROM v )
         """, "Circular"),
        ("CREATE GRAPH g ( ) CREATE GRAPH g ( )", "Duplicate graph"),
        ("CREATE GRAPH g OF missing ( )", "Unresolved graph type"),
    ])
    def test_rejected(self, text, match):
        """Circular EXTENDS, a duplicate graph and an unresolved graph type
        are errors in both packages."""
        with pytest.raises(GraphDdlError, match=match):
            GraphDdl.parse(text)
        with pytest.raises(RDDL.GraphDdlError, match=match):
            RDDL.GraphDdl.parse(text)

    def test_property_conflict_rejected(self):
        text = """
            CREATE ELEMENT TYPE A ( x STRING )
            CREATE ELEMENT TYPE B ( x INTEGER )
            CREATE GRAPH g ( (A, B) FROM v )
            """
        with pytest.raises(GraphDdlError, match="conflicting"):
            GraphDdl.parse(text).graphs["g"].schema
        with pytest.raises(RDDL.GraphDdlError, match="conflicting"):
            RDDL.GraphDdl.parse(text).graphs["g"].schema

    def test_relative_view_requires_set_schema(self):
        text = "CREATE ELEMENT TYPE A (x STRING) CREATE GRAPH g ( (A) FROM v )"
        vid = _same_schemas(text).graphs["g"].node_to_view_mappings[0].view
        with pytest.raises(GraphDdlError, match="SET SCHEMA"):
            vid.resolved

    def test_union(self):
        a = GraphDdl.parse("CREATE GRAPH a ( )")
        b = GraphDdl.parse("CREATE GRAPH b ( )")
        assert set(a.union(b).graphs) == {"a", "b"}

    def test_pgds_schema_agrees(self):
        _same_schemas(PGDS_DDL)


@pytest.mark.parametrize("strategy", STRATEGIES)
class TestSqlPgds:
    def test_graph_names_and_schema(self, strategy):
        port, ref = _mount(strategy)
        g = port.graph("sql.books")
        assert g.schema.node_property_keys(("Person",)) == {
            "name": T.CTString,
            "age": T.CTInteger,
        }
        assert g.schema.to_json() == ref.graph("sql.books").schema.to_json()

    def test_match_nodes(self, strategy):
        got = _both(strategy, "MATCH (p:Person) RETURN p.name AS name, p.age AS age, "
                              "id(p) AS pid")
        assert sorted((r["name"], r["age"]) for r in got) == [
            ("Alice", 23), ("Bob", 42), ("Carl", 19)]

    def test_expand_across_views(self, strategy):
        q = ("MATCH (p:Person)-[r:READS]->(b:Book) WHERE r.rating >= 4.0 "
             "RETURN p.name AS reader, b.title AS title, r.rating AS rating, "
             "id(r) AS rid ORDER BY rating DESC")
        got = _both(strategy, q)
        assert [(r["reader"], r["title"], r["rating"]) for r in got] == [
            ("Alice", "Morpheus", 5.0), ("Bob", "Morpheus", 4.0)]

    def test_aggregation(self, strategy):
        got = _both(strategy, "MATCH (p:Person)-[:READS]->(b:Book) "
                              "RETURN b.title AS title, count(*) AS readers")
        assert _bag(got) == _bag([{"title": "Morpheus", "readers": 2},
                                  {"title": "Okapi", "readers": 1}])

    def test_file_tables_give_the_reference_ids(self, strategy, tmp_path):
        """``FileTables`` over parquet and CSV copies of the views: the
        port's ids equal the reference's over the same files, and equal the
        ids from ``InMemoryTables``."""
        import pandas as pd

        for fmt in ("parquet", "csv"):
            root = tmp_path / fmt
            for key, cols in TABLES.items():
                schema, view = key.split(".")
                (root / schema).mkdir(parents=True, exist_ok=True)
                df = pd.DataFrame(cols)
                path = root / schema / f"{view}.{fmt}"
                df.to_parquet(path, index=False) if fmt == "parquet" else df.to_csv(
                    path, index=False)
            q = ("MATCH (p:Person)-[r:READS]->(b:Book) "
                 "RETURN id(p) AS p, id(r) AS r, id(b) AS b, r.rating AS x")
            port, ref = _mount(strategy, str(root), lambda r: FileTables(r, fmt),
                               lambda r: RSQL.FileTables(r, fmt))
            got = port.graph("sql.books").cypher(q).records.collect()
            assert _bag(got) == _bag(ref.graph("sql.books").cypher(q).records.collect())
            mem, _ = _mount(strategy)
            assert _bag(got) == _bag(mem.graph("sql.books").cypher(q).records.collect())


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_query_through_the_device_backends(strategy):
    """One query per strategy through ``CypherSession.cuda(device="cpu")``
    and the reference's ``tpu()``: the same rows, the same ids."""
    q = ("MATCH (p:Person)-[r:READS]->(b:Book) RETURN p.name AS n, id(p) AS pid, "
         "id(b) AS bid, count(*) AS c")
    port = CypherSession.cuda(device="cpu")
    port.register_source("sql", SqlPropertyGraphDataSource(
        PGDS_DDL, {"sql": InMemoryTables(TABLES)},
        id_strategy=IdGenerationStrategy[strategy]))
    ref = R.CypherSession.tpu()
    ref.register_source("sql", RSQL.SqlPropertyGraphDataSource(
        PGDS_DDL, {"sql": RSQL.InMemoryTables(TABLES)},
        id_strategy=RSQL.IdGenerationStrategy[strategy]))
    got = port.graph("sql.books").cypher(q).records.collect()
    assert _bag(got) == _bag(ref.graph("sql.books").cypher(q).records.collect())
    assert len(got) == 3


class TestSqlPgdsErrors:
    def test_missing_view(self):
        session = CypherSession.local()
        session.register_source("sql", SqlPropertyGraphDataSource(
            "SET SCHEMA sql.db CREATE ELEMENT TYPE A (x STRING) "
            "CREATE GRAPH g ( (A) FROM nope )",
            {"sql": InMemoryTables(TABLES)},
        ))
        with pytest.raises((DataSourceError, GraphDdlError)):
            session.graph("sql.g")

    def test_serialized_dangling_edge(self):
        tables = dict(TABLES)
        tables["db.reads"] = {"person": [99], "book": [10], "rating": [1.0]}
        session = CypherSession.local()
        session.register_source("sql", SqlPropertyGraphDataSource(
            PGDS_DDL, {"sql": InMemoryTables(tables)},
            id_strategy=IdGenerationStrategy.SERIALIZED_ID,
        ))
        with pytest.raises(DataSourceError, match="missing node"):
            session.graph("sql.books")

    def test_hash64_stable_and_positive(self):
        assert hash64("a", 1) == hash64("a", 1)
        assert hash64("a", 1) != hash64("a", 2)
        assert 0 <= hash64("x") < 2**63
        for parts in (("a", 1), ("x",), ("(Person)@sql.db.persons", 2**62, None, 1.5)):
            assert hash64(*parts) == RSQL.hash64(*parts)


def test_parenthesized_property_types():
    (et,) = _same_parse(
        "CREATE ELEMENT TYPE A ( xs LIST(STRING), y INTEGER )"
    ).statements
    props = dict(et.properties)
    assert props["y"] == T.CTInteger
    assert "LIST" in str(props["xs"])
