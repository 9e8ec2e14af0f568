"""The filesystem source of the port against the JAX package's.

The counterpart of ``tests/test_io.py``'s filesystem, cache and namespace
tests, for parquet and CSV, on the port's ``CypherSession.local()``; then:

* round trips across the packages: a graph that the reference stores loads
  in the port and the reverse, on ``tests/test_io.py``'s CREATE graph and
  on ``generate_snb(0.05, temporal=True)``, with bag-identical answers to a
  2-hop count, a triangle count, a grouped min and a value join (the SNB
  graph on ``CypherSession.cuda(device="cpu")`` and the reference's
  ``tpu()``);
* every part file's DataFrame equal between the two packages' stores of one
  graph, dtypes included;
* the bulk routes (``CudaTable.frame_columns`` out, ``from_arrays`` in)
  against the value routes (rows out, ``from_columns`` in): the same
  DataFrame, the same column kinds, values and nulls;
* a process in which ``import pandas`` fails: ``tpu_cypher_torch.io``
  imports, and loading a stored graph raises ``DataSourceError`` naming
  pandas.
"""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pandas as pd
import pytest

import tpu_cypher as R
from tpu_cypher.api import types as RT
from tpu_cypher.io import FSGraphSource as RefFS
from tpu_cypher.io import fs as RF
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.api import types as T
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda.table import CudaTable
from tpu_cypher_torch.io import (
    CachedDataSource,
    DataSourceError,
    FSGraphSource,
)
from tpu_cypher_torch.io import fs as F
from tpu_cypher_torch.io.ldbc import generate_snb
from tpu_cypher_torch.relational.session import CatalogError, PropertyGraph
from tpu_cypher_torch.testing.bag import Bag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ["parquet", "csv"]
CREATE = (
    "CREATE (a:Person {name:'Alice', age:23})-[:KNOWS {since:2019}]->"
    "(b:Person:Admin {name:'Bob'}),"
    "(a)-[:LIKES {tags:['x','y']}]->"
    "(c:Thing {d: date('2020-01-02'), dur: duration({days:2})})"
)
# a 2-hop count, a triangle count, a grouped min over all three temporal
# kinds, a value join
SNB_QUERIES = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) RETURN count(*) AS c",
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
    "RETURN count(*) AS t",
    "MATCH (a:Person)-[k:KNOWS]->(b:Person) RETURN a.id % 7 AS g, "
    "min(k.creationDate) AS lo, min(b.birthday) AS bd, min(b.created) AS cr",
    "MATCH (a:Person)-[:KNOWS]->(b:Person), (c:Person) "
    "WHERE b.birthday = c.birthday RETURN count(*) AS n",
)


@pytest.fixture()
def session():
    return CypherSession.local()


@pytest.fixture()
def graph(session):
    return session.create_graph_from_create_query(CREATE)


def _bag(rows):
    return Counter(tuple(sorted((k, str(v)) for k, v in dict(r).items())) for r in rows)


def _parts(root):
    """Every part file under ``root``, relative path -> its DataFrame."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.startswith("part."):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = (
                    pd.read_parquet(p) if f.endswith(".parquet") else pd.read_csv(p))
    return out


def _same_parts(a, b):
    pa, pb = _parts(a), _parts(b)
    assert sorted(pa) == sorted(pb) and pa
    for rel, df in pa.items():
        pd.testing.assert_frame_equal(df, pb[rel], check_exact=True)


@pytest.mark.parametrize("fmt", FORMATS)
class TestFSGraphSource:
    def test_roundtrip(self, tmp_path, session, graph, fmt):
        session.register_source("fs", FSGraphSource(str(tmp_path), fmt))
        session.store_graph("fs.g1", graph)
        assert "fs.g1" in session.catalog_names
        g2 = session.graph("fs.g1")
        assert g2.schema == graph.schema
        got = g2.cypher(
            "MATCH (a:Person)-[k:KNOWS]->(b) RETURN a.name, k.since, b.name"
        ).records.to_bag()
        assert got == Bag([{"a.name": "Alice", "k.since": 2019, "b.name": "Bob"}])

    def test_exotic_values_roundtrip(self, tmp_path, session, graph, fmt):
        src = FSGraphSource(str(tmp_path), fmt)
        src.store("g", graph._graph)
        pg = PropertyGraph(session, src.graph("g", session))
        got = pg.cypher(
            "MATCH (t:Thing) RETURN t.d.year AS y, t.dur.days AS days"
        ).records.to_bag()
        assert got == Bag([{"y": 2020, "days": 2}])
        got = pg.cypher("MATCH ()-[l:LIKES]->() RETURN l.tags").records.to_bag()
        assert got == Bag([{"l.tags": ["x", "y"]}])

    def test_from_graph_query(self, tmp_path, session, graph, fmt):
        session.register_source("fs", FSGraphSource(str(tmp_path), fmt))
        session.store_graph("fs.g1", graph)
        got = session.cypher(
            "FROM GRAPH fs.g1 MATCH (n:Admin) RETURN n.name"
        ).records.to_bag()
        assert got == Bag([{"n.name": "Bob"}])

    def test_store_twice_errors(self, tmp_path, session, graph, fmt):
        src = FSGraphSource(str(tmp_path), fmt)
        src.store("g", graph._graph)
        with pytest.raises(DataSourceError):
            src.store("g", graph._graph)
        src.delete("g")
        src.store("g", graph._graph)

    def test_directory_layout(self, tmp_path, session, graph, fmt):
        FSGraphSource(str(tmp_path), fmt).store("g", graph._graph)
        base = tmp_path / "g"
        assert (base / "propertyGraphSchema.json").is_file()
        assert (base / "metadata.json").is_file()
        assert (base / "nodes" / "Person").is_dir()
        assert (base / "nodes" / "Admin_Person").is_dir()
        assert (base / "relationships" / "KNOWS").is_dir()
        assert (base / "relationships" / "LIKES" / f"part.{fmt}").is_file()

    def test_create_graph_across_packages(self, tmp_path, graph, fmt):
        """The reference's store loads in the port and the port's in the
        reference, with the same answers; the part files are equal,
        whether the port stored from ``local()`` or from the device
        backend."""
        ref = R.CypherSession.local()
        rg = ref.create_graph_from_create_query(CREATE)
        RefFS(str(tmp_path / "ref"), fmt).store("g", rg._graph)
        FSGraphSource(str(tmp_path / "port"), fmt).store("g", graph._graph)
        dev = CypherSession.cuda(device="cpu")
        dg = dev.create_graph_from_create_query(CREATE)
        FSGraphSource(str(tmp_path / "dev"), fmt).store("g", dg._graph)
        _same_parts(tmp_path / "ref", tmp_path / "port")
        _same_parts(tmp_path / "ref", tmp_path / "dev")
        q = ("MATCH (a:Person)-[k:KNOWS]->(b) OPTIONAL MATCH (a)-[l:LIKES]->(t) "
             "RETURN a.name AS a, a.age AS age, k.since AS s, b.name AS b, "
             "l.tags AS tags, t.d AS d, t.dur AS dur")
        mine = PropertyGraph(dev, FSGraphSource(str(tmp_path / "ref"), fmt).graph("g", dev))
        theirs = RefPropertyGraph(ref, RefFS(str(tmp_path / "dev"), fmt).graph("g", ref))
        got = mine.cypher(q).records.collect()
        assert _bag(got) == _bag(theirs.cypher(q).records.collect())
        assert _bag(got) == _bag(rg.cypher(q).records.collect()) and len(got) == 1


@pytest.fixture(scope="module")
def snb():
    """``generate_snb(0.05, temporal=True)`` on the port's device backend
    (the CPU) and its answers to ``SNB_QUERIES``."""
    PDEV.use("cpu")
    s = CypherSession.cuda(device="cpu")
    g = PropertyGraph(s, generate_snb(0.05, s, temporal=True))
    return s, g, [g.cypher(q).records.collect() for q in SNB_QUERIES]


@pytest.mark.parametrize("fmt", FORMATS)
def test_snb_temporal_across_packages(tmp_path, snb, fmt):
    """The port stores SNB with its temporal columns; the reference loads it
    and stores it again; the two stores' part files are equal, dtypes
    included; the port loads the reference's store. Both loaded graphs
    answer ``SNB_QUERIES`` as the generated graph does (the reference: its
    grouped min and value join on ``local()``, and from parquet its counts
    on ``tpu()``)."""
    s, g, want = snb
    FSGraphSource(str(tmp_path / "port"), fmt).store("snb", g._graph)
    ref = R.CypherSession.local()
    rg = RefPropertyGraph(ref, RefFS(str(tmp_path / "port"), fmt).graph("snb", ref))
    RefFS(str(tmp_path / "ref"), fmt).store("snb", rg._graph)
    _same_parts(tmp_path / "port", tmp_path / "ref")
    back = PropertyGraph(s, FSGraphSource(str(tmp_path / "ref"), fmt).graph("snb", s))
    for q, w in zip(SNB_QUERIES, want):
        assert _bag(back.cypher(q).records.collect()) == _bag(w)
    if fmt == "parquet":
        tpu = R.CypherSession.tpu()
        rt = RefPropertyGraph(tpu, RefFS(str(tmp_path / "port"), fmt).graph("snb", tpu))
        for q, w in zip(SNB_QUERIES[:2], want):
            assert _bag(rt.cypher(q).records.collect()) == _bag(w)
    for q, w in zip(SNB_QUERIES[2:], want[2:]):
        assert _bag(rg.cypher(q).records.collect()) == _bag(w)
    assert want[0][0]["c"] > 0 and want[1][0]["t"] > 0


def _frame_cases():
    """(name, values, type name, nullable) columns with and without nulls,
    of every kind the bulk route takes and of some it leaves to the
    values."""
    return [
        ("int", [3, -(2**62), 7, 0], "CTInteger", False),
        ("int_null", [3, None, 7, 0], "CTInteger", True),
        ("float", [1.5, -0.0, float("nan"), 2.0], "CTFloat", False),
        ("float_null", [1.5, None, 3.0, 2.0], "CTFloat", True),
        ("bool", [True, False, False, True], "CTBoolean", False),
        ("bool_null", [True, None, False, True], "CTBoolean", True),
        ("str", ["a", "b", None, "NA"], "CTString", True),
        ("mixed", [1, 2.5, 3, 4.0], "CTFloat", False),
    ]


def _types(types_module):
    out = {}
    for name, _, ty, nullable in _frame_cases():
        t = getattr(types_module, ty)
        out[name] = t.nullable if nullable else t
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_bulk_routes_match_value_routes(tmp_path, fmt):
    """Out: ``CudaTable.frame_columns`` gives the DataFrame the row-by-row
    build gives, dtypes included. In: a part file read back through
    ``from_arrays`` (the bulk route where a column allows it) gives the
    column kinds, values and nulls that ``from_columns`` gives over the
    values the reference's ``_read_df`` and ``_pandas_to_values`` decode."""
    PDEV.use("cpu")
    t = CudaTable.from_columns({name: vals for name, vals, _, _ in _frame_cases()})
    bulk = F._table_to_pandas(t)

    class Rows:  # the reference's route: no ``frame_columns``
        physical_columns = t.physical_columns
        rows = t.rows

    pd.testing.assert_frame_equal(bulk, F._table_to_pandas(Rows()), check_exact=True)
    empty = CudaTable.from_columns({"x": []})
    Rows.physical_columns, Rows.rows = empty.physical_columns, empty.rows
    pd.testing.assert_frame_equal(F._table_to_pandas(empty), F._table_to_pandas(Rows()))
    types = _types(T)
    src = FSGraphSource(str(tmp_path), fmt)
    path = os.path.join(str(tmp_path), f"part.{fmt}")
    src._write_df(bulk, types, path)
    raw = src._read_raw(path, fmt)
    routed = F._frame_table(raw, types, CudaTable, fmt == "csv")
    ref_types = _types(RT)
    by_values = CudaTable.from_columns(RF._pandas_to_values(
        RefFS(str(tmp_path), fmt)._read_df(path, ref_types, fmt), ref_types))
    took_bulk = {c for c in raw.columns
                 if F._bulk_array(raw[c], types[c], False) is not None}
    assert {"int", "bool"} <= took_bulk and "int_null" not in took_bulk
    for c in raw.columns:
        a, b = routed._cols[c], by_values._cols[c]
        assert a.kind == b.kind, c
        assert str(a.to_values()) == str(b.to_values()), c
        assert (a.valid is None) == (b.valid is None), c


def test_graph_table_cls_falls_back_to_the_device_table():
    """A graph with no scans extracts on ``CudaTable``; one with scans on
    its own tables' class."""
    assert F._graph_table_cls(object()) is CudaTable
    s = CypherSession.local()
    g = s.create_graph_from_create_query("CREATE (:A)")
    assert F._graph_table_cls(g._graph) is s.table_cls


def test_io_imports_without_pandas(tmp_path, graph):
    """Where ``import pandas`` fails, ``tpu_cypher_torch.io`` imports and
    loading or storing a graph raises ``DataSourceError`` naming pandas."""
    FSGraphSource(str(tmp_path), "csv").store("g", graph._graph)
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import tpu_cypher_torch.io as io\n"
        "from tpu_cypher_torch import CypherSession\n"
        "s = CypherSession.local()\n"
        f"src = io.FSGraphSource({str(tmp_path)!r}, 'csv')\n"
        "assert src.has_graph('g') and src.schema('g') is not None\n"
        "try:\n"
        "    src.graph('g', s)\n"
        "except io.DataSourceError as e:\n"
        "    assert 'pandas' in str(e), e\n"
        "    print('RAISED', e)\n"
        "assert 'jax' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout and "'pandas'" in out.stdout


class TestCachedDataSource:
    def test_caches_loads(self, tmp_path, session, graph):
        inner = FSGraphSource(str(tmp_path), "parquet")
        inner.store("g", graph._graph)
        calls = {"n": 0}
        orig = inner.graph

        def counting(name, sess):
            calls["n"] += 1
            return orig(name, sess)

        inner.graph = counting
        session.register_source("c", CachedDataSource(inner))
        session.graph("c.g")
        session.graph("c.g")
        assert calls["n"] == 1

    def test_delete_invalidates(self, tmp_path, session, graph):
        cached = CachedDataSource(FSGraphSource(str(tmp_path), "parquet"))
        cached.store("g", graph._graph)
        assert cached.has_graph("g")
        cached.delete("g")
        assert not cached.has_graph("g")


class TestSessionNamespaces:
    def test_reserved_namespaces(self, session):
        with pytest.raises(Exception):
            session.register_source("session", None)

    def test_unknown_graph(self, session):
        with pytest.raises(CatalogError):
            session.graph("nope.g")


class TestReviewRegressions:
    """CSV NA-token mangling, label-combo directory collisions, stored-format
    metadata."""

    def test_csv_na_like_strings_roundtrip(self, tmp_path, session):
        g = session.create_graph_from_create_query(
            "CREATE (:S {v:'NA'}), (:S {v:'null'}), (:S {v:''}), (:S {v:'NaN'}),"
            " (:S {v:'ok'}), (:S)"
        )
        src = FSGraphSource(str(tmp_path), "csv")
        src.store("g", g._graph)
        rows = PropertyGraph(session, src.graph("g", session)).cypher(
            "MATCH (n:S) RETURN n.v AS v")
        got = sorted(
            (r["v"] for r in rows.records.collect()), key=lambda x: (x is None, x)
        )
        assert got == ["", "NA", "NaN", "null", "ok", None]

    def test_combo_dir_no_collision(self):
        assert F._combo_dir({"Admin", "Person"}) != F._combo_dir({"Admin_Person"})
        assert F._combo_dir({"A", "B_C"}) != F._combo_dir({"A_B", "C"})
        for labels in ({"Admin", "Person"}, {"A", "B_C"}, {"a b/c", "..", "%"}, set()):
            assert F._combo_dir(labels) == RF._combo_dir(labels)

    def test_format_mismatch_reads_stored_format(self, tmp_path, session, graph):
        FSGraphSource(str(tmp_path), "parquet").store("g", graph._graph)
        loaded = FSGraphSource(str(tmp_path), "csv").graph("g", session)
        assert loaded.schema == graph.schema


def test_label_dirs_cannot_path_traverse():
    for evil in (".", "..", "a/../../b"):
        assert "/" not in F._combo_dir({evil})
        assert F._combo_dir({evil}) not in (".", "..")
        assert "/" not in F._rel_dir(evil)
        assert F._rel_dir(evil) not in (".", "..")


def test_unsupported_format():
    with pytest.raises(DataSourceError):
        FSGraphSource("unused", "orc")
