"""The port's native C++ host tier against the reference's and numpy.

The counterpart of ``tests/test_native.py``: every function of
``tpu_cypher_torch.native`` on the same inputs as the reference's
``tpu_cypher.native`` (both built from the same C++ source with ``g++``)
and as the numpy paths, exactly; the edge-list source end to end through
``CypherSession.cuda(device="cpu")``; and the build, which goes to
``tpu_cypher_torch/_build/`` and writes nothing beside the source.
"""

import os

import numpy as np
import pytest

from tpu_cypher import native as RN

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import native as N
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.io import DataSourceError, EdgeListDataSource, load_edge_list
from tpu_cypher_torch.relational.session import PropertyGraph


@pytest.fixture(scope="module", autouse=True)
def _lib():
    if N.get_lib() is None or RN.get_lib() is None:
        pytest.skip(f"no C++ toolchain: {N.build_error()}")
    PDEV.use("cpu")


def _numpy_csr(node_ids, src, dst):
    node_ids = np.unique(np.asarray(node_ids, dtype=np.int64))
    s = np.searchsorted(node_ids, src).astype(np.int32)
    d = np.searchsorted(node_ids, dst).astype(np.int32)
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    row_ptr = np.searchsorted(s, np.arange(len(node_ids) + 1)).astype(np.int32)
    return node_ids, row_ptr, d, s


def _same(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_build_lands_in_the_build_root():
    """The library lives under ``tpu_cypher_torch/_build/native-<hash>``;
    the package directory holds only the loader and the source."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(N.__file__)))
    assert os.path.dirname(N.lib_path()) == N.build_dir()
    assert N.build_dir().startswith(os.path.join(root, "_build", "native-"))
    assert os.path.isfile(N.lib_path())
    here = os.path.dirname(os.path.abspath(N.__file__))
    assert sorted(f for f in os.listdir(here) if f != "__pycache__") == [
        "__init__.py", "csr_builder.cpp"]
    assert N.build_error() is None


def test_failed_build_is_recorded(monkeypatch, tmp_path):
    """A compiler that refuses leaves no library and says why."""
    monkeypatch.setattr(N, "_SRC", str(tmp_path / "broken.cpp"))
    (tmp_path / "broken.cpp").write_text("not c++\n")
    err = N._compile(str(tmp_path / "lib.so"))
    assert err is not None and "g++" in err
    assert os.listdir(tmp_path) == ["broken.cpp"]


class TestBuildCsr:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_reference_and_numpy(self, seed):
        rng = np.random.default_rng(seed)
        ids = rng.choice(10_000, 500, replace=False).astype(np.int64) * 13 + 7
        src = rng.choice(ids, 4000)
        dst = rng.choice(ids, 4000)
        _same(N.build_csr_native(ids, src, dst), RN.build_csr_native(ids, src, dst),
              _numpy_csr(ids, src, dst))

    def test_duplicate_node_ids_deduped(self):
        ids = np.array([5, 5, 3, 3, 9], dtype=np.int64)
        got = N.build_csr_native(ids, np.array([3, 9]), np.array([9, 5]))
        _same(got, RN.build_csr_native(ids, np.array([3, 9]), np.array([9, 5])))
        np.testing.assert_array_equal(got[0], [3, 5, 9])

    def test_empty_graph(self):
        ids, z = np.array([1, 2], dtype=np.int64), np.zeros(0, np.int64)
        got = N.build_csr_native(ids, z, z)
        np.testing.assert_array_equal(got[1], [0, 0, 0])
        assert len(got[2]) == 0

    def test_unknown_endpoint_rejected(self):
        with pytest.raises(ValueError, match="not present"):
            N.build_csr_native(np.array([1, 2], dtype=np.int64),
                               np.array([1], dtype=np.int64), np.array([99], dtype=np.int64))

    def test_parallel_edges_kept(self):
        got = N.build_csr_native(np.array([1, 2], dtype=np.int64), np.array([1, 1]),
                                 np.array([2, 2]))
        np.testing.assert_array_equal(got[2], [1, 1])


class TestParseEdgeList:
    @pytest.mark.parametrize("data", [
        b"# comment\n1 2\n3 4\n",
        b"1,2\n3\t4\t0.5\n\n5 6",
        b"1 2\r\n-3 4\r\n",
        b"1 2 0.5\n",
        b"",
        b"# only a comment",
    ])
    def test_matches_reference(self, data):
        _same(N.parse_edge_list_native(data), RN.parse_edge_list_native(data))

    @pytest.mark.parametrize("data", [b"1 x\n", b"1 2.5\n", b"1 2x\n", b"1x 2\n", b"7\n"])
    def test_malformed_rejected_like_reference(self, data):
        with pytest.raises(ValueError, match="byte offset") as got:
            N.parse_edge_list_native(data)
        with pytest.raises(ValueError) as want:
            RN.parse_edge_list_native(data)
        assert str(got.value) == str(want.value)


def _counts():
    """The three count functions of both packages on one seeded CSR: the
    port's and the reference's answers, pairwise."""
    rng = np.random.default_rng(31)
    n, e = 60, 400
    s, d = rng.integers(0, n, e), rng.integers(0, n, e)
    ids = np.arange(n, dtype=np.int64)
    _, rp, ci, _ = N.build_csr_native(ids, s, d)
    eo = np.arange(e, dtype=np.int64)
    frontier = np.sort(rng.integers(0, n, 80)).astype(np.int64)
    mask = rng.random(n) < 0.7
    out = []
    for mod in (N, RN):
        out.append((
            mod.two_hop_distinct_native(rp, ci, rp, ci, frontier, frontier, n, True, True,
                                        None, mask),
            mod.two_hop_distinct_native(rp, ci, rp, ci, frontier, frontier, n, True, False,
                                        mask, None),
            mod.two_hop_close_count_native(rp, ci, rp, ci, rp, ci, frontier, frontier, n,
                                           mask, None),
            mod.varlen_count_native(rp, ci, eo, frontier, 1, 3, mask),
            mod.varlen_count_native(rp, ci, eo, frontier, 1, 2, None,
                                    forbid=np.full((len(frontier), 1), 3, np.int64)),
            # ungrouped akeys and an out-of-range bound decline alike
            mod.two_hop_distinct_native(rp, ci, rp, ci, frontier, np.array(
                [0, 1] * 40), n, True, True, None, None),
            mod.varlen_count_native(rp, ci, eo, frontier, 1, 65, None),
        ))
    return out


def test_count_functions_match_reference():
    """The stamping and DFS counts keep the reference's signatures and
    answers, though no operator of the port calls them."""
    got, want = _counts()
    assert got == want
    assert all(x is not None and x > 0 for x in got[:5]) and got[5:] == (None, None)


class TestEdgeListSource:
    def test_loader_counts_like_reference(self, tmp_path):
        from tpu_cypher import CypherSession as RefSession
        from tpu_cypher.io.edge_list import load_edge_list as ref_load
        from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

        p = tmp_path / "g.txt"
        p.write_text("# snap\n1 2\n2 3\n1 3\n3 1\n")
        q = "MATCH (a)-[:E]->(b)-[:E]->(c) RETURN a.id IS NULL AS x, count(*) AS n"
        s = CypherSession.cuda(device="cpu")
        got = PropertyGraph(s, load_edge_list(str(p), s)).cypher(q).records.collect()
        rs = RefSession.local()
        want = RefPropertyGraph(rs, ref_load(str(p), rs)).cypher(q).records.collect()
        assert [dict(r) for r in got] == [dict(r) for r in want] == [{"x": True, "n": 5}]

    def test_numpy_path_when_native_is_missing(self, tmp_path, monkeypatch):
        """Without the library the loader parses line by line, to the same
        graph, and rejects what the native parser rejects."""
        p = tmp_path / "g.txt"
        p.write_text("1 2\n2,3\n")
        s = CypherSession.cuda(device="cpu")
        q = "MATCH (a)-[:E]->(b) RETURN count(*) AS n"
        native_rows = PropertyGraph(s, load_edge_list(str(p), s)).cypher(q).records.collect()
        monkeypatch.setattr(N, "get_lib", lambda: None)
        rows = PropertyGraph(s, load_edge_list(str(p), s)).cypher(q).records.collect()
        assert [dict(r) for r in rows] == [dict(r) for r in native_rows] == [{"n": 2}]
        bad = tmp_path / "bad.txt"
        bad.write_text("1 2\n3 x\n")
        with pytest.raises(DataSourceError, match="line 2"):
            load_edge_list(str(bad), s)

    def test_malformed_file_raises_data_source_error(self, tmp_path):
        bad = tmp_path / "bad.txt"
        bad.write_text("1 2\n3 4.5\n")
        with pytest.raises(DataSourceError, match="Malformed edge list"):
            load_edge_list(str(bad), CypherSession.cuda(device="cpu"))

    def test_data_source(self, tmp_path):
        (tmp_path / "g1").write_text("1 2\n")
        src = EdgeListDataSource(str(tmp_path))
        assert src.graph_names() == ["g1"] and src.has_graph("g1")
        s = CypherSession.cuda(device="cpu")
        g = PropertyGraph(s, src.graph("g1", s))
        assert [dict(r) for r in g.cypher("MATCH (a:V)-[:E]->(b:V) RETURN id(a) AS a, "
                                          "id(b) AS b").records.collect()] == [{"a": 1, "b": 2}]
        with pytest.raises(DataSourceError):
            src.graph("missing", s)
        with pytest.raises(DataSourceError):
            src.store("g2", g)
