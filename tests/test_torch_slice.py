"""The CSR expand slice end to end: the port against the JAX package.

Each slice query runs through the reference's ``CypherSession.tpu()`` (JAX
on the CPU), its ``CypherSession.local()`` oracle and the port's
``CypherSession.cuda(device="cpu")`` on the LDBC-SNB-shaped graph
(``generate_snb(0.02)``, seed 42). The port's graph is carried across by
``tpu_cypher_torch.interop`` from the reference graph's element tables, so
both engines compute on identical state. Rows must be bag-identical across
all three (exact: the data is integers and strings), the port's plan must
hold ``CsrExpandOp``, and the port must answer on the device rung alone: one
attempt, no kernel fallback, and every kernel the query names launched on
its CPU (``plain``) tier. The port has no host rung, host island or shadow
plan: a device fault, an expression it cannot compile and an aggregate it
does not port yet all reach the caller as errors.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.io.ldbc import generate_snb as ref_generate_snb
from tpu_cypher.relational.session import PropertyGraph as RefPropertyGraph

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import interop
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.io.ldbc import generate_snb as port_generate_snb

torch.set_num_threads(1)

SCALE = 0.02
TWO_HOP = (  # bench.py TWO_HOP, the north-star query
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "RETURN count(*) AS c"
)
QUERIES = {
    "Q1": ("MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id AS a, b.id AS b",
           ("expand_rows",)),
    "Q2": ("MATCH (a:Person)-[:KNOWS]->(b) RETURN count(*) AS c",
           ("frontier_deg_sum",)),
    "Q3": ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
           "RETURN min(b.birthday) AS lo, max(a.birthday) AS hi",
           ("expand_rows", "segment_agg")),
    "Q4": (TWO_HOP, ()),
    "Q5": ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
           "RETURN min(c.birthday) AS lo, max(c.birthday) AS hi",
           ("expand_rows", "segment_agg")),
    "social": ("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.firstname, b.firstname",
               ("expand_rows",)),
    # the CsrExpandOp variants the slice's queries do not reach: both
    # orientations (loops dropped from the second half) and a backwards hop
    "undirected": ("MATCH (a:Person)-[:KNOWS]-(b:Person) RETURN a.id AS a, b.id AS b",
                   ("expand_rows",)),
    "backwards": ("MATCH (a:Person)<-[:KNOWS]-(b) RETURN a.id AS a, b.birthday AS bd",
                  ("expand_rows",)),
}


def _element_tables(graph):
    node = [et for et in graph.scans if et.is_node][0]
    rel = [et for et in graph.scans if not et.is_node][0]
    return node, rel


@pytest.fixture(scope="module")
def engines():
    ref_session = R.CypherSession.tpu()
    ref_graph = ref_generate_snb(SCALE, ref_session)
    local_session = R.CypherSession.local()
    local_graph = ref_generate_snb(SCALE, local_session)
    # carry the reference graph's state across as numpy arrays
    node, rel = _element_tables(ref_graph)
    nt, rt = node.table, rel.table
    node_cols = {
        "birthday": np.asarray(nt.column_values("birthday"), np.int64),
        "firstname": nt.column_values("firstname"),
    }
    prop_types = dict(ref_graph.schema.node_property_keys(frozenset({"Person"})))
    port_session = CypherSession.cuda(device="cpu")
    port_graph = interop.graph_from_arrays(
        port_session,
        np.asarray(nt.column_values("id"), np.int64),
        node_cols,
        prop_types,
        np.asarray(rt.column_values("source"), np.int64),
        np.asarray(rt.column_values("target"), np.int64),
    )
    return (
        RefPropertyGraph(ref_session, ref_graph),
        RefPropertyGraph(local_session, local_graph),
        port_graph,
    )


def _bag(records):
    return Counter(tuple(sorted(dict(r).items())) for r in records.collect())


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_slice_query_bag_identical(engines, qname):
    query, kernels = QUERIES[qname]
    ref, local, port = engines
    PD.reset()
    result = port.cypher(query)
    got = _bag(result.records)
    assert got == _bag(ref.cypher(query).records), qname
    assert got == _bag(local.cypher(query).records), qname
    assert sum(got.values()) > 0
    # the port answered on the device path alone
    assert "CsrExpandOp" in result.plans
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    counts = PD.use_counts()
    for name, c in counts.items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)
        assert (c["plain"] > 0) == (name in kernels), (qname, name, c)


def test_slice_expected_values(engines):
    """The headline answers on the test graph, from numpy."""
    _, _, port = engines
    node, rel = _element_tables(port._graph)
    ids = node.table.column_values("id")
    src = np.searchsorted(ids, rel.table.column_values("source"))
    dst = np.searchsorted(ids, rel.table.column_values("target"))
    outdeg = np.bincount(src, minlength=len(ids))
    rows = port.cypher(QUERIES["Q2"][0]).records.collect()
    assert [dict(r) for r in rows] == [{"c": len(src)}]
    rows = port.cypher(TWO_HOP).records.collect()
    assert [dict(r) for r in rows] == [{"c": int(outdeg[dst].sum())}]


def test_result_tensors_on_backend_device(engines):
    _, _, port = engines
    table = port.cypher(QUERIES["Q1"][0]).records.table
    for col in table._cols.values():
        assert isinstance(col.data, torch.Tensor) and col.data.device.type == "cpu"


@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_port_generator_matches_reference(scale):
    """The port's copy of ``generate_snb`` gives the same arrays from the
    same seed (SF1 included: 10,000 persons, 449,972 KNOWS)."""
    ref_graph = ref_generate_snb(scale, R.CypherSession.local())
    port_graph = port_generate_snb(scale, CypherSession.cuda(device="cpu"))
    for (r, p) in zip(_element_tables(ref_graph), _element_tables(port_graph)):
        assert r.table.physical_columns == p.table.physical_columns
        for c in r.table.physical_columns:
            assert r.table.column_values(c) == p.table.column_values(c), c
    if scale == 1.0:
        assert port_graph.scans[1].table.size == 449_972


def test_unported_spi_names_its_roadmap_item():
    from tpu_cypher_torch.backend.cuda.table import CudaTable

    t = CudaTable.from_columns({"x": [1, 2]})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        t.join(t, "inner", [("x", "x")])


@pytest.mark.parametrize(
    "qname,site", [("Q1", "expand"), ("Q3", "agg"), ("Q5", "expand")]
)
def test_device_fault_reaches_caller_typed(engines, qname, site):
    """A device fault is raised typed after ONE attempt on the device rung;
    no rung re-executes the query on the host."""
    from tpu_cypher_torch import errors as ERR
    from tpu_cypher_torch.runtime import faults

    _, _, port = engines
    result = port.cypher(QUERIES[qname][0])
    with faults.scoped_spec(f"oom@{site}:*"):
        with pytest.raises(ERR.DeviceOOM):
            result.records
    log = result.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device", log
    assert not log[0]["ok"] and log[0]["error"] == "DeviceOOM", log


@pytest.mark.parametrize(
    "query",
    [
        # an expression kind the slice's compiler does not cover
        "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.birthday + 1 AS x",
        # an aggregate the slice's group does not cover
        "MATCH (a:Person)-[:KNOWS]->(b) RETURN collect(b.birthday) AS xs",
        # grouping keys
        "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.firstname AS f, count(*) AS c",
    ],
)
def test_no_host_island(engines, query):
    """What the slice's device path cannot compute raises; the reference
    would answer it on its host oracle, the port does not."""
    from tpu_cypher_torch.backend.cuda.compiler import TpuUnsupportedExpr

    _, _, port = engines
    with pytest.raises(TpuUnsupportedExpr):
        port.cypher(query).records.collect()


def test_fused_expand_error_is_not_answered_by_classic_plan(engines, monkeypatch):
    """The reference answers from the classic scan+join child when the
    fused operator raises; the port lets the error reach the caller."""
    from tpu_cypher_torch.backend.cuda import expand_op as PX
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndexError

    def broken(self):
        raise GraphIndexError("simulated: graph cannot be indexed")

    monkeypatch.setattr(PX.CsrExpandOp, "_fused_table", broken)
    _, _, port = engines
    with pytest.raises(GraphIndexError, match="simulated"):
        port.cypher(QUERIES["Q1"][0]).records
