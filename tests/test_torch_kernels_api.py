"""The standalone kernel API (``backend/cuda/kernels.py``) against the
reference's ``backend/tpu/kernels.py``, on the CPU.

The counterpart of the non-mesh half of ``tests/test_kernels.py``: the CSR
build (native and numpy), the ring, brute force, triangles and walk counts,
and the engine's count, each on the same arrays as the reference, exactly.
On the CPU each gate runs its kernel's plain version (tier ``plain``); the
tests check which gate each function went through.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from tpu_cypher.backend.tpu import kernels as RK

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import native as N
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import kernels as K
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


def _both(ids, src, dst):
    return RK.CsrGraph.build(ids, src, dst), K.CsrGraph.build(ids, src, dst, device="cpu")


def _eq(ref, port):
    np.testing.assert_array_equal(np.asarray(ref), port.cpu().numpy())


def ring_graph(n):
    """0 -> 1 -> ... -> n-1 -> 0 on non-contiguous ids."""
    ids = np.arange(n, dtype=np.int64) * 7 + 3
    return _both(ids, ids, np.roll(ids, -1))


def random_graph(n, e, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    return _both(ids, ids[rng.integers(0, n, e)], ids[rng.integers(0, n, e)])


def brute_two_hop(src, dst):
    out_edges = {}
    for s, d in zip(src, dst):
        out_edges.setdefault(s, []).append(d)
    count, pairs = 0, set()
    for s, d in zip(src, dst):
        for c in out_edges.get(d, []):
            count += 1
            pairs.add((s, c))
    return count, len(pairs)


def brute_triangles(src, dst):
    """Every (r1, r2, r3) relationship triple is a match."""
    edge_mult = Counter(zip(src.tolist(), dst.tolist()))
    out_edges = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        out_edges.setdefault(s, []).append(d)
    return sum(edge_mult.get((c, s), 0)
               for s, d in zip(src.tolist(), dst.tolist()) for c in out_edges.get(d, []))


def _uses():
    return {k: {t: n for t, n in c.items() if n} for k, c in PD.use_counts().items()
            if any(c.values())}


@pytest.mark.parametrize("native", [True, False])
def test_csr_build_matches_reference(native, monkeypatch):
    """Native and numpy builds give the reference's arrays; the numpy path
    rejects an unknown endpoint as the native one does."""
    if not native:
        monkeypatch.setattr(N, "build_csr_native", lambda *a: None)
    elif N.get_lib() is None:
        pytest.skip(f"no C++ toolchain: {N.build_error()}")
    ref, port = random_graph(50, 300, seed=3)
    for name in ("node_ids", "row_ptr", "col_idx", "src_idx"):
        _eq(getattr(ref, name), getattr(port, name))
    assert port.row_ptr.dtype == port.col_idx.dtype == port.src_idx.dtype == torch.int32
    assert port.max_degree == ref.max_degree
    with pytest.raises(ValueError, match="not present"):
        K.CsrGraph.build(np.array([1, 2], np.int64), np.array([1], np.int64),
                         np.array([99], np.int64), device="cpu")


def test_csr_build():
    _, g = ring_graph(5)
    assert g.num_nodes == 5 and g.num_edges == 5
    assert g.degrees.tolist() == [1, 1, 1, 1, 1]
    assert g.node_ids.device.type == "cpu"


def test_two_hop_count_ring():
    _, g = ring_graph(10)
    assert int(K.two_hop_count(g.row_ptr, g.col_idx)) == 10
    assert _uses() == {"frontier_deg_sum": {"plain": 1}}


@pytest.mark.parametrize("seed", [0, 4])
def test_two_hop_vs_reference_and_bruteforce(seed):
    ref, g = random_graph(50, 300, seed=seed)
    total = int(K.two_hop_count(g.row_ptr, g.col_idx))
    want_count, want_distinct = brute_two_hop(g.src_idx.numpy(), g.col_idx.numpy())
    assert total == want_count == int(RK.two_hop_count(ref.row_ptr, ref.col_idx))
    a, c, distinct = K.two_hop_expand(g.row_ptr, g.col_idx, g.src_idx, total)
    ra, rc, rdistinct = RK.two_hop_expand(ref.row_ptr, ref.col_idx, ref.src_idx, total)
    _eq(ra, a)
    _eq(rc, c)
    assert int(distinct) == int(rdistinct) == want_distinct
    assert _uses() == {"frontier_deg_sum": {"plain": 1}, "expand_rows": {"plain": 1}}


def test_triangles_vs_reference_and_bruteforce():
    ref, g = random_graph(30, 200, seed=1)
    total = int(K.two_hop_count(g.row_ptr, g.col_idx))
    got = int(K.triangle_count(g.row_ptr, g.col_idx, g.src_idx, total))
    assert got == brute_triangles(g.src_idx.numpy(), g.col_idx.numpy())
    assert got == int(RK.triangle_count(ref.row_ptr, ref.col_idx, ref.src_idx, total))
    assert _uses()["intersect"] == {"plain": 1}


def test_empty_edges_answer_before_the_gates():
    _, g = _both(np.arange(4, dtype=np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert int(K.two_hop_count(g.row_ptr, g.col_idx)) == 0
    a, c, distinct = K.two_hop_expand(g.row_ptr, g.col_idx, g.src_idx, 0)
    assert len(a) == len(c) == 0 and int(distinct) == 0
    assert int(K.triangle_count(g.row_ptr, g.col_idx, g.src_idx, 0)) == 0


def test_walk_counts_ring():
    ref, g = ring_graph(6)
    start = np.zeros(6, np.int64)
    start[0] = 1
    per_hop = K.walk_counts(g.src_idx, g.col_idx, start, 4, g.num_nodes)
    _eq(RK.walk_counts(ref.src_idx, ref.col_idx, start, 4, ref.num_nodes), per_hop)
    assert per_hop.sum(dim=1).tolist() == [1, 1, 1, 1]
    assert per_hop[3].tolist() == [0, 0, 0, 0, 1, 0]


def test_walk_counts_random_matches_reference():
    ref, g = random_graph(40, 200, seed=2)
    start = np.random.default_rng(9).integers(0, 3, 40)
    _eq(RK.walk_counts(ref.src_idx, ref.col_idx, start, 5, 40),
        K.walk_counts(g.src_idx, g.col_idx, start, 5, 40))


def test_two_hop_matches_engine():
    """The standalone count equals the engine's on the same graph."""
    g = CypherSession.cuda(device="cpu").create_graph_from_create_query(
        "CREATE (a:P {i:1})-[:R]->(b:P {i:2})-[:R]->(c:P {i:3}), (a)-[:R]->(c), (c)-[:R]->(a)"
    )
    engine = g.cypher("MATCH (x)-[:R]->(y)-[:R]->(z) RETURN count(*) AS c").records.collect()
    csr = K.CsrGraph.build(np.array([1, 2, 3], np.int64), np.array([1, 2, 1, 3], np.int64),
                           np.array([2, 3, 3, 1], np.int64), device="cpu")
    assert engine[0]["c"] == int(K.two_hop_count(csr.row_ptr, csr.col_idx)) == 5
