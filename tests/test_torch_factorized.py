"""The factorized tier (``backend/cuda/factorized.py``): the port against
the JAX package, on the CPU.

* The query corpus of ``tests/test_factorized.py`` on its CREATE graph:
  the port under ``TPU_CYPHER_FACTORIZE=force`` is bag-identical to the
  port under ``off``, to the reference's ``CypherSession.tpu()`` under
  ``force`` and to the ``local()`` oracle (ORDER BY queries compared row
  for row); under ``force`` most queries note a factorized materialize.
* Laziness on the fan graph (K sources -> 1 hub -> M targets, K*M flat
  2-hop rows from K+M edges): the result is a ``FactorizedTable``,
  ``collect`` is repeatable, ``iter_chunks`` equals ``collect``, the span
  notes give (flat rows, lanes, runs), and no aggregate flattens the K*M
  rows.
* The run programs (``jit_ops.runs_weights``, ``factorized.decode_lanes``
  with ``jit_ops.run_positions``) against the reference's
  ``_runs_weights`` and ``_decode_runs`` on seeded inputs with zero-count
  lanes and up to three levels, whole and chunk by chunk; and
  ``parallel.agg.weighted_segment_partials`` against the reference's,
  over int and float data with null masks at k = 1, 256 and 300.
* Admission: under ``auto`` with a memory budget between the fan's lanes
  and its flat rows the expand routes factorized, where ``off`` raises
  ``AdmissionRejected``.

Both engines' ``FACTORIZE`` settings are reset after each test.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_cypher as R
from tpu_cypher.backend.tpu import factorized as RF
from tpu_cypher.parallel import agg as RAGG
from tpu_cypher.utils import config as RCFG

import test_bucketing as TB
import test_factorized as RFT

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as ERR
from tpu_cypher_torch.backend.cuda import jit_ops as J
from tpu_cypher_torch.backend.cuda.factorized import FactorizedTable, decode_lanes
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.parallel.agg import weighted_segment_partials
from tpu_cypher_torch.utils import config as PCFG

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset():
    PD.reset()
    yield
    for cfg in (RCFG, PCFG):
        cfg.FACTORIZE.reset()
        cfg.MEM_BUDGET.reset()
    PD.reset()


def _rows(g, q):
    return [tuple(r.items()) for r in g.cypher(q).records.collect()]


def _engaged(result) -> bool:
    return any("factorized" in s.attrs for s in result.profile().trace.spans())


# ---------------------------------------------------------------------------
# the corpus of tests/test_factorized.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus_graphs():
    create = TB._create_query()
    return (
        R.CypherSession.tpu().create_graph_from_create_query(create),
        R.CypherSession.local().create_graph_from_create_query(create),
        CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
    )


@pytest.mark.parametrize("query", RFT.CORPUS)
def test_corpus_identical_across_engines(corpus_graphs, query):
    ref, local, port = corpus_graphs
    PCFG.FACTORIZE.set("off")
    flat = port.cypher(query)
    want = [tuple(r.items()) for r in flat.records.collect()]
    assert not _engaged(flat), "off must keep the route shut"
    PCFG.FACTORIZE.set("force")
    RCFG.FACTORIZE.set("force")
    res = port.cypher(query)
    got = [tuple(r.items()) for r in res.records.collect()]
    others = (_rows(ref, query), _rows(local, query))
    if query in RFT.ORDERED:  # the sort itself is under test
        assert got == want and all(got == o for o in others), query
    else:
        assert Counter(got) == Counter(want), query
        assert all(Counter(got) == Counter(o) for o in others), query
    log = res.execution_log
    assert len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"], log
    for name, c in PD.use_counts().items():
        assert c["fallback"] == 0 and c["kernel"] == 0, (name, c)


def test_corpus_mostly_factorized_under_force(corpus_graphs):
    _, _, port = corpus_graphs
    PCFG.FACTORIZE.set("force")
    engaged = sum(_engaged(port.cypher(q)) for q in RFT.CORPUS)
    assert engaged >= len(RFT.CORPUS) // 2, f"only {engaged}/{len(RFT.CORPUS)} engaged"


# ---------------------------------------------------------------------------
# the fan graph: laziness, span notes, aggregates on the compressed form
# ---------------------------------------------------------------------------


def _fan(k, m):
    PCFG.FACTORIZE.set("force")
    return CypherSession.cuda(device="cpu").create_graph_from_create_query(
        RFT._fan_create(k, m)
    )


def test_fan_result_is_factorized_and_lazy():
    k = m = 12
    recs = _fan(k, m).cypher(RFT.FAN_QUERY).records
    assert isinstance(recs.table, FactorizedTable)
    assert recs.size == k * m
    first = recs.collect()
    assert sorted((r["x"], r["y"]) for r in first) == RFT._fan_rows(k, m)
    assert recs.collect() == first  # decompression is repeatable
    chunks = list(recs.iter_chunks(31))
    assert all(len(c) <= 31 for c in chunks) and len(chunks) == -(-k * m // 31)
    assert [r for c in chunks for r in c] == first
    assert PD.use_counts()["expand_rows"]["plain"] > 0  # the decode's lane search


def test_fan_span_notes_give_the_compressed_shape():
    k = m = 40
    res = _fan(k, m).cypher(RFT.FAN_QUERY)
    res.records.collect()
    notes = [s.attrs["factorized"] for s in res.profile().trace.spans()
             if "factorized" in s.attrs]
    assert notes and all(set(n) == {"true_rows", "padded_rows", "run_count"} for n in notes)
    assert {n["true_rows"] for n in notes} == {k, k * m}
    big = next(n for n in notes if n["true_rows"] == k * m)
    assert big["run_count"] == big["padded_rows"] == k


@pytest.mark.parametrize("tail,want", [
    ("RETURN count(*) AS v", 24 * 24),
    ("RETURN sum(a.id) AS v", 24 * sum(range(24))),
    ("RETURN avg(a.id) AS v", sum(range(24)) / 24),
    ("RETURN count(DISTINCT a.id) AS v", 24),
    ("RETURN min(a.id) AS v", 0),
    ("RETURN a.id % 5 AS g, count(*) AS v ORDER BY g", None),
])
def test_fan_aggregates_never_flatten_the_result(monkeypatch, tail, want):
    """count/sum/avg/DISTINCT/min run on the compressed form: the only
    flattens are the small prefix feeding the second hop, never K*M."""
    k = m = 24
    g = _fan(k, m)
    flattened = []
    orig = FactorizedTable.to_flat_table

    def spy(self):
        flattened.append(self._nrows)
        return orig(self)

    monkeypatch.setattr(FactorizedTable, "to_flat_table", spy)
    rows = g.cypher("MATCH (a:S)-[:R1]->(h)-[:R2]->(b) " + tail).records.collect()
    if want is None:
        want = [{"g": r, "v": m * len(range(r, k, 5))} for r in range(5)]
        assert [dict(r) for r in rows] == want
    else:
        assert rows[0]["v"] == want
    assert all(n < k * m for n in flattened), flattened


def test_auto_with_budget_routes_factorized_where_off_rejects():
    """The fan's second hop is 64 lanes (1 KiB of run bounds) and 4,096
    flat rows (172 KiB at the expand's 42 bytes a row): a 64 KiB budget
    sends ``auto`` to the factorized route and rejects ``off``."""
    k = m = 64
    g = _fan(k, m)
    PCFG.MEM_BUDGET.set(64 << 10)
    PCFG.FACTORIZE.set("auto")
    res = g.cypher(RFT.FAN_QUERY)
    assert isinstance(res.records.table, FactorizedTable) and _engaged(res)
    assert sorted((r["x"], r["y"]) for r in res.records.collect()) == RFT._fan_rows(k, m)
    PCFG.FACTORIZE.set("off")
    with pytest.raises(ERR.AdmissionRejected):
        g.cypher(RFT.FAN_QUERY).records.collect()


# ---------------------------------------------------------------------------
# the run programs against the reference's
# ---------------------------------------------------------------------------


def _levels(seed, nlanes, nlevels):
    rng = np.random.default_rng(seed)
    cnts = [rng.integers(0, 4, nlanes) for _ in range(nlevels)]
    for c in cnts:
        c[rng.random(nlanes) < 0.3] = 0  # zero-count lanes
    los = [rng.integers(0, 1000, nlanes) for _ in range(nlevels)]
    return los, cnts


@pytest.mark.parametrize("nlevels", [1, 2, 3])
@pytest.mark.parametrize("chunk", [None, 7])
def test_run_programs_match_reference(nlevels, chunk):
    """Weights, cumsum and total equal the reference's; the decode of
    every flat row (whole, or in chunks starting mid-lane) gives the
    reference's lane and per-level run positions."""
    nlanes = 40
    los, cnts = _levels(nlevels * 10 + (chunk or 0), nlanes, nlevels)
    rw, rW, rtot = RF._runs_weights(tuple(jnp.asarray(c) for c in cnts), nlanes)
    pc = tuple(torch.from_numpy(c) for c in cnts)
    pl = tuple(torch.from_numpy(x) for x in los)
    w, W, tot = J.runs_weights(pc, nlanes)
    assert np.array_equal(w.numpy(), np.asarray(rw))
    assert np.array_equal(W.numpy(), np.asarray(rW)) and int(tot) == int(rtot) > 0
    total = int(tot)
    step = chunk or total
    for lo in range(0, total, step):
        hi = min(lo + step, total)
        ri, rpos, rlive = RF._decode_runs(
            rW, rw, tuple(jnp.asarray(x) for x in los), tuple(jnp.asarray(c) for c in cnts),
            np.int64(lo), np.int64(hi), hi - lo,
        )
        assert np.asarray(rlive).all()
        i, inner = decode_lanes(W, w, lo, hi)
        pos = J.run_positions(i, inner, pl, pc)
        assert np.array_equal(i.numpy(), np.asarray(ri))
        for p, rp in zip(pos, rpos):
            assert np.array_equal(p.numpy(), np.asarray(rp))


@pytest.mark.parametrize("weights,lo,n", [
    ([1 << 20], (1 << 19) + 3, 1000),  # one lane 1,000x the chunk, mid-lane
    ([1 << 40], (1 << 39) + 5, 1000),  # a lane past int32, deep inside it
    ([(1 << 33) + 4, 0, 5, 1 << 33], (1 << 33) + 1, 1000),  # a tail, a gap, a lane, a head
])
def test_decode_of_a_heavy_lane_spans_only_the_chunk(monkeypatch, weights, lo, n):
    """A chunk that starts deep inside a lane far heavier than the chunk
    decodes to that lane's remainders, and everything handed to the
    ``expand_rows`` gate is the size of the chunk, in int32, whatever the
    lane weighs: the stream holds one chunk of state."""
    from tpu_cypher_torch.backend.cuda import hopper

    seen = []
    inner_fn = hopper.expand_materialize_counted

    def spy(rp, ci, eo, pos, deg, nvalid, **kw):
        seen.append((rp.dtype, ci.dtype, int(rp.shape[0]), int(ci.shape[0]), kw["size"]))
        return inner_fn(rp, ci, eo, pos, deg, nvalid, **kw)

    monkeypatch.setattr(hopper, "expand_materialize_counted", spy)
    w = torch.tensor(weights, dtype=torch.int64)
    W = torch.cumsum(w, 0)
    i, inner = decode_lanes(W, w, lo, lo + n)
    starts = np.concatenate([[0], np.cumsum(weights)[:-1]])
    rows = np.arange(lo, lo + n)
    want_lane = np.searchsorted(np.cumsum(weights), rows, side="right")
    assert np.array_equal(i.numpy(), want_lane)
    assert np.array_equal(inner.numpy(), rows - starts[want_lane])
    ((rp_t, ci_t, nl, nci, size),) = seen
    assert rp_t == ci_t == torch.int32
    assert nci == size == n and nl <= n


def test_csr_run_bounds_match_reference():
    import tpu_cypher.backend.tpu.expand_op as REO

    rng = np.random.default_rng(5)
    rp = np.concatenate([[0], np.cumsum(rng.integers(0, 5, 30))]).astype(np.int32)
    pos = rng.integers(0, 30, 50)
    present = rng.random(50) < 0.8
    got = J.csr_run_bounds(torch.from_numpy(rp), torch.from_numpy(pos),
                           torch.from_numpy(present), 45)
    want = REO._csr_run_bounds(jnp.asarray(rp), jnp.asarray(pos), jnp.asarray(present),
                               np.int64(45))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", [1, 256, 300])
@pytest.mark.parametrize("dtype", ["int", "float", None])
@pytest.mark.parametrize("masked", [False, True])
def test_weighted_partials_match_reference(k, dtype, masked):
    rng = np.random.default_rng(k + (7 if masked else 0))
    n = 2000
    weight = rng.integers(0, 6, n).astype(np.int64)
    seg = rng.integers(0, k, n).astype(np.int64)
    valid = rng.random(n) < 0.7 if masked else None
    data = {
        "int": rng.integers(-1000, 1000, n).astype(np.int64),
        "float": rng.standard_normal(n),
        None: None,
    }[dtype]

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    got = weighted_segment_partials(t(data), t(valid), t(weight), t(seg), k)
    want = RAGG.weighted_segment_partials(j(data), j(valid), j(weight), j(seg), k)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        elif dtype == "float" and a.is_floating_point():
            # float sums reorder between engines: the reference's own
            # segment_sum tolerance
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-9)
        else:
            assert np.array_equal(a.numpy(), np.asarray(b))
    if k == 1:  # the port's global form: no group ids
        glob = weighted_segment_partials(t(data), t(valid), t(weight), None, 1)
        for a, b in zip(glob, got):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.allclose(a.to(torch.float64), b.to(torch.float64))
