"""Transactional graph mutation on the port (``tpu_cypher_torch/storage/``,
``relational/mutate.py`` on ``CudaTable``) against the reference's, the
counterpart of ``tests/test_mutation.py``.

The same write scripts run on the reference's store (``CypherSession.tpu()``,
JAX on the CPU) and the port's (``CypherSession.cuda(device="cpu")``), each
seeded from the same CREATE text: write counters, final element stores,
fingerprints and versions must be equal, reads bag-identical, the WAL files
byte-identical, replay equal to a rebuild, and a faulted commit must roll
back the same way. Beyond the reference's tests: reads on a delta snapshot
run on the device gates (``CsrExpandOp``, and ``JoinOp`` through
``join_probe``); a compacted base scans equal to a store rebuilt from scratch; and concurrent
served reads and writes leave every acknowledged write readable.
"""

import asyncio
import json
import os
import random
from collections import Counter
from typing import NamedTuple

import pytest
import torch

import tpu_cypher as R
import tpu_cypher.serve as RS
import tpu_cypher.storage as RST
from tpu_cypher import errors as RE
from tpu_cypher.backend.tpu import bucketing as RB
from tpu_cypher.runtime import faults as RF
from tpu_cypher.utils import config as RC

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch import errors as PE
import tpu_cypher_torch.serve as PS
import tpu_cypher_torch.storage as PST
from tpu_cypher_torch.backend.cuda import bucketing as PB
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.runtime import faults as PF
from tpu_cypher_torch.utils import config as PC

torch.set_num_threads(1)

SEED_Q = (
    "CREATE (a:P {k: 1, name: 'a'}), (b:P {k: 2, name: 'b'}), "
    "(c:Q {k: 3}), (a)-[:KNOWS {w: 5}]->(b), (b)-[:KNOWS {w: 7}]->(c)"
)


class Engine(NamedTuple):
    name: str
    session: object
    storage: object
    errors: object
    faults: object
    config: object
    serve: object


@pytest.fixture(scope="module")
def engines():
    return (
        Engine("ref", R.CypherSession.tpu(), RST, RE, RF, RC, RS),
        Engine("port", CypherSession.cuda(device="cpu"), PST, PE, PF, PC, PS),
    )


@pytest.fixture(autouse=True)
def _clean_faults():
    RF.set_spec(None)
    PF.set_spec(None)
    yield
    RF.set_spec(None)
    PF.set_spec(None)


def agree(engines, fn):
    got = {e.name: fn(e) for e in engines}
    assert got["port"] == got["ref"], got
    return got["port"]


def _mk(e, wal_path=None, seed=SEED_Q):
    return e.storage.mutable_graph_from_create_query(
        e.session, seed, name="m", wal_path=wal_path
    )


def _rows(e, pg, query, **params):
    result = e.session.cypher(query, params or None, graph=pg)
    return [dict(r) for r in result.records.collect()]


def _bag(rows):
    return Counter(json.dumps(r, sort_keys=True) for r in rows)


def _state(m):
    nodes = {
        i: (tuple(sorted(n.labels)), dict(sorted(n.properties.items())))
        for i, n in m._nodes.items()
    }
    rels = {
        i: (r.start, r.end, r.rel_type, dict(sorted(r.properties.items())))
        for i, r in m._rels.items()
    }
    return nodes, rels, m.fingerprint(), m._version


# ---------------------------------------------------------------------------
# the write surface
# ---------------------------------------------------------------------------


def test_create_nodes_and_rels(engines):
    def run(e):
        pg = _mk(e)
        w1 = e.session.cypher("CREATE (:W {k: 10}), (:W {k: 11})", graph=pg)
        r1 = _rows(e, pg, "MATCH (n:W) RETURN n.k AS k ORDER BY k")
        w2 = e.session.cypher(
            "MATCH (a:P {k: 1}), (b:Q) CREATE (a)-[:LIKES {w: 9}]->(b)", graph=pg)
        r2 = _rows(e, pg, "MATCH (a)-[e:LIKES]->(b) RETURN a.k AS ak, e.w AS w, b.k AS bk")
        return w1.write_stats, r1, w2.write_stats, r2, _state(pg._graph)

    w1, r1, w2, r2, _ = agree(engines, run)
    assert w1["nodes_created"] == 2 and w1["contains_updates"] is True
    assert r1 == [{"k": 10}, {"k": 11}]
    assert w2["relationships_created"] == 1
    assert r2 == [{"ak": 1, "w": 9, "bk": 3}]


def test_set_property_label_and_map(engines):
    def run(e):
        pg = _mk(e)
        w = e.session.cypher("MATCH (n:P {k: 1}) SET n.k = n.k + 100, n:Promoted",
                             graph=pg)
        r1 = _rows(e, pg, "MATCH (n:Promoted) RETURN n.k AS k, n.name AS name")
        e.session.cypher("MATCH (n:Promoted) SET n = {k: 7}, n.gone = null", graph=pg)
        r2 = _rows(e, pg, "MATCH (n:Promoted) RETURN n.k AS k, n.name AS name")
        return w.write_stats, r1, r2, _state(pg._graph)

    w, r1, r2, _ = agree(engines, run)
    assert w["properties_set"] == 1 and w["labels_added"] == 1
    assert r1 == [{"k": 101, "name": "a"}] and r2 == [{"k": 7, "name": None}]


def test_merge_node_and_rel(engines):
    def run(e):
        pg = _mk(e)
        merge = ("MERGE (n:P {k: %d}) ON MATCH SET n.seen = true "
                 "ON CREATE SET n.fresh = true")
        stats = [e.session.cypher(merge % 1, graph=pg).write_stats,
                 e.session.cypher(merge % 99, graph=pg).write_stats]
        rows = _rows(e, pg, "MATCH (n:P) RETURN n.k AS k, n.seen AS s, "
                     "n.fresh AS f ORDER BY k")
        q = "MATCH (a:P {k: 1}), (b:P {k: 2}) MERGE (a)-[e:KNOWS {w: 5}]->(b)"
        q2 = "MATCH (a:P {k: 1}), (b:P {k: 2}) MERGE (a)-[e:NEW {w: 1}]->(b)"
        stats += [e.session.cypher(q, graph=pg).write_stats,
                  e.session.cypher(q2, graph=pg).write_stats,
                  e.session.cypher(q2, graph=pg).write_stats]
        return stats, rows, _state(pg._graph)

    stats, rows, _ = agree(engines, run)
    assert stats[0]["merges_matched"] == 1 and stats[0]["nodes_created"] == 0
    assert stats[1]["nodes_created"] == 1
    assert rows == [{"k": 1, "s": True, "f": None}, {"k": 2, "s": None, "f": None},
                    {"k": 99, "s": None, "f": True}]
    assert stats[2]["merges_matched"] == 1
    assert stats[3]["relationships_created"] == 1 and stats[4]["merges_matched"] == 1


def test_delete_and_detach(engines):
    def run(e):
        pg = _mk(e)
        with pytest.raises(e.errors.MutationError):
            e.session.cypher("MATCH (n:P {k: 2}) DELETE n", graph=pg)
        w = e.session.cypher("MATCH (n:P {k: 2}) DETACH DELETE n", graph=pg)
        return (w.write_stats, _rows(e, pg, "MATCH (n) RETURN count(*) AS c"),
                _rows(e, pg, "MATCH ()-[e]->() RETURN count(*) AS c"),
                _state(pg._graph))

    w, nodes, rels, _ = agree(engines, run)
    assert w["nodes_deleted"] == 1 and w["relationships_deleted"] == 2
    assert nodes == [{"c": 2}] and rels == [{"c": 0}]


def test_unwind_prefix_and_parameters(engines):
    def run(e):
        pg = _mk(e)
        w = e.session.cypher("UNWIND $xs AS x CREATE (:U {v: x * 2})",
                             {"xs": [1, 2, 3]}, graph=pg)
        return w.write_stats, _rows(e, pg, "MATCH (n:U) RETURN n.v AS v ORDER BY v")

    w, rows = agree(engines, run)
    assert w["nodes_created"] == 3 and rows == [{"v": 2}, {"v": 4}, {"v": 6}]


def test_local_backend_roundtrip():
    """The host-oracle backends of both packages agree on a write script."""

    def run(session, storage):
        pg = storage.mutable_graph_from_create_query(session, SEED_Q, name="m")
        session.cypher("MATCH (n:P {k: 1}) SET n.k = 50", graph=pg)
        session.cypher("MERGE (n:W {k: 1})", graph=pg)
        session.cypher("MATCH (n:Q) DETACH DELETE n", graph=pg)
        rows = [dict(r) for r in session.cypher(
            "MATCH (n) RETURN n.k AS k ORDER BY k", graph=pg).records.collect()]
        return rows, _state(pg._graph)

    ref = run(R.CypherSession.local(), RST)
    port = run(CypherSession.local(), PST)
    assert port == ref and port[0] == [{"k": 1}, {"k": 2}, {"k": 50}]


def test_write_query_requires_mutable_graph(engines):
    def run(e):
        frozen = e.session.create_graph_from_create_query("CREATE (:P {k: 1})")
        with pytest.raises(e.errors.MutationError) as info:
            e.session.cypher("CREATE (:W)", graph=frozen)
        return type(info.value).__name__

    assert agree(engines, run) == "MutationError"


def test_failed_write_commits_nothing(engines):
    def run(e):
        pg = _mk(e)
        before = pg._graph._version
        with pytest.raises(e.errors.MutationError):
            e.session.cypher("MATCH (n:P) SET n.k = $missing", graph=pg)
        return pg._graph._version == before, _rows(
            e, pg, "MATCH (n:P) RETURN n.k AS k ORDER BY k")

    assert agree(engines, run) == (True, [{"k": 1}, {"k": 2}])


# ---------------------------------------------------------------------------
# snapshot isolation and the snapshot's read plan
# ---------------------------------------------------------------------------


def test_pinned_reader_never_moves(engines):
    def run(e):
        pg = _mk(e)
        pinned = e.session.cypher("MATCH (n) RETURN count(*) AS c", graph=pg)
        e.session.cypher("CREATE (:Z), (:Z)", graph=pg)
        fresh = e.session.cypher("MATCH (n) RETURN count(*) AS c", graph=pg)
        return ([dict(r) for r in pinned.records.collect()],
                [dict(r) for r in fresh.records.collect()])

    assert agree(engines, run) == ([{"c": 3}], [{"c": 5}])


def test_snapshot_object_stable_until_write(engines):
    def run(e):
        pg = _mk(e)
        m = pg._graph
        same = m.snapshot() is m.snapshot()
        s0 = m.snapshot()
        e.session.cypher("CREATE (:Z)", graph=pg)
        return same, m.snapshot() is not s0, type(m.snapshot()).__name__

    assert agree(engines, run) == (True, True, "SnapshotGraph")


def test_snapshot_reads_run_on_the_device_gates(engines):
    """Reads on a delta snapshot scan the union of its members (keep-first
    dedup on id, then the ``__dead IS NULL`` filter): a hop plans
    ``CsrExpandOp`` over the snapshot's scans (``expand_rows``) and a value
    join plans ``JoinOp`` through the ``join_probe`` gate (tier ``plain``
    on the CPU, no fallback); rows equal the reference's."""
    hop = ("MATCH (a:P)-[e:KNOWS]->(b) RETURN a.k AS a, e.w AS w, b.k AS b, "
           "b.name AS bn")
    join = "MATCH (a:P), (b:W) WHERE a.k = b.k RETURN a.name AS a, b.tag AS t"

    def run(e):
        pg = _mk(e)
        e.session.cypher("MATCH (b:P {k: 2}) SET b.name = 'bee'", graph=pg)
        e.session.cypher("MATCH (a:P {k: 1}), (c:Q) CREATE (a)-[:KNOWS {w: 1}]->(c)",
                         graph=pg)
        e.session.cypher("CREATE (:W {k: 2, tag: 'x'}), (:W {k: 5, tag: 'y'})",
                         graph=pg)
        out = []
        for q, op, kernel in ((hop, "CsrExpandOp", "expand_rows"),
                              (join, "JoinOp", "join_probe")):
            PD.reset()
            result = e.session.cypher(q, graph=pg)
            rows = _bag(dict(r) for r in result.records.collect())
            counts = PD.use_counts()[kernel]
            out.append((rows, type(pg._graph.snapshot()).__name__))
            if e.name == "port":
                assert op in result.plans, result.plans
                assert counts["plain"] >= 1 and counts["fallback"] == 0, counts
        return out

    (hop_rows, snap), (join_rows, _) = agree(engines, run)
    assert snap == "SnapshotGraph" and sum(hop_rows.values()) == 3
    assert join_rows == _bag([{"a": "bee", "t": "x"}])


# ---------------------------------------------------------------------------
# WAL durability + recovery
# ---------------------------------------------------------------------------

SCRIPT = (
    ("CREATE (:W {k: 10, tag: 'w'})", {}),
    ("MATCH (a:P {k: 1}), (w:W {k: 10}) CREATE (a)-[:OWNS {n: 1}]->(w)", {}),
    ("MATCH (n:P {k: 1}) SET n.k = 42, n:Promoted", {}),
    ("MERGE (n:W {k: $k}) ON CREATE SET n.fresh = true", {"k": 11}),
    ("MATCH (n:Q) DETACH DELETE n", {}),
    ("UNWIND $xs AS x CREATE (:U {v: x})", {"xs": [1, 2]}),
)


def _run_script(e, pg):
    for q, params in SCRIPT:
        e.session.cypher(q, params or None, graph=pg)


def test_wal_replay_byte_identical_vs_rebuild(engines, tmp_path):
    """Replay reproduces the committed state; a re-executed script agrees;
    and the port's WAL file is byte-identical to the reference's."""

    def run(e):
        wal_path = str(tmp_path / f"{e.name}.wal")
        pg = _mk(e, wal_path=wal_path)
        _run_script(e, pg)
        want = _state(pg._graph)
        recovered = _mk(e, wal_path=wal_path)
        scratch = _mk(e)
        _run_script(e, scratch)
        with open(wal_path, "rb") as f:
            wal_bytes = f.read()
        return (want, recovered._graph.replayed_batches, _state(recovered._graph),
                _state(scratch._graph)[:3], wal_bytes)

    want, replayed, recovered, scratch, wal_bytes = agree(engines, run)
    assert replayed == len(SCRIPT) and recovered == want and scratch == want[:3]
    assert wal_bytes.count(b"\n") == len(SCRIPT)


def test_wal_torn_tail_dropped(engines, tmp_path):
    def run(e):
        wal_path = str(tmp_path / f"torn-{e.name}.wal")
        pg = _mk(e, wal_path=wal_path)
        e.session.cypher("CREATE (:W {k: 1})", graph=pg)
        e.session.cypher("CREATE (:W {k: 2})", graph=pg)
        committed = _state(pg._graph)
        with open(wal_path, "ab") as f:
            f.write(b'deadbeef {"lsn": 3, "batch"')
        recovered = _mk(e, wal_path=wal_path)
        return recovered._graph.replayed_batches, _state(recovered._graph) == committed

    assert agree(engines, run) == (2, True)


def test_wal_sync_modes_roundtrip(engines, tmp_path):
    rec = {"lsn": 1, "batch": {"nc": [[7, ["W"], {"k": 1}]]}}

    def run(e):
        out = []
        for sync in ("fsync", "flush", "off"):
            path = str(tmp_path / f"{e.name}-{sync}.wal")
            wal = e.storage.WriteAheadLog(path, sync=sync)
            off = wal.append(rec)
            wal.close()
            with open(path, "rb") as f:
                raw = f.read()
            out.append((off, list(e.storage.WriteAheadLog(path).replay()), raw))
        return out

    for off, replayed, _ in agree(engines, run):
        assert off == 0 and replayed == [rec]


def test_fault_wal_append_nothing_durable(engines, tmp_path):
    def run(e):
        wal_path = str(tmp_path / f"apf-{e.name}.wal")
        pg = _mk(e, wal_path=wal_path)
        e.session.cypher("CREATE (:W {k: 1})", graph=pg)
        size = os.path.getsize(wal_path)
        e.faults.set_spec("lost@wal_append:1")
        with pytest.raises(e.errors.DeviceLost):  # typed, never a raw InjectedFault
            e.session.cypher("CREATE (:W {k: 2})", graph=pg)
        e.faults.set_spec(None)
        return os.path.getsize(wal_path) == size, _rows(
            e, pg, "MATCH (n:W) RETURN count(*) AS c")

    assert agree(engines, run) == (True, [{"c": 1}])


def test_fault_delta_apply_rolls_wal_back(engines, tmp_path):
    def run(e):
        wal_path = str(tmp_path / f"dap-{e.name}.wal")
        pg = _mk(e, wal_path=wal_path)
        e.session.cypher("CREATE (:W {k: 1})", graph=pg)
        size = os.path.getsize(wal_path)
        version = pg._graph._version
        e.faults.set_spec("lost@delta_apply:1")
        with pytest.raises(e.errors.DeviceLost):
            e.session.cypher("CREATE (:W {k: 2})", graph=pg)
        e.faults.set_spec(None)
        recovered = _mk(e, wal_path=wal_path)
        return (os.path.getsize(wal_path) == size, pg._graph._version == version,
                recovered._graph.replayed_batches)

    assert agree(engines, run) == (True, True, 1)


def test_fault_compact_defers_not_fails(engines):
    def run(e):
        e.config.COMPACT_DELTA_MAX.set(1)
        try:
            pg = _mk(e)
            e.faults.set_spec("oom@compact:1")
            w = e.session.cypher("CREATE (:W {k: 1})", graph=pg)
            e.faults.set_spec(None)
            m = pg._graph
            deferred = m.deferred_compactions
            before = m.compactions
            e.session.cypher("CREATE (:W {k: 2})", graph=pg)
            return (w.write_stats["nodes_created"], deferred,
                    m.compactions > before, m.delta_rows())
        finally:
            e.config.COMPACT_DELTA_MAX.reset()
            e.faults.set_spec(None)

    assert agree(engines, run) == (1, 1, True, 0)


# ---------------------------------------------------------------------------
# fingerprints + compaction
# ---------------------------------------------------------------------------


def test_fingerprint_advances_on_cardinality_neutral_set(engines):
    def run(e):
        pg = _mk(e)
        fp0 = pg._graph.fingerprint()
        e.session.cypher("MATCH (n:P {k: 1}) SET n.name = 'renamed'", graph=pg)
        return fp0, pg._graph.fingerprint()

    fp0, fp1 = agree(engines, run)
    assert fp0 != fp1


def test_compaction_returns_to_base_only_scan(engines):
    def run(e):
        e.config.COMPACT_DELTA_MAX.set(4)
        try:
            pg = _mk(e)
            m = pg._graph
            e.session.cypher("CREATE (:W {k: 1})", graph=pg)
            overlay = type(m.snapshot()).__name__
            for i in range(2, 9):
                e.session.cypher(f"CREATE (:W {{k: {i}}})", graph=pg)
            return (overlay, m.compactions, m.delta_rows(),
                    type(m.snapshot()).__name__,
                    _rows(e, pg, "MATCH (n:W) RETURN count(*) AS c"))
        finally:
            e.config.COMPACT_DELTA_MAX.reset()

    overlay, compactions, delta, after, rows = agree(engines, run)
    assert overlay == "SnapshotGraph" and after != "SnapshotGraph"
    assert (compactions, delta, rows) == (2, 0, [{"c": 8}])


def _scans(graph):
    """Every element table of a scan graph, decoded: {mapping: columns}."""
    out = {}
    for et in graph.scans:
        t = et.table
        out[repr(et.mapping)] = {c: t.column_values(c) for c in sorted(t.physical_columns)}
    return out


def test_compacted_base_scans_equal_a_rebuild(engines):
    """A base folded by compaction (``MutableGraph._compact_into_base``)
    scans exactly like a store built from scratch from the final
    elements, in both packages, and the two packages' bases agree."""

    def run(e):
        e.config.COMPACT_DELTA_MAX.set(3)
        try:
            pg = _mk(e)
            _run_script(e, pg)
            m = pg._graph
            compactions = m.compactions
            m._compact_into_base()
            m._snapshot = None
            nodes = [m._nodes[i] for i in sorted(m._nodes)]
            rels = [m._rels[i] for i in sorted(m._rels)]
            rebuilt = e.storage.MutableGraph(e.session, nodes, rels, name="r")
            base = _scans(m.snapshot())
            assert base == _scans(rebuilt.snapshot())
            read = _bag(_rows(e, pg, "MATCH (a)-[r]->(b) RETURN labels(a) AS la, "
                              "type(r) AS t, b.k AS k, b.v AS v"))
            return compactions, base, read
        finally:
            e.config.COMPACT_DELTA_MAX.reset()

    compactions, base, read = agree(engines, run)
    assert compactions >= 1 and base and sum(read.values()) == 2


def test_reads_agree_across_delta_growth_and_compaction(engines):
    """The counterpart of the reference's zero-recompile pin: under the
    ``pow2`` lattice (delta tables padded with dead rows) reads stay
    bag-identical to the reference's through delta growth and two
    compactions, and the port builds no kernel while doing it."""

    def run(e):
        e.config.COMPACT_DELTA_MAX.set(6)
        mode = RB.force_mode("pow2") if e.name == "ref" else None
        if mode is not None:
            mode.__enter__()
        else:
            PC.BUCKET_MODE.set("pow2")
        try:
            pg = _mk(e)
            m = pg._graph
            q = "MATCH (n:P) RETURN count(*) AS c"
            q2 = "MATCH (n) RETURN labels(n) AS l, n.k AS k"
            snap = PB.compile_snapshot()
            reads = []
            for i in range(10):
                e.session.cypher(f"CREATE (:W {{k: {i}}})", graph=pg)
                reads.append((_rows(e, pg, q), _bag(_rows(e, pg, q2))))
            builds = PB.compile_delta(snap)["compiles"] if e.name == "port" else 0
            return reads, m.compactions, builds
        finally:
            e.config.COMPACT_DELTA_MAX.reset()
            if mode is not None:
                mode.__exit__(None, None, None)
            else:
                PC.BUCKET_MODE.reset()

    reads, compactions, builds = agree(engines, run)
    assert compactions >= 1 and builds == 0
    assert reads[-1][0] == [{"c": 2}] and sum(reads[-1][1].values()) == 13


# ---------------------------------------------------------------------------
# serving tier: write payloads + result-cache invalidation
# ---------------------------------------------------------------------------


async def _client(host, port, lines):
    reader, writer = await asyncio.open_connection(host, port)
    for line in lines:
        writer.write((json.dumps(line) + "\n").encode())
    await writer.drain()
    want = sum(1 for l in lines if l.get("op") == "submit")
    out, done = [], 0
    while done < want:
        raw = await asyncio.wait_for(reader.readline(), 30)
        if not raw:
            break
        msg = json.loads(raw)
        out.append(msg)
        if msg.get("type") in ("done", "error", "cancelled"):
            done += 1
    writer.close()
    return out


def _done(msgs, qid):
    return next(m for m in msgs if m["type"] == "done" and m["id"] == qid)


def _rows_of(msgs, qid):
    rows = []
    for m in msgs:
        if m["type"] == "rows" and m["id"] == qid:
            rows.extend(m["rows"])
    return rows


def test_serve_write_invalidates_result_cache(engines):
    read_q = "MATCH (n:P) RETURN count(*) AS c"

    def run(e):
        pg = _mk(e)

        async def go():
            srv = e.serve.QueryServer(e.session, port=0)
            srv.register_graph("g", pg)
            async with srv:
                out = []
                for qid, q in (("r1", read_q), ("r2", read_q),
                               ("w1", "CREATE (:P {k: 9})"), ("r3", read_q)):
                    out.append(await _client(srv.host, srv.port, [
                        {"op": "submit", "id": qid, "graph": "g", "query": q}]))
                return out

        first, warm, write, after = asyncio.run(go())
        return (_done(first, "r1")["cached"], _done(warm, "r2")["cached"],
                _rows_of(warm, "r2"), _done(after, "r3")["cached"],
                _rows_of(after, "r3"))

    assert agree(engines, run) == (False, True, [{"c": 2}], False, [{"c": 3}])


def test_serve_write_payload_not_batched_not_cached(engines):
    def run(e):
        pg = _mk(e)

        async def go():
            srv = e.serve.QueryServer(e.session, port=0, batch_window_ms=40)
            srv.register_graph("g", pg)
            async with srv:
                return await _client(srv.host, srv.port, [
                    {"op": "submit", "id": f"w{i}", "graph": "g",
                     "query": "MERGE (n:W {k: 1}) ON MATCH SET n.c = 1"}
                    for i in range(3)
                ])

        dones = [_done(asyncio.run(go()), f"w{i}") for i in range(3)]
        return ([d["batched"] for d in dones], [d["cached"] for d in dones],
                pg._graph.committed_batches >= 1)

    assert agree(engines, run) == ([1, 1, 1], [False] * 3, True)


def test_serve_concurrent_reads_and_writes_read_back(engines, tmp_path):
    """Eight clients at once, reads with one write in ten (CREATE, SET,
    DETACH DELETE), compaction under way: every acknowledged write is read
    back, and the port's final store equals a rebuild from its committed
    writes and the reference's store after the same writes."""
    rng = random.Random(7)
    plan = []
    for c in range(8):
        ops = []
        for i in range(10):
            if i == 4:
                kind = ("create", "set", "delete")[c % 3]
                ops.append(kind)
            else:
                ops.append(rng.choice(["count", "hop"]))
        plan.append(ops)

    def line(c, i, op):
        qid = f"c{c}-{i}"
        tag = 1000 + c
        if op == "create":
            q = f"CREATE (:W {{k: {tag}}})-[:KNOWS {{w: {tag}}}]->(:W {{k: {tag + 100}}})"
        elif op == "set":
            q = f"MATCH (n:P {{k: {1 + c % 2}}}) SET n.mark{c} = {tag}"
        elif op == "delete":
            q = f"MATCH (n:D {{k: {c}}}) DETACH DELETE n"
        elif op == "count":
            q = "MATCH (n) RETURN count(*) AS c"
        else:
            q = "MATCH (a)-[e:KNOWS]->(b) RETURN count(*) AS c"
        return {"op": "submit", "id": qid, "graph": "g", "query": q,
                "tenant": f"t{c}"}

    seed = SEED_Q + ", " + ", ".join(
        f"(:D {{k: {c}}})-[:KNOWS {{w: 0}}]->(:D {{k: {c + 50}}})" for c in range(8))

    def run(e):
        e.config.COMPACT_DELTA_MAX.set(4)
        try:
            wal_path = str(tmp_path / f"served-{e.name}.wal")
            pg = _mk(e, wal_path=wal_path, seed=seed)

            async def go():
                srv = e.serve.QueryServer(e.session, port=0, max_concurrent=4,
                                          batch_window_ms=0)
                srv.register_graph("g", pg)
                async with srv:
                    return await asyncio.gather(*(
                        _client(srv.host, srv.port,
                                [line(c, i, op) for i, op in enumerate(ops)])
                        for c, ops in enumerate(plan)))

            per_client = asyncio.run(go())
            m = pg._graph
            acked = {m2["id"] for msgs in per_client for m2 in msgs
                     if m2["type"] == "done"}
            assert len(acked) == 80, [m2 for msgs in per_client for m2 in msgs
                                       if m2["type"] == "error"]
            readback = []
            for c, ops in enumerate(plan):
                kind = ops[4]
                if kind == "create":
                    got = _rows(e, pg, "MATCH (a:W {k: $k})-[r:KNOWS]->(b:W) "
                                "RETURN r.w AS w, b.k AS b", k=1000 + c)
                    assert got == [{"w": 1000 + c, "b": 1100 + c}]
                elif kind == "set":
                    got = _rows(e, pg, f"MATCH (n:P) WHERE n.mark{c} = $v "
                                "RETURN n.k AS k", v=1000 + c)
                    assert got == [{"k": 1 + c % 2}]
                else:
                    got = _rows(e, pg, "MATCH (n:D {k: $k}) RETURN count(*) AS c", k=c)
                    assert got == [{"c": 0}]
                readback.append(got)
            # a rebuild from the committed writes: the seed, then the WAL
            state = _state(m)
            recovered = _mk(e, wal_path=wal_path, seed=seed)
            assert recovered._graph.replayed_batches == m.committed_batches
            assert _state(recovered._graph) == state
            return (readback, m.compactions >= 1, m.committed_batches,
                    len(state[0]), len(state[1]),
                    _bag(_rows(e, pg, "MATCH (a)-[r]->(b) RETURN a.k AS a, r.w AS w, "
                               "b.k AS b")))
        finally:
            e.config.COMPACT_DELTA_MAX.reset()

    readback, compacted, committed, n_nodes, n_rels, edges = agree(engines, run)
    assert compacted and committed == 8
