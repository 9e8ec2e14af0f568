#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of tpu-cypher on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero and prints no result line):

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` and checks
            that CUDA is available;
2. build  — builds every kernel source in ``tpu_cypher_torch/csrc`` with
            ``nvcc`` (all in parallel) and prints each build's ``ptxas``
            resource line, and the native host tier
            (``tpu_cypher_torch/native/csr_builder.cpp``) with ``g++``; a
            native build that fails fails the run;
3. kernels — calls each kernel's wrapper on the card at the shapes the
            slice's queries give it (``expand_rows``, ``intersect`` and
            ``join_probe``: the very inputs of an extra Q6 and Q11 run,
            captured there), holds the result against the kernel's
            plain PyTorch version on the same inputs (tolerance: exact —
            every output is integral, and float64 outputs are compared bit
            for bit), and times kernel, plain version and one PyTorch
            library call with CUDA events (``expand_rows``: its whole
            kernel tier, at Q5's second hop and Q6's arm 0); then launches
            ``segment_agg``, ``frontier_deg_sum`` and ``expand_rows`` on
            two side streams at once, each answer held to its plain
            version (``intersect`` beside them: its index tables are
            allocated on the launch's stream), and times
            ``join_materialize`` (Q11), torch ops, and the WCOJ
            materialize's decode (Q7, ``decode_lanes`` on the
            ``expand_rows`` gate) against their byte bounds; holds ``segment_agg`` to its plain version at
            Q15's own group ids (k = 256) and at Q47's (the min and max
            of SF10's temporal ``KNOWS.creationDate``, a localdatetime,
            from a hooked Q47 on a temporal graph built for it) and
            times it there; holds
            ``expand_rows`` to its plain version at the chain walk's
            shapes (Q17's final hop, about 197M lanes without orig, and
            Q18's third hop with orig, captured from a run of each) and
            times them, with Q17's final hop whole and its sort; holds
            ``intersect`` (its index kernels, which build a bucket-start
            table and bucket records over the keys, and its search
            kernel) to its plain version
            at Q6's two calls and at edge shapes (a hub, keys all equal,
            one key, queries outside the keys, negative keys over a span
            of 2**64 - 1, runs on bucket starts, one far key), each at
            the real bucket count and at 2 and 16 buckets, and
            ``intersect`` at Q22's two probes (the final
            hop's lanes over the SF10 KNOWS keys, one a orientation) and
            at Q23's, and times it at Q6's arm 0, Q22's first probe and
            Q23's against its bound and a full search's bound; holds the
            optional lane merge (the ``expand_rows``
            kernel tier and its placement) to its plain version at Q25's
            and Q26's frontiers (every lane's row and match flag, every
            matched lane's edge) and times it, and times
            ``into_materialize_counted`` (torch ops) at Q24's first probe
            half; holds ``expand_rows`` to its plain version at Q31's
            explode (the UNWIND of 100,000 collected lists, captured from
            a run of Q31) and times it; holds ``join_probe``'s build
            kernel (a memset and one launch, whose slot order its CASes
            decide) to ``hash_build`` by ``join.table_invariants``, and its
            probe's ``lo``, counts and total bit for bit, at Q11 and eight
            edge cases, and times the build, the probe, the kernel tier
            (CUDA events, and its device operations a call and their time
            from ``torch.profiler``) and the probe at the STR-codes case;
4. slice  — runs the slices' queries through ``CypherSession.cuda()``
            on the LDBC-SNB-shaped graphs (SF1: 10,000 persons, SF10:
            100,000 persons, seed 42): Q1-Q5 on the CSR expand path, Q6-Q8
            (the triangle count, the triangle rows, the 4-clique count) on
            the WCOJ multiway-intersect path, and a triangle count on a
            small seeded graph with self-loops and parallel edges, whose
            uniqueness pairs the operator enforces itself (under
            ``TPU_CYPHER_WCOJ=force``; Q6-Q8 run under ``auto``, whose
            blowup estimate routes SF1 and SF10 to WCOJ), and Q9-Q12 on
            the classic filter and equi-join path (a property-property
            WHERE, IS3 ordered by friendId, a value join and an
            OPTIONAL MATCH with WHERE; ``join_probe`` on the last two), and
            Q13-Q16 on row shaping and grouping (the 2-hop DISTINCT count,
            a grouped count under ORDER BY ... LIMIT, grouped min, max and
            percentileDisc over 256 groups on ``segment_agg``, DISTINCT
            values paged with SKIP and LIMIT; Q13 now on the fused walk's
            DISTINCT-endpoints count), and Q17-Q21 and three loopy-graph
            queries on the chain walk (the 2-hop DISTINCT at SF10,
            bench.py VAR_LENGTH, BASELINE.md config 4's *1..4, a
            materializing *1..2 at SF1, an undirected *1..2 and a *0..2,
            and relationship uniqueness enforced inside the chain), and
            Q22-Q26 and five loopy-graph queries on the closing
            ExpandInto and the fused OPTIONAL expand (the triangle closed
            by an undirected KNOWS at SF10, counted by
            ``CsrExpandIntoOp``'s fused close count in both orientations,
            and at SF1 grouped by a: its materialize path, both probe
            halves on ``intersect``; Q6 under ``TPU_CYPHER_WCOJ=off``: the
            fused close count; OPTIONAL MATCH forward over SF10's persons
            and backward, its first 100,000 rows in order, on SF10's
            persons with the KNOWS into half of them; on the loopy graph
            the triangle and the 2-cycle under ``off``, their pairs
            enforced inside the close count, the undirected close, and
            OPTIONAL rows forward and backward), and Q27-Q30 at SF10 on
            the expression compiler (a CASE band grouped with a modulo
            sum; STARTS WITH and toInteger(substring(...)) in a WHERE, on
            the vocab route; an OPTIONAL MATCH counted by its elements,
            count(a), count(b) and count(DISTINCT b); type(r) grouped with
            a CASE sum and max(abs(...))) with each run's expression spans,
            rand() over SF10's persons (and the float % on the card against
            IEEE fmod at its edge values), and Q31-Q35 on lists, maps and
            elements as values (collect then UNWIND over SF10's KNOWS, the
            explode on ``expand_rows``; a comprehension and a quantifier
            over the collected lists of the persons with 60 or more
            friends; Q20's *1..2 at SF1 grouped by size(rs), and 1,000 of
            its rows with each relationship list decoded and chained from
            a to b; labels(p) grouped over SF10's nodes, keys, properties,
            a map literal and split over 1,000 persons; collect(b) of
            elements), and Q54-Q59 on the rest of the list surface (a named
            path's length from Q33's walk over an SF10 window, and 1,000
            rows of an undirected *1..2 path at SF1 with its nodes and
            relationships, each row checked to be a path along KNOWS;
            Q11's value join on a list key, on ``join_probe``; a nested
            list collected and unwound; 144 list keys and 12 map keys
            grouped and ordered; ``reduce`` as an integer fold over every
            person's friends and as a fold by position over a window of
            sources, its longest list printed; a list of four kinds, and
            its UNWIND counted per kind), each cold and five times warm
            with its peak device memory and its launches per (kernel,
            tier); then the factorized tier and the optimizer:
            Q36, bench.py CLIQUE4_MAT, under ``TPU_CYPHER_WCOJ=force`` and
            ``TPU_CYPHER_FACTORIZE=force`` (the 4-clique a
            ``FactorizedTable`` until its DISTINCT count, its lanes
            printed against its flat rows), Q37, the same 4-clique under
            the defaults (count, min and max of d.id: the multi-close flat
            decode at the output extent), both on SF0.5 (5,000 persons),
            where the WCOJ materialize's pivot lanes fit the card (8.0e9
            at SF10), Q38, the 2-hop at SF10 grouped by ``a.id % 256``
            under ``force`` (the factorized expand, its uniqueness pair
            proven redundant, its weighted partials on ``segment_agg``),
            Q39, the fan of ``tests/test_factorized.py`` at 1,024 x 1,024
            streamed by ``records.iter_chunks(65536)`` (a
            ``FactorizedTable``, the bag checked by bincount, the device
            peak beside the flat form's bytes), and Q40-Q44, bench.py's
            five join-order queries on a copy of its graph (30,000 nodes,
            300,000 KNOWS, 600 RARE) under the default ``auto`` and under
            ``syntax``, with each ``join_order`` note; then the temporal
            kinds: SF10 with ``generate_snb(temporal=True)`` (its temporal
            columns' ingest seconds printed first), Q45-Q53 (a date's year
            and quarter, a datetime's hour at +02:00, a localdatetime's
            range filter, min and max, grouped max, top 20 and month
            arithmetic over every KNOWS, and Q11's join on a date key),
            each cold and five times warm with its own peak device memory
            and launches per (kernel, tier), against numpy ``datetime64``
            (temporal min and max on the ``segment_agg`` kernel), and
            examples/05_temporal.py's four queries against the rows it
            prints; then the dense count tier at SF1: Q13
            (TWO_HOP_DISTINCT) and Q6 (TRIANGLE, which WCOJ's ``auto``
            hands back) under the defaults, each answered by the bf16
            products once a run, under ``TPU_CYPHER_MXU_DENSE=0`` (the
            walk; the triangle also under ``TPU_CYPHER_WCOJ=off``) and
            under the tiled tier (``force`` with the dense cap pinned at
            8,192), all equal to the truth, with warm medians, own peak
            device memory and the products alone against their flop
            bound (Q13 itself runs under ``0`` among Q13-Q16, where its
            fused-walk checks stay); the standalone kernel API at SF10
            (``CsrGraph.build`` through the native tier against numpy's,
            ``two_hop_count`` on ``frontier_deg_sum``, ``two_hop_expand``
            on ``expand_rows``, ``triangle_count`` on ``intersect``,
            ``walk_counts`` against numpy); and SF10's KNOWS written as an
            edge list, parsed natively by ``load_edge_list`` and counted
            by Q2's shape. The walk counts' truth
            honours relationship uniqueness: by rule (the homomorphic
            count less the walks that reuse an edge), each rule held to a
            brute-force enumeration on 20 sources, or by the enumeration
            itself. It checks every
            answer against numpy/scipy ground truth computed from the
            generator's arrays, and checks that each query ran on the
            device rung once with no kernel fallback, launched its kernels
            on the ``kernel`` tier and (Q6-Q8) answered on the expected
            WCOJ tier. Phase 4 runs on graphs generated anew after phase 3,
            so each graph's first query builds its CSR inside its cold
            time; each cold run's time is split by the query's own trace
            phases;
5. measurements off the main path, after phase 4's counts are read —
            Q11 and Q12 warm on the ``join_probe`` kernel tier against the
            plain version called in the gate's place, and the triangle
            count on the WCOJ tier (``force``) against the binary plan
            (``off`` with ``TPU_CYPHER_MXU_DENSE=0``: ``CsrExpandIntoOp``'s
            fused close count on the walk, Q23) on four
            graphs up to SF10, ABBA-interleaved, every answer checked, and
            under ``auto`` on the 100-node graph (the binary plan: its
            blowup estimate lies under ``TPU_CYPHER_WCOJ_MIN_ROWS``, and
            stays so after one span of the binary plan at 100x its class's
            estimate is folded into the calibration) and SF10 (WCOJ); and
            the ``segment_agg`` gate's ``min`` at Q14's group ids (about
            100,000 groups: the ``fallback`` tier); Q38 under ``force``,
            under ``auto`` with a 2 GiB memory budget (only the factorized
            route fits; ``off`` with it raises ``AdmissionRejected``) and
            flat under ``off``, Q36 under ``force`` against its flat decode
            (``off``), and Q40-Q44 under ``syntax`` against ``force``,
            ABBA-interleaved, with each variant's own peak device memory;
6. serving — the serving tier on the card (``scripts/serve_smoke.py``,
            whose docstring has the detail): a ``QueryServer`` on
            ``CypherSession.cuda()`` over SF10 and SF1 generated anew, 16
            TCP clients over a fixed mix (the 2-hop count over a source
            window, IS3, the top 20 by degree, the SF1 triangle count, a
            ``*1..2`` walk count), every answer held to numpy/scipy truth
            and to a serial run, the pool's lanes on distinct CUDA streams;
            a burst coalesced into one dispatch, a cache hit with no launch,
            SF1's single-hop rows streamed chunk by chunk, a query over the
            memory budget rejected; an SF1 ``MutableGraph`` with a WAL
            under 8 clients with one write in ten, each write read back, a
            compaction, the store equal to its WAL rebuild; and a
            ``ClusterServer`` of 2 worker processes on the card, one
            SIGKILLed mid-run, every answer exact and every write read back
            after the restart. It prints queries/s and p50/p99 latencies
            (host clock) per kind, its launches per (kernel, tier) and each
            worker's peak device memory;
7. TCK    — every scenario of ``tests/tck/features`` through
            ``CypherSession.cuda()`` on the card, with
            ``tests/test_torch_tck.py``'s rules and its list of unanswered
            scenarios: each whitelisted scenario passes (an expected error
            of the class the ``local()`` oracle raises), each blacklisted
            one fails; it prints the counts, the seconds, the launches per
            (kernel, tier) the phase made and the counts the dense tiers
            answered;
8. mesh   — the mesh tiers (``tpu_cypher_torch/parallel/``) on SF10, on a
            virtual mesh of 4 shards on cuda:0 and, where the machine has
            more than one card, on a mesh over every card (one card
            prints that it cannot show launches across devices): Q4's
            2-hop count on the mesh's chain (the sharded SpMV), Q6 under
            ``TPU_CYPHER_WCOJ=force`` (the sharded range count on
            ``intersect``), an integer aggregate grouped by ``a.id % 256``
            (count, sum, min, max, avg as per-shard ``segment_agg``
            partials), and a DISTINCT count pushed down to the table and
            Q11's value join, which keep the one device's path under a
            mesh (the tables are whole on the home device, so the
            reference's shuffle tiers would only add routing); each query
            three times warm on one device and cold and five times warm on
            the mesh, each answer equal to the numpy truth and to the
            one-device run, the tier counters advancing, every launch of
            the three kernels on the ``kernel`` tier, and the launches of
            the two sharded kernels a multiple of the shard count; it
            prints the warm medians, own peak device memory and launches a
            shard;
            then two worker processes on cuda:0 joined over ``gloo``, 2
            virtual shards each (``python -m
            tpu_cypher_torch.parallel.multihost --scale 1.0``), whose SF1
            answers must equal numpy's and each other's;
9. sources — the graph sources (``tpu_cypher_torch/io``), in a temporary
            directory: (a) a newly generated SF10 stored as parquet through
            ``session.register_source("fs", FSGraphSource(...))`` and
            ``store_graph``, loaded back with ``session.graph``, its arrays
            equal to the generator's, and Q2, Q3, Q6 (WCOJ on ``intersect``
            under ``auto``), Q11 and Q15 on it; (b) SF1 with its temporal
            columns stored as CSV and loaded back, Q2 and Q47's temporal
            min and max; (c) SF1's arrays as two ``InMemoryTables`` views
            mapped by Graph DDL (``SqlPropertyGraphDataSource``) under
            ``HASHED_ID``, whose 63-bit ids must reach 2**54, and
            ``SERIALIZED_ID``, with Q2, Q6, Q11 and a join on ``id(b) =
            id(c)``; (d) SF1's Neo4j bulk CSV export, its row counts and
            headers. Each query cold and five times warm, every answer
            equal to numpy's truth, every launch on the ``kernel`` tier and
            each of the five kernels launched; it prints the store, load
            and query seconds, the warm medians and each step's own peak
            device memory. Without pandas or pyarrow it says that (a), (b)
            and (d) did not run, and runs (c);
10. analyzer — the port's static analyzer (``tpu_cypher_torch/analysis``)
            against the card: (a) ``python -m tpu_cypher_torch.analysis
            --format json --facts-out F`` over the checkout exits 0, clean,
            with twelve rules and an empty baseline (files checked,
            findings, suppressions by rule and seconds printed); (b) the kernel names
            and impls ``obs-emission`` collects from the sources equal
            ``dispatch.registry()`` (five kernels), each of which launched
            on the ``kernel`` tier in phases 4 and 9; (c) SF10 Q2, Q6, Q11
            and Q15 and SF1 Q5, warm on the phase-4 graphs, under
            ``torch.cuda.set_sync_debug_mode("warn")``: every sync's stack
            is attributed to its innermost frame in ``tpu_cypher_torch/``
            and each site printed as ``file:line:function`` with what the
            ``host-sync`` rule says of it (flagged, suppressed, accepted
            under a ``fault_point``, outside its scope, or implicit: a
            data-dependent size or a copy the taint model does not model);
            a site whose line holds a sync kind of the taint model that the
            model did not see fails the run;
11. lattice — the bucket lattice (``TPU_CYPHER_BUCKET``), set in the
            process and restored in a ``finally``: (a) the shape facts that
            phase 10's CLI wrote (``--facts-out``): their summary, the
            lattice's rounding sites classified BUCKETED, and the sites a
            lattice-free port would change; (b) Q1, Q5, Q11, Q24 (the
            closing ExpandInto's materialize, both probe halves on
            ``intersect``) and Q20 (over a window of about 100,000 rows) at
            SF1, the loopy graph's 2-hop count,
            2-hop DISTINCT and fixed-rel-versus-``*1..2`` count, and Q17 at
            SF10, each under ``off``, ``pow2`` and ``1.25``, cold and five
            times warm: every answer equal to the ``off`` run's and to the
            numpy truth, every (true, padded) pair on the trace spans equal
            to ``analysis.shapes.predict_padded`` (at least 20 in each
            mode), every launch on the ``kernel`` tier, with the launches
            per (kernel, tier), the distinct padded extents per operator
            span, the warm median and the own peak device memory against
            ``off``; ``expand_rows``, ``segment_agg``, ``intersect`` and
            ``join_probe`` must launch in both modes (``lattice_launches``
            in the kernels' line).

The kernel launch counts are zeroed just before phase 4 and read just after
it; the comparisons of phase 3 and the runs of phase 5 do not count. Phase
6 zeroes them again before its in-process server and reads them after its
writes, for its own line; phase 8 zeroes them before each mesh and reads
them after it (``mesh_launches`` in the kernels' line); phase 9 zeroes them
at its start and reads them at its end (``sources_launches``); phase 11
reads their change over each lattice run (``lattice_launches``). The line
before the last is
the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: the device-memory rate (NVIDIA's data sheet), and the int32
# instruction rate: 132 SMs x 64 int32 lanes x the 1.98 GHz boost clock
# (the Hopper white paper). The data sheet's 67 TFLOP/s fp32 is the same
# 132 SMs x 128 fp32 lanes x 1.98 GHz with an FMA counted as two
# operations. Both rates assume the full 700 W power limit.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

SEED = 42
Q1 = "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id AS a, b.id AS b"
Q2 = "MATCH (a:Person)-[:KNOWS]->(b) RETURN count(*) AS c"
Q3 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) "
    "RETURN min(b.birthday) AS lo, max(a.birthday) AS hi"
)
# the north-star 2-hop count (bench.py TWO_HOP)
Q4 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "RETURN count(*) AS c"
)
Q5 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "RETURN min(c.birthday) AS lo, max(c.birthday) AS hi"
)
# the triangle close (bench.py TRIANGLE), its rows, and the 4-clique
# (bench.py CLIQUE4)
MATCH_TRI = "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a) "
Q6 = MATCH_TRI + "RETURN count(*) AS triangles"
Q7 = MATCH_TRI + "RETURN a.id AS a, b.id AS b, c.id AS c"
Q8 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a), "
    "(a)-[:KNOWS]->(d:Person), (b)-[:KNOWS]->(d), (c)-[:KNOWS]->(d) "
    "RETURN count(*) AS cliques"
)

# the classic filter and equi-join path
Q9 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.birthday < b.birthday "
    "RETURN count(*) AS n"
)
# LDBC SNB Interactive Short Query 3 (IS3, friends of a person), as far as
# the generator allows: its KNOWS edges carry no creationDate (so the
# friendship date and the ORDER BY on it are left out) and persons have no
# lastName; it orders by friendId
Q10 = (
    "MATCH (n:Person {id: $personId})-[:KNOWS]-(friend:Person) "
    "RETURN friend.id AS friendId, friend.firstname AS firstName ORDER BY friendId"
)
Q10_PERSON = 7001
Q11 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person), (c:Person) "
    "WHERE b.birthday = c.birthday RETURN count(*) AS n"
)
Q12 = (
    "MATCH (a:Person) WHERE a.birthday < 1000 "
    "OPTIONAL MATCH (a)-[:KNOWS]->(b:Person) WHERE b.birthday > 9000 "
    "RETURN a.id AS a, b.id AS b"
)

# row shaping and grouping: the 2-hop DISTINCT count (bench.py
# TWO_HOP_DISTINCT), the most connected persons (a grouped count, ORDER BY
# ... LIMIT as the packed top-k), the hubs' friends' birthdays (the
# segment_agg kernel at k > 1; ids are 7k + 1, so the WHERE keeps k < 256)
# and distinct values paged (DISTINCT, then ORDER BY ... SKIP ... LIMIT)
Q13 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person) "
    "WITH DISTINCT a, c RETURN count(*) AS pairs"
)
Q14 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id AS id, count(*) AS deg "
    "ORDER BY deg DESC, id LIMIT 20"
)
Q15_ID_BOUND = 1793
Q15 = (
    f"MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.id < {Q15_ID_BOUND} "
    "RETURN a.id AS id, count(*) AS n, min(b.birthday) AS lo, max(b.birthday) AS hi, "
    "percentileDisc(b.birthday, 0.5) AS med ORDER BY id"
)
Q16 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN DISTINCT b.birthday AS d "
    "ORDER BY d SKIP 100 LIMIT 50"
)

# phase 10: the queries traced for device->host syncs, which between them
# launch all five kernels ("small" is SF1, "big" SF10)
SYNC_QUERIES = (
    ("Q2 (SF10)", "big", Q2),
    ("Q5 (SF1)", "small", Q5),
    ("Q6 (SF10)", "big", Q6),
    ("Q11 (SF10)", "big", Q11),
    ("Q15 (SF10)", "big", Q15),
)

# the chain walk: the 2-hop DISTINCT count at SF10 (bench.py
# TWO_HOP_DISTINCT), bench.py VAR_LENGTH (*1..3), BASELINE.md config 4
# (*1..4), a materializing *1..2, an undirected *1..2 and a *0..2, each
# over a source-id window by bench.py's rule
Q17 = Q13
WALK_WINDOW = "MATCH (a:Person) WHERE a.id >= $lo AND a.id < $hi WITH a "
Q18 = WALK_WINDOW + "MATCH (a)-[:KNOWS*1..3]->(b:Person) RETURN count(*) AS walks"
Q19 = WALK_WINDOW + "MATCH (a)-[:KNOWS*1..4]->(b:Person) RETURN count(*) AS walks"
Q20 = WALK_WINDOW + "MATCH (a)-[:KNOWS*1..2]->(b:Person) RETURN a.id AS a, b.id AS b"
Q21_UNDIRECTED = WALK_WINDOW + "MATCH (a)-[:KNOWS*1..2]-(b:Person) RETURN count(*) AS walks"
Q21_ZERO = WALK_WINDOW + "MATCH (a)-[:KNOWS*0..2]->(b:Person) RETURN count(*) AS walks"
# relationship uniqueness inside the chain, on the loopy graph: a
# fixed-rel-versus-var-length count, the fixed rels from a window of x (a
# window of c would sit above the walk, which then walks from every c)
LOOPY_FORBID = (
    "MATCH (x:Person) WHERE x.id < $hi WITH x "
    "MATCH (x)-[r:KNOWS]->(y:Person), (c:Person)-[rs:KNOWS*1..2]->(d:Person) "
    "RETURN count(*) AS n"
)

# the closing ExpandInto and the fused OPTIONAL expand: the triangle closed
# by an undirected KNOWS (LDBC SNB treats KNOWS as undirected), Q6 under
# TPU_CYPHER_WCOJ=off (the reference's binary plan: the fused close count),
# the undirected close grouped by its a, and OPTIONAL MATCH forward (every
# person, counted) and backward (the first page of rows, in (b, a) order,
# on a graph where half the persons have no incoming KNOWS)
MATCH_CLOSE = "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]-(a) "
Q22 = MATCH_CLOSE + "RETURN count(*) AS t"
Q23 = Q6  # under TPU_CYPHER_WCOJ=off
Q24 = MATCH_CLOSE + "RETURN a.id AS a, count(*) AS n"
Q25 = (
    "MATCH (a:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) "
    "RETURN count(*) AS rows, count(b.id) AS matched"
)
Q26_ROWS = 100_000
Q26 = (
    "MATCH (b:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) RETURN b.id AS b, a.id AS a "
    f"ORDER BY b, a LIMIT {Q26_ROWS}"
)
# on the loopy graph: the 2-cycle under off (the close is the chain's only
# hop), and OPTIONAL MATCH rows forward and backward
LOOPY_2CYCLE = "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(a) RETURN count(*) AS c"
LOOPY_OPT_FWD = "MATCH (a:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) RETURN a.id AS a, b.id AS b"
LOOPY_OPT_BWD = "MATCH (b:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) RETURN b.id AS b, a.id AS a"

# the expression compiler and elements as values: a CASE band grouped with
# a modulo sum, string predicates and a function chain in a WHERE, an
# OPTIONAL MATCH counted by its elements, and type(r) grouped with a CASE
# sum and max(abs(...)); firstnames are "p" + the person's index, ids 7k + 1
Q27 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN CASE "
    "WHEN b.birthday - a.birthday > 3650 THEN 'older' "
    "WHEN a.birthday - b.birthday > 3650 THEN 'younger' ELSE 'peer' END AS band, "
    "count(*) AS n, sum(b.birthday % 365) AS s ORDER BY band"
)
Q28 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE b.firstname STARTS WITH 'p1' "
    "AND toInteger(substring(a.firstname, 1)) % 10 = 3 RETURN count(*) AS n"
)
Q29 = (
    "MATCH (a:Person) WHERE a.birthday < 2000 "
    "OPTIONAL MATCH (a)-[:KNOWS]->(b:Person) WHERE b.birthday >= 17000 "
    "RETURN count(a) AS na, count(b) AS nb, count(DISTINCT b) AS db"
)
Q30 = (
    "MATCH (a:Person)-[r:KNOWS]->(b:Person) WHERE a.id % 1000 = 1 "
    "RETURN type(r) AS t, count(*) AS n, "
    "sum(CASE WHEN b.birthday > a.birthday THEN 1 ELSE 0 END) AS younger, "
    "max(abs(b.birthday - a.birthday)) AS gap"
)
# lists, maps and elements as values: collect then UNWIND (the explode on
# the expand_rows gate), a comprehension and a quantifier over collected
# lists, the var-length relationship list from the walk, labels, keys,
# properties, a map literal and split, and collect of elements
Q31 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, collect(b.birthday) AS bs "
    "UNWIND bs AS x RETURN count(*) AS n, sum(x % 365) AS s"
)
Q32 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, collect(b.id) AS fs "
    "WHERE size(fs) >= 60 RETURN count(*) AS n, "
    "sum(size([x IN fs WHERE x % 2 = 0])) AS even, "
    "count(CASE WHEN any(x IN fs WHERE x % 1000 = 1) THEN 1 END) AS hit"
)
Q33 = (WALK_WINDOW + "MATCH (a)-[rs:KNOWS*1..2]->(b:Person) "
       "RETURN size(rs) AS hops, count(*) AS c ORDER BY hops")
Q33_ROWS = (WALK_WINDOW + "MATCH (a)-[rs:KNOWS*1..2]->(b:Person) "
            "RETURN a.id AS a, b.id AS b, rs LIMIT 1000")
Q34 = "MATCH (p) RETURN labels(p) AS l, count(*) AS c"
Q34_VALUES = (
    "MATCH (a:Person) WHERE a.id % 100 = 1 RETURN a.id AS id, keys(a) AS k, "
    "properties(a) AS p, {id: a.id, b: a.birthday % 7} AS m, "
    "split(a.firstname + ' ' + toString(a.birthday % 10), ' ') AS s"
)
Q35 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.id % 1000 = 1 "
    "RETURN a.id AS a, collect(b) AS fs"
)
# the rest of the list surface: a named path's length from the walk (Q33
# on a path), its nodes and relationships over an undirected walk, Q11 on a
# list key, a nested list collected and unwound, list and map keys grouped
# and ordered, reduce (the integer fold over every list, and a fold by
# position over a window of sources), and a list of mixed kinds
Q54 = (WALK_WINDOW + "MATCH p = (a)-[:KNOWS*1..2]->(b:Person) "
       "RETURN length(p) AS l, count(*) AS c ORDER BY l")
Q54_ROWS = (WALK_WINDOW + "MATCH p = (a)-[:KNOWS*1..2]-(b:Person) "
            "RETURN a.id AS a, nodes(p) AS ns, relationships(p) AS rs LIMIT 1000")
Q55 = ("MATCH (a:Person)-[:KNOWS]->(b:Person), (c:Person) "
       "WHERE [b.birthday, b.id % 2] = [c.birthday, c.id % 2] RETURN count(*) AS n")
Q56 = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, collect([b.id, b.birthday % 365]) AS ps "
       "UNWIND ps AS pr RETURN count(*) AS n, sum(pr[0]) AS s, sum(pr[1]) AS t")
Q57 = ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
       "RETURN [a.birthday % 12, b.birthday % 12] AS k, count(*) AS c ORDER BY k")
Q57_MAP = ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
           "RETURN {m: a.birthday % 12} AS k, count(*) AS c ORDER BY k")
Q58 = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, collect(b.id) AS fs "
       "RETURN sum(reduce(s = 0, x IN fs | s + x % 13)) AS r")
Q58_WINDOW = (WALK_WINDOW + "MATCH (a)-[:KNOWS]->(b:Person) WITH a, collect(b.id) AS fs "
              "RETURN a.id AS a, size(fs) AS n, reduce(m = 0, x IN fs | "
              "CASE WHEN x % 1000 > m THEN x % 1000 ELSE m END) AS r")
Q59 = ("MATCH (a:Person) WHERE a.id % 100 = 1 "
       "RETURN [a.id, a.firstname, a.birthday % 2 = 0, null] AS m")
Q59_UNWIND = ("MATCH (a:Person) WHERE a.id % 100 = 1 "
              "UNWIND [a.id, a.firstname, a.birthday % 2 = 0, null] AS x RETURN x")
Q54_WALKS = 2_000_000  # Q54's directed <= 2-walk estimate over its window
Q54_ROWS_WALKS = 2_000_000  # Q54 rows' undirected <= 2-walk estimate over its window
Q58_FRIENDS = 200_000  # Q58 window's collected elements
# (query, plan operator, kernels each run launches)
LIST_QUERIES = {
    "Q31": (Q31, "UnwindOp", ("expand_rows", "segment_agg")),
    "Q32": (Q32, "AggregateOp", ("expand_rows", "segment_agg")),
    "Q33": (Q33, "CsrVarExpandOp", ("expand_rows",)),
    "Q33 rows": (Q33_ROWS, "CsrVarExpandOp", ("expand_rows",)),
    "Q34": (Q34, "AggregateOp", ()),
    "Q34 values": (Q34_VALUES, "AddOp", ("expand_rows",)),
    "Q35": (Q35, "AggregateOp", ("expand_rows",)),
    "Q54": (Q54, "CsrVarExpandOp", ("expand_rows",)),
    "Q54 rows": (Q54_ROWS, "CsrVarExpandOp", ("expand_rows",)),
    "Q55": (Q55, "JoinOp(inner", ("expand_rows", "join_probe")),
    "Q56": (Q56, "UnwindOp", ("expand_rows", "segment_agg")),
    "Q57": (Q57, "AggregateOp", ("expand_rows",)),
    "Q57 map": (Q57_MAP, "AggregateOp", ("expand_rows",)),
    "Q58": (Q58, "AggregateOp", ("expand_rows", "segment_agg")),
    "Q58 window": (Q58_WINDOW, "AggregateOp", ("expand_rows",)),
    "Q59": (Q59, "FilterOp", ()),
    "Q59 unwind": (Q59_UNWIND, "UnwindOp", ()),
}
# the queries whose graph is SF1 (Q33's window is Q20's)
SF1_LIST_QUERIES = ("Q33", "Q33 rows", "Q54 rows")
EXPR_KERNELS = {
    "Q27": ("expand_rows", "segment_agg"),
    "Q28": ("expand_rows",),
    "Q29": ("expand_rows", "join_probe", "segment_agg"),
    "Q30": ("expand_rows", "segment_agg"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    check(out.returncode == 0 and lines, f"nvidia-smi failed: {out.stderr.strip()}")
    return lines[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, int_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    """Exact comparison: 0.0 when equal (float64 bit for bit, valid masks
    and dtypes included), else the largest absolute difference (inf when
    the shapes, dtypes or non-finite payloads differ)."""
    if a is None or b is None:
        return 0.0 if a is None and b is None else float("inf")
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.float64:
        if torch.equal(a.view(torch.int64), b.view(torch.int64)):
            return 0.0
        diff = (a - b).abs()
        return float("inf") if not torch.isfinite(diff).all() else float(diff.max())
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def tuple_err(torch, xs, ys) -> float:
    return max(max_abs_err(torch, x, y) for x, y in zip(xs, ys))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def backend_device():
    from tpu_cypher_torch.backend.cuda import device

    return device.get()


def graph_arrays(pg):
    """Host arrays of a generated graph: ids, birthday, src, dst."""
    node = [et for et in pg._graph.scans if et.is_node][0].table
    rel = [et for et in pg._graph.scans if not et.is_node][0].table
    return (
        node._cols["id"]._np_cache,
        node._cols["birthday"]._np_cache,
        rel._cols["source"]._np_cache,
        rel._cols["target"]._np_cache,
    )


def q6_expand_calls(g10, want):
    """Run Q6 once more on ``g10`` with a hook on the ``expand_rows`` gate
    and return the (args, kwargs) of the count tier's calls, in call order
    (arm 0 first), after the first call (the ``CsrExpandOp`` hop that makes
    the tier's input rows). The run's launches are not the main path's (the
    counts are zeroed before phase 4)."""
    from tpu_cypher_torch.backend.cuda import hopper

    calls = []
    inner = hopper.expand_materialize_counted

    def hook(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    hopper.expand_materialize_counted = hook
    try:
        rows = [dict(r) for r in g10.cypher(Q6).records.collect()]
    finally:
        hopper.expand_materialize_counted = inner
    check(rows == [{"triangles": want}], f"Q6 (hooked) {rows} != {want}")
    check(len(calls) == 3, f"Q6 made {len(calls)} expand calls, expected 3")
    return calls[1:]


def expand_bound(torch, pos, deg, live, size, with_orig, tile):
    """(bound_ms, bound_by, ops_ms) of the expand tier: the bytes it must
    move (per frontier row pos, deg and rp[pos]: 20 B; per live lane ci and
    eo: 12 B, 4 without orig; per lane row, nbr, orig and live: 25 B, 17
    without orig) against its int32 operations, counted from
    expand_rows.cu for this run's merge: per frontier row 27 (the block
    scan's five shuffle rounds at 3, the casts, adds, the gather's address
    and the partition bounds), per live lane 12 (the range test, the edge
    arithmetic, the row, two addresses, the pair loop), per lane pair one
    binary search over its tile's row starts at 5 a step."""
    f = int(pos.shape[0])
    nbytes = 20 * f + (12 if with_orig else 4) * live + (25 if with_orig else 17) * size
    cum = torch.cumsum(deg, 0) - deg
    m = torch.clamp(cum, max=live) + torch.arange(f, device=deg.device)
    ntiles = -(-(live + f) // tile)
    edges = torch.clamp(torch.arange(ntiles + 1, device=deg.device) * tile, max=live + f)
    parts = torch.searchsorted(m, edges)
    nb = parts[1:] - parts[:-1]
    lanes = (edges[1:] - edges[:-1]) - nb
    steps = torch.ceil(torch.log2(nb.double() + 1))
    ops = 27 * f + 12 * live + 5 * int(torch.sum((lanes.double() / 2) * steps))
    t_bytes, _ = bound(nbytes, 0)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes", t_ops) if t_bytes >= t_ops else (t_ops, "operations", t_ops)


def check_expand_rows(torch, session, g1, g10, tri10, report):
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.bucketing import round_up_pow2
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX

    ctx = session._runtime_context({})
    dev = backend_device()
    rng = np.random.default_rng(SEED)
    tile = KX.TILE_ITEMS
    err = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def csr(pg):
        gi = GraphIndex.of(pg._graph)
        gi.node_ids(ctx)
        return gi, gi.csr(("KNOWS",), False, ctx)

    def compare_call(label, args, size):
        """The kernel tier against the plain version, with and without
        orig, on one gate call's arguments."""
        nonlocal err
        for with_orig in (True, False):
            got = KX.expand_materialize_counted_cuda(*args, size, with_orig)
            want = J.expand_materialize_counted(*args, size, with_orig=with_orig)
            torch.cuda.synchronize()
            e = tuple_err(torch, got, want)
            err = max(err, e)
            print(f"  expand_rows {label}{'' if with_orig else ', without orig'}: "
                  f"F={int(args[3].shape[0])} lanes={size} live={args[5]} max_abs_err={e}")
            check(e == 0.0, f"expand_rows {label} (orig={with_orig}) disagrees "
                  f"with its plain version")

    def compare(label, rp, ci, eo, pos, present, size=None):
        deg, t_dev = J.expand_degrees_total(rp, pos, present)
        total = int(t_dev)
        compare_call(label, (rp, ci, eo, pos, deg, total),
                     total if size is None else size)
        return deg, total

    # Q3's hop at SF10: the whole Person scan as frontier
    gi10, (rp, ci, eo) = csr(g10)
    v10 = gi10.num_nodes
    pos = torch.arange(v10, dtype=torch.int64, device=dev)
    present = torch.ones(v10, dtype=torch.bool, device=dev)
    deg, total = compare("SF10 hop", rp, ci, eo, pos, present)
    # the same frontier on a bucket-padded lane count (pad lanes)
    compare("SF10 hop, pow2-padded", rp, ci, eo, pos, present,
            size=round_up_pow2(total))
    # Q5's second hop at SF1: the first hop's far ends as frontier
    gi1, (rp1, ci1, eo1) = csr(g1)
    v1 = gi1.num_nodes
    pos1 = torch.arange(v1, dtype=torch.int64, device=dev)
    pres1 = torch.ones(v1, dtype=torch.bool, device=dev)
    deg1, t1 = J.expand_degrees_total(rp1, pos1, pres1)
    _, nbr1, _, _ = J.expand_materialize_counted(rp1, ci1, eo1, pos1, deg1, int(t1), int(t1))
    pos2 = nbr1.contiguous()
    pres2 = torch.ones(pos2.shape[0], dtype=torch.bool, device=dev)
    deg2, total2 = compare("SF1 second hop", rp1, ci1, eo1, pos2, pres2)
    # an empty frontier and an all-absent one (every lane a pad lane)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    compare("empty frontier", rp1, ci1, eo1, empty, empty.bool())
    compare("all-absent frontier", rp1, ci1, eo1, pos1,
            torch.zeros(v1, dtype=torch.bool, device=dev), size=1024)
    # the tile shapes: absent rows in runs of several tiles, a hub row whose
    # degree spans several tiles, lanes and pads off the tile boundary
    runs = pres2.clone()
    runs[1000:1000 + 3 * tile] = False
    runs[200_000:200_000 + tile + 7] = False
    compare("absent runs of 3 and 1+ tiles", rp1, ci1, eo1, pos2, runs)
    hub_deg = rng.integers(0, 40, 5000)
    hub_deg[17] = 5 * tile + 77
    hub_rp = t(np.concatenate([[0], np.cumsum(hub_deg)]).astype(np.int32))
    n_hub = int(hub_deg.sum())
    hub_ci = t(rng.integers(0, 5000, n_hub).astype(np.int32))
    hub_eo = t(rng.integers(0, 1 << 40, n_hub).astype(np.int64))
    hub_pos = t(np.concatenate([rng.integers(0, 5000, 3000), [17],
                                rng.integers(0, 5000, 3000)]).astype(np.int64))
    compare("hub row of 5 tiles", hub_rp, hub_ci, hub_eo, hub_pos,
            torch.ones(6001, dtype=torch.bool, device=dev))
    off = compare("off the tile boundary", rp1, ci1, eo1, pos2[:-3], pres2[:-3])[1]
    check((off + pos2.shape[0] - 3) % tile != 0, "the off-tile case lies on a boundary")
    compare("off the tile boundary, with pads", rp1, ci1, eo1, pos2[:-3], pres2[:-3],
            size=off + 2 * tile + 3)
    # Q6's count tier at SF10, as it calls the gate (arm 0: the most lanes)
    calls = q6_expand_calls(g10, tri10)
    for j, (args, kwargs) in enumerate(calls):
        check(kwargs.get("with_orig") is False, f"Q6 arm {j} asked for orig")
        compare_call(f"Q6 SF10 arm {j}", args, kwargs["size"])

    # timing at Q5's second hop (the tier as CsrExpandOp calls it) and at
    # Q6 arm 0 (as the count tier calls it, without orig): the tier, its
    # plain version, and torch.searchsorted over the lanes
    timings = {}
    q6_args, q6_kwargs = calls[0]
    for key, args, size, with_orig in (
        ("q5", (rp1, ci1, eo1, pos2, deg2, total2), total2, True),
        ("q6", q6_args, q6_kwargs["size"], False),
    ):
        iters = 20 if key == "q5" else 10
        tier = lambda: KX.expand_materialize_counted_cuda(*args, size, with_orig)  # noqa: E731
        ms = time_ms(torch, tier, iters=iters)
        orig_ms = time_ms(torch, lambda: KX.expand_materialize_counted_cuda(
            *args, size, True), iters=iters)
        plain_ms = time_ms(torch, lambda: J.expand_materialize_counted(
            *args, size, with_orig=with_orig), iters=3, warmup=1)
        cum, _ = KX.frontier_state(args[0], args[3], args[4])
        lanes = torch.arange(size, dtype=torch.int32, device=dev)
        lib_ms = time_ms(torch, lambda: torch.searchsorted(cum, lanes, right=True),
                         iters=iters)
        live = min(int(args[5]), size)
        b_ms, b_by, ops_ms = expand_bound(torch, args[3], args[4], live, size, with_orig, tile)
        shape = (f"F={int(args[3].shape[0])}, {size} lanes, "
                 f"{'with' if with_orig else 'without'} orig")
        timings[key] = (ms, orig_ms, plain_ms, lib_ms, b_ms, b_by, ops_ms, shape)
        print(f"  expand_rows tier at {key.upper()} ({shape}): {ms:.4f} ms"
              f"{'' if with_orig else f' ({orig_ms:.4f} ms with orig)'}, plain "
              f"{plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; operations {ops_ms:.4f} ms)")
    ms, _, plain_ms, lib_ms, b_ms, b_by, ops_ms, shape = timings["q5"]
    q6 = timings["q6"]
    report["expand_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.searchsorted",
        shape=f"the tier at Q5's second hop, SF1: {shape}",
        ops_bound_ms=ops_ms,
        q6_tier_ms=q6[0], q6_tier_with_orig_ms=q6[1], q6_plain_ms=q6[2],
        q6_library_ms=q6[3], q6_bound_ms=q6[4], q6_bound_by=q6[5],
        q6_ops_bound_ms=q6[6], q6_shape=f"the tier at Q6 arm 0, SF10: {q6[7]}",
    )


def device_ms(torch, fn, iters=100, warmup=3):
    """Mean device time per call: the summed durations of the device
    activities in a ``torch.profiler`` trace of ``iters`` back-to-back
    calls (``device_events``), over ``iters``. None when the trace shows no
    device activity."""
    events = device_events(torch, fn, iters=iters, warmup=warmup)
    return sum(us for _, us in events.values()) / 1e3 / iters if events else None


def device_events(torch, fn, iters=50, warmup=3):
    """{name: (count, summed microseconds)} of the device activities (kernels,
    memsets, copies) in a ``torch.profiler`` trace of ``iters`` back-to-back
    calls; empty when the trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def check_frontier(torch, session, g10, report):
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import frontier as KF

    ctx = session._runtime_context({})
    dev = backend_device()
    gi = GraphIndex.of(g10._graph)
    gi.node_ids(ctx)
    rp, _, _ = gi.csr(("KNOWS",), False, ctx)
    v = gi.num_nodes
    pos = torch.arange(v, dtype=torch.int64, device=dev)
    present = torch.ones(v, dtype=torch.bool, device=dev)
    err = 0.0
    for label, p, pr in (
        ("F=100,000 (Q2)", pos, present),
        ("all masked", pos, torch.zeros(v, dtype=torch.bool, device=dev)),
        ("single row", pos[v // 2: v // 2 + 1], present[:1]),
        ("odd length, unaligned", pos[1:], present[1:]),
        ("strided", pos[::3], present[::3]),
    ):
        got = KF.deg_sum_cuda(rp, p, pr)
        want = KF.deg_sum_plain(rp, p, pr)
        e = max_abs_err(torch, got, want)
        err = max(err, e)
        print(f"  frontier_deg_sum {label}: {int(got)} vs plain {int(want)} "
              f"max_abs_err={e}")
        check(e == 0.0, f"frontier_deg_sum {label} disagrees with its plain version")
    deg_node = (rp[1:] - rp[:-1]).to(torch.int64)

    def kernel():
        return KF.deg_sum_cuda(rp, pos, present)

    ms = time_ms(torch, kernel, iters=100)
    dev_ms = device_ms(torch, kernel, iters=100)
    plain_ms = time_ms(torch, lambda: KF.deg_sum_plain(rp, pos, present), iters=100)
    lib_ms = time_ms(torch, lambda: torch.sum(deg_node[pos]), iters=100)
    f = int(pos.shape[0])
    nbytes = 8 * f + f + 4 * min(v + 1, 2 * f) + 8
    # per row: the degree's subtract, the mask select and the add
    b_ms, b_by = bound(nbytes, 3 * f)
    report["frontier_deg_sum"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.sum over a gather",
        device_ms=dev_ms, shape=f"Q2 at SF10: F={f}",
    )
    dev_txt = "not measured (no device events)" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"  frontier_deg_sum timing at F={f}: kernel {ms:.4f} ms a call in a "
          f"host loop, device time {dev_txt} (torch.profiler, kernel durations); "
          f"plain {plain_ms:.4f} ms, torch.sum over a gather {lib_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")


def q5_segment_agg_calls(g1, want):
    """Run Q5 once more on ``g1`` with a hook on the ``segment_agg`` gate and
    return the (data, valid, seg_j, name, kind, k) of each of its calls: the
    arguments the query itself hands the kernel tier. The run's launches
    are not the main path's (the counts are zeroed before phase 4)."""
    from tpu_cypher_torch.backend.cuda import hopper

    calls = []
    inner = hopper.segment_aggregate

    def hook(data, valid, iflag, seg_j, *, name, kind, k):
        check(iflag is None, "Q5 aggregates carry no int_flag")
        calls.append((data, valid, seg_j, name, kind, k))
        return inner(data, valid, iflag, seg_j, name=name, kind=kind, k=k)

    hopper.segment_aggregate = hook
    try:
        rows = [dict(r) for r in g1.cypher(Q5).records.collect()]
    finally:
        hopper.segment_aggregate = inner
    check([(rows[0]["lo"], rows[0]["hi"])] == [want], f"Q5 (hooked) {rows} != {want}")
    check([c[3] for c in calls] == ["min", "max"], f"Q5 made calls {[c[3] for c in calls]}")
    return calls


def agg_bytes(data, valid, seg_j) -> int:
    """Bytes the fused kernel must read: each row's value, validity byte
    and segment id once."""
    per_row = data.element_size()
    per_row += 1 if valid is not None else 0
    per_row += seg_j.element_size() if seg_j is not None else 0
    return per_row * int(data.shape[0])


def check_segment_agg(torch, g1, q5_truth, q5_rows, report):
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA

    dev = backend_device()
    rng = np.random.default_rng(SEED)
    err = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, data, vmask, seg, name, kind, k):
        nonlocal err
        got = KA._segment_aggregate_cuda(data, vmask, seg, name, kind, k)
        want = J.segment_aggregate(data, vmask, None, seg, name, kind, k)
        e = tuple_err(torch, got, want)
        err = max(err, e)
        check(e == 0.0, f"segment_agg {label} {name}({kind}) k={k} "
              f"valid={vmask is not None} disagrees: {got} vs {want}")

    for n, k in ((q5_rows, 1), (1_000_000, 256)):
        seg = t(rng.integers(0, k, size=n, dtype=np.int64))
        valid = t(rng.random(n) < 0.9)
        i64 = rng.integers(-(2**62), 2**62, size=n, dtype=np.int64)
        i64[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1]
        f64 = rng.normal(size=n) * 1e3
        f64[rng.random(n) < 0.001] = np.nan
        f64[rng.random(n) < 0.01] = 0.0
        f64[rng.random(n) < 0.01] = -0.0
        f64[:4] = [np.inf, -np.inf, -0.0, 0.0]
        columns = {
            "i64": (t(i64), ("count", "sum", "min", "max")),
            "bool": (t(rng.random(n) < 0.5), ("min", "max")),  # read as bytes
            "str": (t(rng.integers(0, 5000, size=n).astype(np.int32)), ("min", "max")),
            "f64": (t(f64), ("min", "max")),
        }
        # at the slice's size the plain version's scatter atomics all hit
        # one slot, so only the masked variant runs there; k = 1 runs with
        # int64 ids and without ids (the global form), k = 256 with int64
        # and int32 ids
        masks = (valid,) if k == 1 else (None, valid)
        segs = (("int64 ids", seg), ("no ids", None)) if k == 1 else (
            ("int64 ids", seg), ("int32 ids", seg.to(torch.int32)))
        for kind, (data, names) in columns.items():
            for name in names:
                for vmask in masks:
                    for label, sg in segs:
                        compare(f"n={n} {label}", data, vmask, sg, name, kind, k)
        print(f"  segment_agg n={n} k={k} ({', '.join(l for l, _ in segs)}): "
              f"count/sum/min/max over int64, BOOL bytes, string codes, float64 "
              f"with NaN and +-0: max_abs_err={err}")
    # rows that start off the 16-byte boundary: the kernel's scalar path
    compare("unaligned rows", columns["f64"][0][1:], valid[1:], None, "max", "f64", 1)
    compare("unaligned rows", columns["i64"][0][1:], valid[1:], seg[1:].to(torch.int32),
            "min", "i64", 256)
    # every row masked, and no row at all
    data = t(i64[:1000])
    for name in ("count", "sum", "min", "max"):
        compare("all masked", data, torch.zeros(1000, dtype=torch.bool, device=dev),
                None, name, "i64", 1)
        compare("empty", data[:0], None, None, name, "i64", 1)
    # the -0.0 vs 0.0 tie on its own: min -> -0.0, max -> 0.0
    for order in ([0.0, -0.0], [-0.0, 0.0]):
        vals = torch.tensor(order * 1000, dtype=torch.float64, device=dev)
        for name, sign in (("min", True), ("max", False)):
            got = KA._segment_aggregate_cuda(vals, None, None, name, "f64", 1)[0]
            want = J.segment_aggregate(vals, None, None, None, name, "f64", 1)[0]
            check(bool(torch.signbit(got)[0]) == sign
                  and max_abs_err(torch, got, want) == 0.0,
                  f"segment_agg {name} breaks the -0.0/0.0 tie wrongly")
    print("  segment_agg all masked, empty, and the -0.0 vs 0.0 tie (min -> -0.0, "
          "max -> 0.0): kernel == plain")

    # timing at the row's shape: an int64 min over Q5's row count, k = 1,
    # int32 segment ids given, no mask
    vals = t(rng.integers(0, 18_000, size=q5_rows, dtype=np.int64))
    seg64 = torch.zeros(q5_rows, dtype=torch.int64, device=dev)
    seg32 = seg64.to(torch.int32)
    big = torch.iinfo(torch.int64).max
    ms = time_ms(torch, lambda: KA._segment_aggregate_cuda(vals, None, seg32, "min", "i64", 1))
    plain_ms = time_ms(torch, lambda: J.segment_aggregate(vals, None, None, seg32, "min", "i64", 1),
                       iters=3, warmup=1)
    # at k = 1 with no dead lane one torch.amin computes the same function;
    # scatter_reduce, the general segment call, is timed beside it
    lib_ms = time_ms(torch, lambda: torch.amin(vals).reshape(1))
    check(int(torch.amin(vals)) == int(KA._segment_aggregate_cuda(
        vals, None, seg32, "min", "i64", 1)[0][0]),
          "segment_agg disagrees with torch.amin at k=1")
    scatter_ms = time_ms(
        torch, lambda: torch.full((1,), big, dtype=torch.int64, device=dev)
        .scatter_reduce(0, seg64, vals, "amin", include_self=True),
        iters=3, warmup=1)
    nbytes = agg_bytes(vals, None, seg32) + 8 + 1
    # per row: the min, the count's add and the segment-id check
    b_ms, b_by = bound(nbytes, 3 * q5_rows)

    # the kernel tier as Q5 calls it: min(c.birthday), captured by a hook
    calls = q5_segment_agg_calls(g1, q5_truth)
    data, valid, seg_j, name, kind, k = calls[0]
    for call in calls:
        compare("Q5's own call", *call)
    tier_ms = time_ms(torch, lambda: KA._segment_aggregate_cuda(*calls[0]))
    tier_plain_ms = time_ms(torch, lambda: J.segment_aggregate(
        data, valid, None, seg_j, name, kind, k), iters=3, warmup=1)
    tier_lib_ms = time_ms(torch, lambda: torch.amin(data).reshape(1))
    tier_b_ms, _ = bound(agg_bytes(data, valid, seg_j) + 9, 2 * int(data.shape[0]))
    tier_shape = (f"{name}({kind}) over {int(data.shape[0])} rows, k={k}, "
                  f"mask {'yes' if valid is not None else 'none'}, segment ids "
                  f"{'none' if seg_j is None else seg_j.dtype}")

    # k = 256, 1,000,000 rows, random int64 ids, a mask: one extra line
    n256 = 1_000_000
    v256 = t(rng.integers(0, 18_000, size=n256, dtype=np.int64))
    s256 = t(rng.integers(0, 256, size=n256, dtype=np.int64))
    m256 = t(rng.random(n256) < 0.9)
    compare("k=256 timing input", v256, m256, s256, "min", "i64", 256)
    k256_ms = time_ms(torch, lambda: KA._segment_aggregate_cuda(v256, m256, s256, "min", "i64", 256))
    report["segment_agg"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_call="torch.amin",
        scatter_reduce_ms=scatter_ms,
        shape=f"Q5 aggregate at SF1: n={q5_rows}, k=1, int64 min, int32 ids, no mask",
        tier_ms=tier_ms, tier_plain_ms=tier_plain_ms, tier_library_ms=tier_lib_ms,
        tier_bound_ms=tier_b_ms, tier_shape=f"Q5's {tier_shape}",
        k256_tier_ms=k256_ms,
    )
    print(f"  segment_agg timing at n={q5_rows}, k=1, int32 ids: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.amin {lib_ms:.4f} ms, Tensor.scatter_reduce "
          f"{scatter_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(f"  segment_agg kernel tier at Q5's {tier_shape}: {tier_ms:.4f} ms, plain "
          f"{tier_plain_ms:.4f} ms, torch.amin {tier_lib_ms:.4f} ms, bound "
          f"{tier_b_ms:.4f} ms")
    print(f"  segment_agg kernel tier at k=256, n={n256}, int64 ids, a mask: "
          f"{k256_ms:.4f} ms")


def segment_agg_calls(pg, query, want, names):
    """Run ``query`` once more on ``pg`` with a hook on the ``segment_agg``
    gate and return the (data, valid, seg_j, name, kind, k) of each of its
    calls: the inputs the main path itself sends. The run's launches are
    not the main path's (the counts are zeroed before phase 4)."""
    from tpu_cypher_torch.backend.cuda import hopper

    calls = []
    inner = hopper.segment_aggregate

    def hook(data, valid, iflag, seg_j, *, name, kind, k):
        check(iflag is None, f"{query}: aggregates carry no int_flag")
        calls.append((data, valid, seg_j, name, kind, k))
        return inner(data, valid, iflag, seg_j, name=name, kind=kind, k=k)

    hopper.segment_aggregate = hook
    try:
        rows = [dict(r) for r in pg.cypher(query).records.collect()]
    finally:
        hopper.segment_aggregate = inner
    check(rows == want, f"{query} (hooked) differs from numpy")
    check([c[3] for c in calls] == names, f"{query} made calls {[c[3] for c in calls]}")
    return calls


def check_segment_agg_q15(torch, g10, q15_truth, report):
    """``segment_agg`` at Q15's own group ids (skewed sizes, numbered in
    first-occurrence order, int64, k = 256): the kernel against its plain
    version, bit for bit, and timed beside its byte bound and
    ``Tensor.scatter_reduce(..., "amin")`` at the same shape."""
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA

    calls = segment_agg_calls(g10, Q15, q15_truth, ["min", "max"])
    err = 0.0
    for data, valid, seg_j, name, kind, k in calls:
        got = KA._segment_aggregate_cuda(data, valid, seg_j, name, kind, k)
        want = J.segment_aggregate(data, valid, None, seg_j, name, kind, k)
        e = tuple_err(torch, got, want)
        err = max(err, e)
        check(e == 0.0, f"segment_agg at Q15's ids, {name}, disagrees with its plain version")
    data, valid, seg_j, name, kind, k = calls[0]
    n = int(data.shape[0])
    check(seg_j is not None and seg_j.dtype == torch.int64 and k == len(q15_truth),
          f"Q15's ids: {None if seg_j is None else seg_j.dtype}, k={k}")
    sizes = torch.bincount(seg_j, minlength=k)
    first = torch.full((k,), n, dtype=torch.int64, device=seg_j.device).scatter_reduce(
        0, seg_j, torch.arange(n, device=seg_j.device), "amin", include_self=True)
    check(bool((first[1:] > first[:-1]).all()), "Q15's ids are not in first-occurrence order")
    ms = time_ms(torch, lambda: KA._segment_aggregate_cuda(data, valid, seg_j, name, kind, k))
    plain_ms = time_ms(torch, lambda: J.segment_aggregate(data, valid, None, seg_j, name, kind, k))
    big = torch.iinfo(torch.int64).max
    scatter_ms = time_ms(
        torch, lambda: torch.full((k,), big, dtype=torch.int64, device=data.device)
        .scatter_reduce(0, seg_j, data, "amin", include_self=True))
    # the min and the validity of k groups written once
    nbytes = agg_bytes(data, valid, seg_j) + 9 * k
    # per row: the min, the count's add and the segment-id check
    b_ms, b_by = bound(nbytes, 3 * n)
    shape = (f"{name}({kind}) over Q15's {n} rows, k={k}, int64 ids in first-occurrence "
             f"order, group sizes {int(sizes.min())}..{int(sizes.max())}, mask "
             f"{'yes' if valid is not None else 'none'}")
    report["segment_agg"].update(
        max_abs_err=max(report["segment_agg"]["max_abs_err"], err),
        q15_ms=ms, q15_plain_ms=plain_ms, q15_scatter_reduce_ms=scatter_ms,
        q15_bound_ms=b_ms, q15_bound_by=b_by, q15_shape=shape,
    )
    print(f"  segment_agg at {shape}: min and max equal to the plain version; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, Tensor.scatter_reduce(amin) "
          f"{scatter_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


def check_segment_agg_q47(torch, session, card, q47_truth, report):
    """``segment_agg`` at Q47's own inputs (min and max of every KNOWS's
    ``creationDate``, a localdatetime: int64 micros, no group ids, k = 1),
    read from a hooked Q47 on the temporal SF10 graph: the kernel against
    its plain version, bit for bit, and the min timed beside its byte
    bound and ``torch.amin``."""
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    gt = temporal_graph(torch, session, card)
    before = dispatch.use_counts()["segment_agg"]
    calls = segment_agg_calls(gt, Q47, q47_truth, ["min", "max"])
    after = dispatch.use_counts()["segment_agg"]
    check(after["kernel"] - before["kernel"] == 2 and after["fallback"] == before["fallback"],
          f"Q47's min and max did not take the kernel tier: {before} -> {after}")
    err = 0.0
    for data, valid, seg_j, name, kind, k in calls:
        check(kind == "ldt" and seg_j is None and k == 1, f"Q47's {name}: {kind}, k={k}")
        got = KA._segment_aggregate_cuda(data, valid, seg_j, name, kind, k)
        want = J.segment_aggregate(data, valid, None, seg_j, name, kind, k)
        e = tuple_err(torch, got, want)
        err = max(err, e)
        check(e == 0.0, f"segment_agg at Q47's inputs, {name}, disagrees with its plain version")
    data, valid, seg_j, name, kind, k = calls[0]
    n = int(data.shape[0])
    ms = time_ms(torch, lambda: KA._segment_aggregate_cuda(data, valid, seg_j, name, kind, k))
    plain_ms = time_ms(torch, lambda: J.segment_aggregate(data, valid, None, seg_j, name, kind, k))
    lib_ms = time_ms(torch, lambda: torch.amin(data))
    # the min and its validity written once; per row a compare
    b_ms, b_by = bound(agg_bytes(data, valid, seg_j) + 9, n)
    shape = (f"min({kind}) over Q47's {n} KNOWS, k=1, no ids, mask "
             f"{'yes' if valid is not None else 'none'}")
    report["segment_agg"].update(
        max_abs_err=max(report["segment_agg"]["max_abs_err"], err),
        q47_ms=ms, q47_plain_ms=plain_ms, q47_library_ms=lib_ms,
        q47_bound_ms=b_ms, q47_bound_by=b_by, q47_shape=shape,
    )
    print(f"  segment_agg at {shape} ({card}): min and max equal to the plain version; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.amin {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    del gt, calls, data, valid


def q6_range_count_calls(torch, g10, want):
    """Run Q6 once more on ``g10`` with a hook on the count tier's
    ``intersect_range_count`` and return the (keys, q, qvalid) of each of
    its calls, in call order: the inputs the main path itself sends. The
    run's launches are not the main path's (the counts are zeroed before
    phase 4)."""
    from tpu_cypher_torch.backend.cuda import hopper

    calls = []
    inner = hopper.intersect_range_count

    def hook(keys, q, qvalid):
        calls.append((keys, q, qvalid))
        return inner(keys, q, qvalid)

    hopper.intersect_range_count = hook
    try:
        rows = [dict(r) for r in g10.cypher(Q6).records.collect()]
    finally:
        hopper.intersect_range_count = inner
    check(rows == [{"triangles": want}], f"Q6 (hooked) {rows} != {want}")
    check(len(calls) == 2, f"Q6 made {len(calls)} range-count calls, expected 2")
    return calls


def intersect_edge_cases(np, rng):
    """(label, keys, q, qvalid) of the range count's edge shapes, the CPU
    tests' at small size: queries at and past the max of a sentinel-free
    power-of-two key list (the case the TPU kernel's completion half-step
    exists for), runs of duplicates, a hub holding most keys, all keys
    equal, one key, queries below kmin and above kmax, negative keys over
    a span of 2**64 - 1, runs on and beside bucket starts, a cluster and
    one far key (empty buckets between them), and keys at a
    bucket's last offset at shift 14, the widest with offsets inline."""
    i64 = np.iinfo(np.int64)
    keys = np.sort(rng.integers(0, 1 << 40, 1 << 20)).astype(np.int64)
    top = int(keys[-1])
    q = np.concatenate([
        np.array([top, top + 1, top + (1 << 30), 1 << 61, 1 << 62], np.int64),
        keys[rng.integers(0, keys.shape[0], 1 << 20)],
        rng.integers(-5, top + 5, 1 << 20).astype(np.int64),
    ])
    yield "2^20 keys, queries past the max", keys, q, rng.random(q.shape[0]) < 0.9
    dup = np.sort(np.repeat(rng.integers(0, 5000, 20000), rng.integers(1, 40, 20000)))
    q = rng.integers(-3, 5003, 3_000_000).astype(np.int64)
    yield "duplicate runs", dup.astype(np.int64), q, rng.random(q.shape[0]) < 0.8
    hub = np.sort(np.concatenate([
        (7 << 20) + rng.integers(0, 4000, 300_000), rng.integers(0, 1 << 40, 20_000),
    ])).astype(np.int64)
    q = np.concatenate([hub[rng.integers(0, hub.shape[0], 500_000)],
                        rng.integers(-5, (1 << 40) + 5, 500_000)]).astype(np.int64)
    yield "a hub holding most keys", hub, q, rng.random(q.shape[0]) < 0.8
    q = np.array([i64.min, 0, 41, 42, 42, 43, i64.max], np.int64)
    yield ("all keys equal", np.full(777, 42, np.int64), q,
           np.array([True, True, True, True, False, True, True]))
    yield ("one key", np.array([-9], np.int64),
           np.array([i64.min, -10, -9, -9, -8, i64.max], np.int64),
           np.array([True, True, True, False, True, True]))
    keys = np.sort(rng.integers(10**6, 2 * 10**6, 50_000)).astype(np.int64)
    q = np.concatenate([np.array([i64.min, i64.max, 10**6 - 1, 2 * 10**6], np.int64),
                        rng.integers(-(10**7), 10**6, 50_000),
                        rng.integers(2 * 10**6, 10**7, 50_000)])
    yield "queries below kmin and above kmax", keys, q, rng.random(q.shape[0]) < 0.9
    body = np.sort(rng.integers(i64.min, i64.max, 100_000, dtype=np.int64))
    keys = np.concatenate([[i64.min, i64.min], body, [i64.max - 1, i64.max]])
    q = np.concatenate([keys[rng.integers(0, keys.shape[0], 100_000)],
                        rng.integers(i64.min, i64.max, 100_000, dtype=np.int64),
                        np.array([i64.min, i64.max, -1, 0, 1], np.int64)])
    yield "negative keys, span 2^64 - 1", keys, q, rng.random(q.shape[0]) < 0.9
    edges = np.arange(1, 256, dtype=np.int64) << 12
    vals = np.concatenate([[0, (1 << 20) - 1], edges, edges - 1, edges + 1])
    keys = np.sort(np.repeat(vals, rng.integers(1, 12, vals.shape[0])))
    q = np.concatenate([vals, vals + 2, rng.integers(-3, (1 << 20) + 3, 100_000)])
    yield "runs on and beside bucket starts", keys, q, rng.random(q.shape[0]) < 0.85
    keys = np.sort(np.concatenate([rng.integers(0, 500_000, 300_000), [2**50, 2**50]]))
    q = np.concatenate([keys, rng.integers(-5, 2**50 + 5, 200_000), [2**49, 2**50 - 1]])
    yield "a cluster and one far key", keys.astype(np.int64), q.astype(np.int64), \
        rng.random(q.shape[0]) < 0.9
    top = np.arange(16, dtype=np.int64) * 2**14 + 2**14 - 1
    keys = np.sort(np.concatenate([[0], top, top[::3], rng.integers(0, 2**18, 15)]))
    q = np.concatenate([top, top - 1, top + 1, keys, [2**18, -1]])
    yield "keys at a bucket's last offset (shift 14)", keys, q, rng.random(q.shape[0]) < 0.9


def check_intersect(torch, g10, tri10, report):
    """``intersect`` held to its plain version bit for bit: lo, counts and
    the total at Q6's two count-tier calls (their own inputs, captured),
    at the edge shapes, each at the real bucket count and at 2 and 16
    buckets; all lanes invalid; an empty query list on the gate's fallback
    tier. Then times it at Q6's arm 0."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.backend.cuda.hopper import intersect as KI

    dev = backend_device()
    rng = np.random.default_rng(SEED)
    err = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, keys, q, qvalid, bits_list=(None,)):
        nonlocal err
        want = KI.range_count_plain(keys, q, qvalid)
        for bits in bits_list:
            lo, counts = KI.range_count_cuda(keys, q, qvalid, bits)
            nb = KI.bucket_bits(int(keys.shape[0])) if bits is None else bits
            e = tuple_err(torch, (lo, counts, torch.sum(counts)), want)
            torch.cuda.synchronize()
            err = max(err, e)
            print(f"  intersect {label}: keys={int(keys.shape[0])} queries="
                  f"{int(q.shape[0])} matches={int(want[2])} buckets=2^{nb} "
                  f"max_abs_err={e}")
            check(e == 0.0, f"intersect {label} (2^{nb} buckets) disagrees with its "
                  f"plain version")

    calls = q6_range_count_calls(torch, g10, tri10)
    for j, call in enumerate(calls):
        compare(f"Q6 SF10 arm {j}", *call)
    for label, keys, q, qvalid in intersect_edge_cases(np, rng):
        compare(label, t(keys), t(q), t(qvalid), (None, 1, 4))
    # all lanes invalid: counts zero, insertion points still written
    keys_r, q_r, _ = calls[0]
    compare("all-invalid lanes", keys_r, q_r[:1_000_000],
            torch.zeros(1_000_000, dtype=torch.bool, device=dev))
    # an empty query list is no call for the kernel: the gate's fallback
    before = dispatch.use_counts()["intersect"]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    lo, counts, total = KI.intersect_range_count(keys_r, empty, empty.bool())
    after = dispatch.use_counts()["intersect"]
    check(lo.shape == (0,) and counts.shape == (0,) and int(total) == 0,
          "intersect on an empty query list")
    check(after["fallback"] == before["fallback"] + 1
          and after["kernel"] == before["kernel"],
          f"empty query list did not take the fallback tier: {before} -> {after}")
    print("  intersect empty query list: fallback tier, no launch")

    report["intersect"] = dict(
        max_abs_err=err, library_call="torch.searchsorted (left and right)",
        **time_intersect(torch, "Q6 arm 0 at SF10", *calls[0]),
    )


def time_intersect(torch, label, keys, q, qvalid, prefix=""):
    """The kernel (index and search), its plain version and the two
    torch.searchsorted calls alone on one call's inputs (mean of 10, CUDA
    events), the index's device time (the kernels of the same call with
    one query lane, ``device_ms``), the bound, and as a yardstick the
    bound of a lower-bound search over all keys a query, as report fields
    named with ``prefix``."""
    from tpu_cypher_torch.backend.cuda.hopper import intersect as KI

    ms = time_ms(torch, lambda: KI.range_count_cuda(keys, q, qvalid), iters=10)
    index_ms = device_ms(torch, lambda: KI.range_count_cuda(keys, q[:1], qvalid[:1]), iters=20)
    plain_ms = time_ms(torch, lambda: KI.range_count_plain(keys, q, qvalid), iters=10)
    lib_ms = time_ms(torch, lambda: (
        torch.searchsorted(keys, q, side="left"),
        torch.searchsorted(keys, q, side="right"),
    ), iters=10)
    nk, nq = int(keys.shape[0]), int(q.shape[0])
    bits = KI.bucket_bits(nk)
    nb = 1 << bits
    start = KI.bucket_start_plain(keys, bits)
    kmin, kmax = int(keys[0]), int(keys[-1])
    shift = max(0, (kmax - kmin).bit_length() - bits)
    inside = (q >= kmin) & (q <= kmax)
    b = (q[inside] - kmin) >> shift  # these shapes' spans are far below 2^63
    size = start[b + 1] - start[b]
    inline = (size <= 6) if shift <= 14 else torch.zeros_like(size, dtype=torch.bool)
    slow = size[~inline].double()
    n_inline, n_valid_inline = int(inline.sum()), int((inline & qvalid[inside]).sum())
    _, want_counts, _ = KI.range_count_plain(keys, q, qvalid)
    hit = want_counts[want_counts > 0]
    run_bits = int(torch.sum(torch.floor(torch.log2(hit.double())) + 1)) if hit.numel() else 0
    # the index's passes: pass 1 fills a run of at most 32 buckets from a
    # key's side and leaves a longer run (a gap) unset; pass 2 searches all
    # keys for each unset bucket, once on its own thread and once on its
    # predecessor's
    kb = (keys - kmin) >> shift
    run = torch.diff(kb, prepend=kb.new_full((1,), -1))
    filled, gap = int(run[run <= 32].sum()), int(run[run > 32].sum())
    bsize = start[1:] - start[:-1]
    inline_keys = int(bsize[bsize <= 6].sum()) if shift <= 14 else 0
    # int32 operations, counted from range_count.cu, of what the function
    # needs on these inputs, a 64-bit add, compare or shift at 2 and a
    # search round at 7 (the half, the index add, the load's address, the
    # int64 compare, the select, the count). The index: per key 16 (its
    # two loads, two bucket numbers, the run test), per bucket pass 1
    # fills 3 (the loop test, the store, the step); per bucket 14 in pass
    # 2 (its two start loads and tests, the inline test, the record's
    # store), per key of an inline bucket 6 (its load, offset, lane and
    # merge), and per search of all keys 8 and ceil(log2(nk)) rounds. The
    # search: per lane 14 (the query load, the two int64 range tests, the
    # bucket's unsigned subtract and shift, the record's load, the
    # stores); an inline lane 31 (its offset, the subtract, shift and
    # mask of 3 words, their sums, lo), 14 more if valid (the count); a
    # lane that searches its bucket 10 (the flag, the end, the last step
    # and the hit test) and ceil(log2(its bucket's keys)) rounds; a hit in
    # such a bucket its run's gallop, about 2 * bit_length(run) rounds
    # (all hits are counted so)
    rounds = torch.where(slow > 1, torch.floor(torch.log2((slow - 1).clamp(min=1))) + 1,
                         torch.zeros_like(slow))
    index_ops = (16 * nk + 3 * filled + 14 * nb + 6 * inline_keys
                 + 2 * gap * (8 + 7 * (nk - 1).bit_length()))
    ops = (index_ops + 14 * nq + 31 * n_inline + 14 * n_valid_inline
           + 10 * int(slow.numel()) + 7 * int(rounds.sum()) + 14 * run_bits)
    nbytes = 8 * nk + 25 * nq
    b_ms, b_by = bound(nbytes, ops)
    # the yardstick: a search over all keys a query, its own bytes
    full_ms, full_by = bound(8 * nk + 25 * nq, nq * (7 * (nk - 1).bit_length() + 7)
                           + 14 * run_bits)
    n_in = int(inside.sum())
    shape = (f"{label}: {nq} queries over {nk} keys, {int(hit.numel())} hits, "
             f"2^{bits} buckets of 2^{shift} values; of the {n_in} queries inside the "
             f"keys' range {n_inline} in a bucket with its keys inline, "
             f"mean bucket {float(size.double().mean()) if n_in else 0.0:.2f} keys, "
             f"{gap} buckets searched for in pass 2")
    print(f"  intersect timing at {shape}: kernel {ms:.4f} ms (device time of the index "
          f"with one query lane {index_ms} ms), plain {plain_ms:.4f} ms, two torch.searchsorted "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; bytes "
          f"{nbytes / MEM_BYTES_PER_S * 1e3:.4f} ms, operations "
          f"{ops / INT32_OPS_PER_S * 1e3:.4f} ms, of them the index's "
          f"{index_ops / INT32_OPS_PER_S * 1e3:.4f} ms; a full search's bound {full_ms:.4f} ms, "
          f"{full_by})")
    return {f"{prefix}ms": ms, f"{prefix}index_ms": index_ms, f"{prefix}plain_ms": plain_ms,
            f"{prefix}library_ms": lib_ms, f"{prefix}bound_ms": b_ms,
            f"{prefix}bound_by": b_by, f"{prefix}full_search_bound_ms": full_ms,
            f"{prefix}full_search_bound_by": full_by, f"{prefix}shape": shape}


def q11_join_probe_calls(g10, want):
    """Run Q11 once more on ``g10`` with a hook on the ``join_probe`` gate
    and return the (rd, r_order, ld, lvalids, nvalid, is_f64, is_bool) of
    each of its calls: the inputs the main path itself sends. The run's
    launches are not the main path's (the counts are zeroed before phase
    4)."""
    from tpu_cypher_torch.backend.cuda import hopper

    calls = []
    inner = hopper.join_probe

    def hook(rd, r_order, ld, lvalids, nvalid, *, is_f64, is_bool):
        calls.append((rd, r_order, ld, lvalids, nvalid, is_f64, is_bool))
        return inner(rd, r_order, ld, lvalids, nvalid, is_f64=is_f64, is_bool=is_bool)

    hopper.join_probe = hook
    try:
        rows = [dict(r) for r in g10.cypher(Q11).records.collect()]
    finally:
        hopper.join_probe = inner
    check(rows == [{"n": want}], f"Q11 (hooked) {rows} != {want}")
    check(len(calls) == 1, f"Q11 made {len(calls)} join_probe calls, expected 1")
    return calls[0]


def probe_steps(torch, table, max_off, q, qvalid):
    """Table slots that ``hash_probe.cu`` reads for these probe lanes: each
    valid lane walks from its hash slot until it finds its key or an empty
    slot, or passes the build's bound."""
    from tpu_cypher_torch.backend.cuda.hopper import join as KJ

    size = int(table.shape[0])
    keys = table.view(torch.int64)[:, 0]
    h = KJ.slot_hash(q, size)
    live = qvalid.clone() if qvalid is not None else torch.ones_like(q, dtype=torch.bool)
    steps = 0
    for t in range(max_off + 1):
        s = (h + t) & (size - 1)
        steps += int(live.sum())
        live = live & (table[s, 3] != 0) & (keys[s] != q)
    return steps


def join_key_bytes(x, is_f64):
    """Bytes a key of ``x`` takes as the join kernels read it."""
    return 8 if is_f64 else x.element_size()


def check_join_probe(torch, g10, q11_truth, report):
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.backend.cuda.hopper import join as KJ

    dev = backend_device()
    rng = np.random.default_rng(SEED)
    err = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, rd_s, order, ld, lvalids, nvalid, is_bool=False,
                is_f64=False):
        """The kernel tier (the memset, the build and the probe) against
        the plain version bit for bit, and the build kernel's table against
        its plain version ``hash_build`` by ``table_invariants``. Returns
        the case's table, its probe's byte and operation counts and bound
        (bytes at the probe key's own width)."""
        nonlocal err
        got = KJ._join_probe_kernel_tier(rd_s, order, ld, lvalids, nvalid, is_f64)
        want = J.join_probe(rd_s, order, ld, lvalids, nvalid, is_f64=is_f64,
                            is_bool=is_bool)
        torch.cuda.synchronize()
        e = tuple_err(torch, got, want)
        size = KJ.table_size(nvalid)
        table = KJ.hash_build_cuda(rd_s, order, nvalid, size, is_f64)
        keys, q64, qvalid = KJ.plain_keys(rd_s, order, nvalid, ld, lvalids, is_f64)
        bound_off = int(table[size, 0])
        problems = KJ.table_invariants(table[:size], bound_off, keys)
        err = max(err, e, 1.0 if problems else 0.0)
        uniq = int((table[:size, 3] > 0).sum())
        nq = int(ld.shape[0])
        # per lane the key at its width, a byte a mask, 8 B lo and 8 B
        # count; the slots once. int32 operations, counted from
        # hash_probe.cu: per lane 10 (the chunk loop's share, the masks'
        # ANDs, the hash's two multiplies, xor and shift, the stores'
        # addresses, the count's add), per slot read 10 (the index add and
        # mask, the address, the empty test, the key assembly's shift and
        # or, the 64-bit compare at 2, the step and its test). This run's
        # data decides the slot reads
        nbytes = nq * (join_key_bytes(ld, is_f64) + len(lvalids) + 16) + 16 * size
        steps = probe_steps(torch, table[:size], bound_off, q64, qvalid)
        ops = 10 * nq + 10 * steps
        b_ms, b_by = bound(nbytes, ops)
        print(f"  join_probe {label}: build {nvalid} valid rows, {uniq} unique "
              f"keys in {size} slots, probe bound {bound_off}, build kernel's table "
              f"{'holds' if not problems else 'BREAKS'} table_invariants; probe {nq} "
              f"lanes of {join_key_bytes(ld, is_f64)} B keys, {len(lvalids)} masks, "
              f"{steps} slot reads, matches {int(want[3])}; probe bound {b_ms:.4f} ms "
              f"({b_by}); max_abs_err={e}")
        check(e == 0.0, f"join_probe {label} disagrees with its plain version")
        check(not problems, f"join_probe {label}: the build kernel's table: {problems}")
        return dict(table=table, size=size, bound_off=bound_off, uniq=uniq, steps=steps,
                    nbytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by)

    def build(rd, rvalid=None, is_bool=False, is_f64=False):
        rvalids = (rvalid,) if rvalid is not None else ()
        rd_s, order, nv = J.join_build(rd, rvalids, is_f64=is_f64, is_bool=is_bool)
        return rd_s, order, int(nv)

    q11 = q11_join_probe_calls(g10, q11_truth)
    rd_s, order, ld, lvalids, nvalid, is_f64, is_bool = q11
    check(not is_f64 and not is_bool, "Q11 joins on an I64 key")
    at_q11 = compare("Q11 SF10", rd_s, order, ld, lvalids, nvalid)
    compare("all-invalid probe", rd_s, order, ld,
            (torch.zeros(ld.shape[0], dtype=torch.bool, device=dev),), nvalid)
    # one key repeated nvalid times: one slot, one run
    rep = t(np.full(100_000, 5 << 54, np.int64))
    q = t(np.where(rng.random(1_000_000) < 0.5, 5 << 54, 6 << 54).astype(np.int64))
    rd_s1, order1, nv1 = build(rep)
    compare("single key repeated", rd_s1, order1, q, (), nv1)
    # graph-tagged keys at bit 54 and up, negative keys (sign in hi32), nulls
    tagged = rng.integers(0, 1 << 20, 500_000) | (3 << 54)
    tagged[:50_000] = -tagged[:50_000]
    qk = np.concatenate([tagged[rng.integers(0, 500_000, 1_000_000)],
                         rng.integers(0, 1 << 20, 1_000_000) | (3 << 54)])
    rd_s2, order2, nv2 = build(t(tagged), t(rng.random(500_000) < 0.9))
    compare("keys tagged at 2^54", rd_s2, order2, t(qk),
            (t(rng.random(qk.shape[0]) < 0.9),), nv2)
    # STR dictionary codes (int32, nulls as -1 with a validity mask)
    codes = rng.integers(-1, 50_000, 200_000).astype(np.int32)
    qc = t(rng.integers(-1, 60_000, 2_000_000).astype(np.int32))
    qc_valid = (qc >= 0,)
    rd_s3, order3, nv3 = build(t(codes), t(codes >= 0))
    at_str = compare("STR codes", rd_s3, order3, qc, qc_valid, nv3)
    # bool keys: the build side sorts as int8
    rd_s4, order4, nv4 = build(t(rng.random(50_000) < 0.3), None, is_bool=True)
    compare("bool keys", rd_s4, order4, t(rng.random(1_000_000) < 0.5), (), nv4,
            is_bool=True)
    # more than 2^20 unique build keys: no build cap remains, and the most
    # CAS claims at once
    big = rng.permutation(1 << 22)[: (1 << 20) + 300_000].astype(np.int64) * 977
    qb = np.concatenate([big[rng.integers(0, big.shape[0], 2_000_000)],
                         rng.integers(0, 1 << 32, 2_000_000)])
    rd_s5, order5, nv5 = build(t(big))
    compare("2^20 + 300,000 unique keys", rd_s5, order5, t(qb), (), nv5)
    # float keys: -0.0 and 0.0 one key, NaN keys invalid on both sides,
    # nulls, infinities
    fv = np.array([-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, np.nan, 1e300, 5e-324])
    base = fv[rng.integers(0, fv.shape[0], 300_000)]
    fr = np.where(rng.random(300_000) < 0.5, base,
                  base + rng.integers(1, 50_000, 300_000))
    fq = np.concatenate([fr[rng.integers(0, fr.shape[0], 1_500_000)],
                         fv[rng.integers(0, fv.shape[0], 500_000)]])
    rd_s6, order6, nv6 = build(t(fr), t(rng.random(fr.shape[0]) < 0.9), is_f64=True)
    compare("F64 keys with -0.0, NaN, nulls", rd_s6, order6, t(fq),
            (t(rng.random(fq.shape[0]) < 0.9),), nv6, is_f64=True)
    # a build with no valid key: a table of empty slots, probed all the same
    rd_s7, order7, nv7 = build(t(tagged), t(np.zeros(tagged.shape[0], bool)))
    check(nv7 == 0, "the all-null build has valid keys")
    compare("no valid build key", rd_s7, order7, t(qk), (), nv7)
    # an empty probe is no call for the kernel: the gate's fallback
    before = dispatch.use_counts()["join_probe"]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    _, lo, counts, total = KJ.join_probe(rd_s, order, empty, (), nvalid,
                                         is_f64=False, is_bool=False)
    after = dispatch.use_counts()["join_probe"]
    check(lo.shape == (0,) and counts.shape == (0,) and int(total) == 0,
          "join_probe on an empty probe")
    check(after["fallback"] == before["fallback"] + 1
          and after["kernel"] == before["kernel"],
          f"empty probe did not take the fallback tier: {before} -> {after}")
    print("  join_probe empty probe: fallback tier, no launch")

    # timing at Q11's probe: the build (memset and kernel) and the probe
    # kernel apart, the kernel tier as the gate runs it, by CUDA events and
    # by its device activities (torch.profiler: how many a call, and their
    # time), the build's plain version, the plain version, and two
    # torch.searchsorted over the sorted build keys; then the probe at the
    # STR-codes case
    size, table = at_q11["size"], at_q11["table"]
    build_ms = time_ms(torch, lambda: KJ.hash_build_cuda(rd_s, order, nvalid, size))
    ms = time_ms(torch, lambda: KJ.hash_probe_cuda(table, ld, lvalids))
    tier = lambda: KJ._join_probe_kernel_tier(rd_s, order, ld, lvalids, nvalid, False)  # noqa: E731
    tier_ms = time_ms(torch, tier)
    iters = 50
    events = device_events(torch, tier, iters=iters)
    tier_ops = sum(n for n, _ in events.values()) / iters
    tier_device_ms = (sum(us for _, us in events.values()) / 1e3 / iters) if events else None
    # three kinds of device operation, each about once a call (the profiler
    # may drop an event of the trace)
    check(not events or (len(events) == 3 and abs(tier_ops - 3) < 0.1),
          f"the kernel tier ran {tier_ops} device operations a call, not 3: {sorted(events)}")
    keys = KJ.plain_keys(rd_s, order, nvalid, ld, lvalids, False)[0]
    plain_build_ms = time_ms(torch, lambda: KJ.hash_build(keys), iters=10)
    plain_ms = time_ms(torch, lambda: J.join_probe(
        rd_s, order, ld, lvalids, nvalid, is_f64=False, is_bool=False))
    r_sorted = rd_s[order[:nvalid]]
    lib_ms = time_ms(torch, lambda: (
        torch.searchsorted(r_sorted, ld, side="left"),
        torch.searchsorted(r_sorted, ld, side="right"),
    ))
    str_ms = time_ms(torch, lambda: KJ.hash_probe_cuda(at_str["table"], qc, qc_valid))
    nq = int(ld.shape[0])
    # the build's bytes: per valid row its 8 B sorted position and its key
    # read, and the table (slots and the bound row) written once; no single
    # PyTorch call builds an open-addressing table, so it has no library
    # time
    build_bound_ms, _ = bound(nvalid * (8 + join_key_bytes(rd_s, False)) + 16 * (size + 1), 0)
    report["join_probe"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=at_q11["bound_ms"],
        bound_by=at_q11["bound_by"], library_ms=lib_ms,
        library_call="torch.searchsorted (left and right) over the sorted build keys",
        build_ms=build_ms, build_bound_ms=build_bound_ms, build_bound_by="bytes",
        build_library_ms=None, tier_ms=tier_ms, tier_device_ms=tier_device_ms,
        tier_device_ops=tier_ops,
        tier_device_by_name={k: [n / iters, us / 1e3 / iters] for k, (n, us) in events.items()},
        plain_build_ms=plain_build_ms, str_codes_ms=str_ms,
        str_codes_bound_ms=at_str["bound_ms"], str_codes_bound_by=at_str["bound_by"],
        shape=(f"Q11 at SF10: {nq} probe lanes, {nvalid}-row build, "
               f"{at_q11['uniq']} unique keys in {size} slots, "
               f"probe bound {at_q11['bound_off']}, {at_q11['steps']} slot reads; "
               f"STR codes: {int(qc.shape[0])} int32 probe lanes, one mask, "
               f"{nv3}-row build"),
    )
    by_name = ", ".join(f"{k[:48]} {n / iters:g}x {us / 1e3 / iters:.4f} ms"
                        for k, (n, us) in sorted(events.items()))
    print(f"  join_probe timing at Q11: probe kernel {ms:.4f} ms, build (memset and "
          f"kernel) {build_ms:.4f} ms, kernel tier as the gate runs it {tier_ms:.4f} ms, "
          f"its device time {tier_device_ms} ms in {tier_ops:g} device operations a "
          f"call ({by_name}); build's plain version (torch ops) {plain_build_ms:.4f} ms, "
          f"plain version {plain_ms:.4f} ms, two torch.searchsorted {lib_ms:.4f} ms; "
          f"bound {at_q11['bound_ms']:.4f} ms ({at_q11['bound_by']}); {at_q11['steps']} "
          f"slot reads over {nq} lanes; the build's bound {build_bound_ms:.5f} ms "
          f"(bytes); STR codes probe {str_ms:.4f} ms against its bound "
          f"{at_str['bound_ms']:.4f} ms ({at_str['bound_by']})")


def check_expand_rows_walks(torch, g10, q17_truth, q18_params, q18_truth, report):
    """``expand_rows`` at the chain walk's shapes, held to its plain version
    bit for bit (pads included) and timed (mean of 20, CUDA events) against
    its byte bound: Q17's final hop (SF10, the 2-hop DISTINCT: the middle
    hop's lanes as frontier, without orig) and Q18's third hop (bench.py
    VAR_LENGTH, with orig). The inputs are those of an extra Q17 and Q18
    run, captured there; at Q17 also the final hop whole (the kernel's
    merge, then ``distinct_pairs_count_final``) and its sort alone."""
    from tpu_cypher_torch.backend.cuda import expand_op as PX
    from tpu_cypher_torch.backend.cuda import hopper
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX

    finals = []
    inner = J.distinct_pairs_count_final

    def final_hook(lanes, *args, **kwargs):
        finals.append((args, kwargs))
        return inner(lanes, *args, **kwargs)

    J.distinct_pairs_count_final = final_hook
    try:
        calls, rows = q_hooked_calls(g10, Q17, PX, "_walk_lanes")
    finally:
        J.distinct_pairs_count_final = inner
    check(rows == [{"pairs": q17_truth}] and len(calls) == 2 and len(finals) == 1,
          f"Q17 (hooked) {rows} != {q17_truth}, {len(calls)} merges, "
          f"{len(finals)} final hops")
    rp, ci, _, pos, deg, q17_size, nvalid, with_orig = calls[1][0]
    check(nvalid is None and not with_orig, "Q17's final hop is not an exact merge "
          "without orig")
    (akey, mask), f_kwargs = finals[0]
    n = f_kwargs["num_nodes"]
    gate = {"q17": ((rp, ci, None, pos, deg, q17_size), q17_size, False)}
    calls, rows = q_hooked_calls(g10, Q18, hopper, "expand_materialize_counted",
                                 q18_params)
    check(len(calls) == 3, f"Q18 made {len(calls)} expand calls, expected 3")
    check(rows == [{"walks": q18_truth}], f"Q18 (hooked) {rows} != {q18_truth}")
    args, kwargs = calls[2]
    check(kwargs["with_orig"] is True, "Q18's third hop asked for no orig")
    gate["q18"] = (args, kwargs["size"], True)
    err = report["expand_rows"]["max_abs_err"]
    for key, (args, size, with_orig) in gate.items():
        got = KX.expand_materialize_counted_cuda(*args, size, with_orig)
        want = J.expand_materialize_counted(*args, size, with_orig=with_orig)
        torch.cuda.synchronize()
        e = tuple_err(torch, got, want)
        del got, want
        err = max(err, e)
        f = int(args[3].shape[0])
        shape = (f"F={f}, {size} lanes, {'with' if with_orig else 'without'} orig")
        check(e == 0.0, f"expand_rows at {key.upper()} ({shape}) disagrees with its "
              f"plain version")
        ms = time_ms(torch, lambda: KX.expand_materialize_counted_cuda(
            *args, size, with_orig))
        plain_ms = time_ms(torch, lambda: J.expand_materialize_counted(
            *args, size, with_orig=with_orig), iters=3, warmup=1)
        cum, _ = KX.frontier_state(args[0], args[3], args[4])
        lanes = torch.arange(size, dtype=torch.int32, device=cum.device)
        lib_ms = time_ms(torch, lambda: torch.searchsorted(cum, lanes, right=True))
        del cum, lanes
        b_ms, b_by, ops_ms = expand_bound(torch, args[3], args[4], min(int(args[5]), size),
                                          size, with_orig, KX.TILE_ITEMS)
        report["expand_rows"].update({
            f"{key}_tier_ms": ms, f"{key}_plain_ms": plain_ms, f"{key}_library_ms": lib_ms,
            f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
            f"{key}_ops_bound_ms": ops_ms, f"{key}_max_abs_err": e,
            f"{key}_shape": shape,
        })
        print(f"  expand_rows tier at {key.upper()}'s "
              f"{'final' if key == 'q17' else 'third'} hop ({shape}): bit-identical, "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; operations {ops_ms:.4f} ms)")
    report["expand_rows"]["max_abs_err"] = err

    def final_hop():  # Q17's final hop whole, as the walk runs it
        lanes = list(KX.expand_materialize_counted_cuda(rp, ci, None, pos, deg, q17_size,
                                                        q17_size, False))
        lanes[3] = None  # an exact merge: every lane is live
        return J.distinct_pairs_count_final(lanes, akey, mask, **f_kwargs)

    final_ms = time_ms(torch, final_hop, iters=5, warmup=1)
    # and its sort alone, on the hop's packed keys
    row, nbr, _, _ = KX.expand_materialize_counted_cuda(rp, ci, None, pos, deg, q17_size,
                                                        q17_size, False)
    keys = akey[row] * n + nbr
    del row, nbr
    sort_ms = time_ms(torch, lambda: torch.sort(keys), iters=10, warmup=2)
    del keys
    report["expand_rows"].update(q17_final_hop_ms=final_ms, q17_sort_ms=sort_ms)
    print(f"  Q17's final hop (merge, distinct_pairs_count_final): {final_ms:.4f} ms, "
          f"of which torch.sort of its {q17_size} packed keys {sort_ms:.4f} ms")


def check_explode(torch, g10, q31_truth, report):
    """The explode's ``expand_rows`` launch at Q31 (UNWIND of the 100,000
    lists ``collect`` built from SF10's KNOWS: the offsets as row pointers,
    the valid rows as frontier, the lengths as degrees, without orig), held
    to its plain version bit for bit and timed (mean of 20, CUDA events)
    against its byte bound. The inputs are those of an extra Q31 run,
    captured there; its last gate call is the explode's."""
    from tpu_cypher_torch.backend.cuda import hopper
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX

    calls, rows = q_hooked_calls(g10, Q31, hopper, "expand_materialize_counted")
    check(rows == [q31_truth], f"Q31 (hooked) {rows} != {q31_truth}")
    args, kwargs = calls[-1]
    size = kwargs["size"]
    check(not kwargs["with_orig"] and size == q31_truth["n"],
          f"Q31's last expand_rows call is not the explode's ({size} lanes)")
    got = KX.expand_materialize_counted_cuda(*args, size, False)
    want = J.expand_materialize_counted(*args, size, with_orig=False)
    torch.cuda.synchronize()
    e = tuple_err(torch, got, want)
    del got, want
    f = int(args[3].shape[0])
    shape = f"F={f} lists, {size} lanes, without orig"
    check(e == 0.0, f"expand_rows at Q31's explode ({shape}) disagrees with its plain version")
    ms = time_ms(torch, lambda: KX.expand_materialize_counted_cuda(*args, size, False))
    plain_ms = time_ms(torch, lambda: J.expand_materialize_counted(
        *args, size, with_orig=False), iters=3, warmup=1)
    cum, _ = KX.frontier_state(args[0], args[3], args[4])
    lanes = torch.arange(size, dtype=torch.int32, device=cum.device)
    lib_ms = time_ms(torch, lambda: torch.searchsorted(cum, lanes, right=True))
    del cum, lanes
    b_ms, b_by, ops_ms = expand_bound(torch, args[3], args[4], size, size, False,
                                      KX.TILE_ITEMS)
    er = report["expand_rows"]
    er["max_abs_err"] = max(er["max_abs_err"], e)
    er.update(q31_explode_ms=ms, q31_explode_plain_ms=plain_ms,
              q31_explode_library_ms=lib_ms, q31_explode_bound_ms=b_ms,
              q31_explode_bound_by=b_by, q31_explode_shape=shape)
    print(f"  expand_rows tier at Q31's explode ({shape}): bit-identical, {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; operations {ops_ms:.4f} ms)")


def check_two_streams(torch, session, g10, rounds=30):
    """``segment_agg``, ``frontier_deg_sum`` and ``expand_rows``, whose
    launches keep tickets and partials in a scratch buffer, and
    ``intersect``, whose index table each launch allocates on its own
    stream, launched at once on two side streams with different inputs
    for ``rounds`` rounds: every answer must equal its plain version. Each
    stream compares its own answers as it goes, so the check holds only
    two rounds in memory."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex
    from tpu_cypher_torch.backend.cuda.hopper import aggregate as KA
    from tpu_cypher_torch.backend.cuda.hopper import expand as KX
    from tpu_cypher_torch.backend.cuda.hopper import frontier as KF
    from tpu_cypher_torch.backend.cuda.hopper import intersect as KI

    dev = backend_device()
    rng = np.random.default_rng(SEED + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ctx = session._runtime_context({})
    gi = GraphIndex.of(g10._graph)
    gi.node_ids(ctx)
    rp, ci, eo = gi.csr(("KNOWS",), False, ctx)
    v = gi.num_nodes
    n, f = 4_000_000, 3_000_000
    work = []
    for name, density in (("min", 0.9), ("max", 0.5)):
        seg = (t(rng.integers(-(2**40), 2**40, n)), t(rng.random(n) < density),
               t(rng.integers(0, 256, n)), name, "i64", 256)
        fr = (rp, t(rng.integers(0, v, f)), t(rng.random(f) < density))
        pos = t(rng.integers(0, v, v))
        deg, total = J.expand_degrees_total(rp, pos, t(rng.random(v) < density))
        ex = (rp, ci, eo, pos, deg, int(total), int(total))
        keys = torch.sort(t(rng.integers(0, 1 << 34, f))).values
        iq = torch.cat([keys[t(rng.integers(0, f, n // 2))], t(rng.integers(0, 1 << 34, n // 2))])
        rc = (keys, iq, t(rng.random(n) < density))
        want = (
            J.segment_aggregate(seg[0], seg[1], None, seg[2], name, "i64", 256),
            KF.deg_sum_plain(*fr),
            J.expand_materialize_counted(*ex),
            KI.range_count_plain(*rc)[:2],
        )
        work.append((seg, fr, ex, rc, want))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in work]
    bad = [torch.zeros((), dtype=torch.bool, device=dev) for _ in work]
    for _ in range(rounds):
        for i, (stream, (seg, fr, ex, rc, want)) in enumerate(zip(streams, work)):
            with torch.cuda.stream(stream):
                got = (
                    KA._segment_aggregate_cuda(seg[0], seg[1], seg[2], *seg[3:]),
                    (KF.deg_sum_cuda(*fr),),
                    KX.expand_materialize_counted_cuda(*ex),
                    KI.range_count_cuda(*rc),
                )
                for g_t, w_t in zip(got, (want[0], (want[1],), want[2], want[3])):
                    for a, b in zip(g_t, w_t):
                        if a is None or b is None:
                            check(a is None and b is None, "two streams: a missing output")
                            continue
                        check(a.dtype == b.dtype and a.shape == b.shape,
                              "two streams: an output's dtype or shape differs")
                        bad[i] = bad[i] | (a != b).any()
    torch.cuda.synchronize()
    check(not any(bool(b) for b in bad),
          f"two streams: an answer differs from its plain version ({[bool(b) for b in bad]})")
    print(f"  two side streams, {rounds} rounds each of segment_agg (k=256, {n} rows), "
          f"frontier_deg_sum (F={f}), expand_rows (F={v}) and intersect ({n} queries "
          f"over {f} keys) on different inputs: every answer equal to its plain version")


def q_hooked_calls(pg, query, module, name, params=None):
    """Run ``query`` once with a hook on ``module.name`` and return the
    (args, kwargs) of each call, and the rows."""
    calls = []
    inner = getattr(module, name)

    def hook(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, hook)
    try:
        rows = [dict(r) for r in pg.cypher(query, params).records.collect()]
    finally:
        setattr(module, name, inner)
    return calls, rows


def time_materializes(torch, g1, g10, q11_truth, q7_rows):
    """``join_materialize`` at Q11, the torch-op repeat cascade the expand
    kernel could also answer, and the WCOJ materialize's decode at Q7
    (``factorized.decode_lanes``, on the ``expand_rows`` gate), timed on
    the arguments the queries hand them (captured with a hook), with their
    byte bounds."""
    from tpu_cypher_torch.backend.cuda import factorized as FZ
    from tpu_cypher_torch.backend.cuda import jit_ops as J

    calls, rows = q_hooked_calls(g10, Q11, J, "join_materialize")
    check(rows == [{"n": q11_truth}] and len(calls) == 1, "Q11 (hooked join_materialize)")
    args, kwargs = calls[0]
    r_idx_valid, lo, _, total = args
    ms = time_ms(torch, lambda: J.join_materialize(*args, **kwargs), iters=10)
    # reads: lo and counts per probe row, the valid build rows; writes: the
    # left and right row of each pair
    nbytes = 16 * int(lo.shape[0]) + 8 * int(r_idx_valid.shape[0]) + 16 * int(total)
    b_ms, _ = bound(nbytes, 0)
    print(f"  join_materialize at Q11 (torch ops): {int(total)} pairs from "
          f"{int(lo.shape[0])} probe rows: {ms:.4f} ms, byte bound {b_ms:.4f} ms")
    calls, rows = q_hooked_calls(g1, Q7, FZ, "decode_lanes")
    check(len(rows) == q7_rows and len(calls) == 1, "Q7 (hooked decode_lanes)")
    args, _ = calls[0]
    W, w, lo, hi = args
    ms7 = time_ms(torch, lambda: FZ.decode_lanes(*args), iters=10)
    # reads: each lane's weight; writes: each row's lane and remainder
    nbytes7 = 8 * int(w.shape[0]) + 16 * (hi - lo)
    b7_ms, _ = bound(nbytes7, 0)
    print(f"  decode_lanes at Q7 (the expand_rows gate): {hi - lo} rows from "
          f"{int(w.shape[0])} lanes: {ms7:.4f} ms, byte bound {b7_ms:.4f} ms")


def check_close_shapes(torch, g1, g10, g10h, truth, report):
    """The closing ExpandInto's and the fused OPTIONAL expand's shapes, on
    inputs captured from an extra run of each query: ``intersect`` at
    Q22's probes (the final hop's lanes over the KNOWS keys, both
    orientations) and at Q23's (the reference's own plan: Q6 under
    ``off``) held to its plain version bit for bit and timed as at Q6 at
    Q22's first probe and Q23's; the optional lane merge (``expand_op._optional_lanes``: the
    ``expand_rows`` kernel tier, then ``optional_place``) at Q25's and
    Q26's frontiers held to ``jit_ops.optional_expand_materialize`` bit
    for bit on every lane's row and match flag and every matched lane's
    neighbour and edge (an unmatched lane's are masked null downstream)
    and timed (mean of 20; the plain version of 3) against its byte
    bound; and ``into_materialize_counted`` (torch ops) at Q24's first
    probe half against its byte bound."""
    from tpu_cypher_torch.backend.cuda import expand_op as PX
    from tpu_cypher_torch.backend.cuda import hopper
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import intersect as KI

    calls, rows = q_hooked_calls(g10, Q22, hopper, "intersect_range_count")
    check(rows == [{"t": truth["Q22"]}] and len(calls) == 2,
          f"Q22 (hooked) {rows} != {truth['Q22']}, {len(calls)} probes")
    with wcoj_mode("off"):
        calls23, rows = q_hooked_calls(g10, Q23, hopper, "intersect_range_count")
    check(rows == [{"triangles": truth["Q23"]}] and len(calls23) == 1,
          f"Q23 (hooked) {rows} != {truth['Q23']}, {len(calls23)} probes")
    err = report["intersect"]["max_abs_err"]
    probes = [(f"Q22 SF10 orientation {j}", call) for j, (call, _) in enumerate(calls)]
    probes.append(("Q23 SF10 (off)", calls23[0][0]))
    for label, (keys, q, qvalid) in probes:
        lo, counts = KI.range_count_cuda(keys, q, qvalid)
        e = tuple_err(torch, (lo, counts, torch.sum(counts)),
                      KI.range_count_plain(keys, q, qvalid))
        del lo, counts
        err = max(err, e)
        check(e == 0.0, f"intersect at {label}'s probe disagrees with its plain version")
        print(f"  intersect {label}: keys={int(keys.shape[0])} "
              f"queries={int(q.shape[0])} max_abs_err={e}")
    report["intersect"]["max_abs_err"] = err
    report["intersect"].update(time_intersect(
        torch, "Q22's first probe at SF10", *calls[0][0], prefix="q22_"))
    report["intersect"].update(time_intersect(
        torch, "Q23's probe at SF10", *calls23[0][0], prefix="q23_"))
    del calls, calls23, probes, keys, q, qvalid

    err = report["expand_rows"]["max_abs_err"]
    for key, pg, query, ok in (
        ("q25", g10, Q25, lambda rows: rows == [truth["Q25"]]),
        ("q26", g10h, Q26, lambda rows: [(r["b"], r["a"]) for r in rows] == truth["Q26"]),
    ):
        calls, rows = q_hooked_calls(pg, query, PX, "_optional_lanes")
        check(ok(rows) and len(calls) == 1, f"{key.upper()} (hooked) gave other rows")
        args = calls[0][0]
        rp, ci, eo, pos, deg, counts, total, matched_total = args
        got = PX._optional_lanes(*args)
        want = J.optional_expand_materialize(rp, ci, eo, pos, deg, counts, total)
        hit = want[3]
        e = tuple_err(torch, (got[0], got[3], got[1][hit], got[2][hit]),
                      (want[0], want[3], want[1][hit], want[2][hit]))
        del got, want, hit
        err = max(err, e)
        f = int(pos.shape[0])
        shape = (f"F={f}, {total} lanes, {matched_total} matched, "
                 f"{total - matched_total} null-padded")
        check(e == 0.0, f"the optional lane merge at {key.upper()} ({shape}) disagrees "
              f"with its plain version")
        ms = time_ms(torch, lambda: PX._optional_lanes(*args))
        plain_ms = time_ms(torch, lambda: J.optional_expand_materialize(
            rp, ci, eo, pos, deg, counts, total), iters=3, warmup=1)
        cum = torch.cumsum(counts, 0)
        lanes = torch.arange(total, device=cum.device)
        lib_ms = time_ms(torch, lambda: torch.searchsorted(cum, lanes, right=True))
        del cum, lanes
        # per frontier row pos, deg, counts and rp[pos] (28 B); per matched
        # lane ci and eo (12 B); per lane row, nbr, orig and matched (25 B)
        b_ms, b_by = bound(28 * f + 12 * matched_total + 25 * total, 0)
        report["expand_rows"].update({
            f"{key}_merge_ms": ms, f"{key}_merge_plain_ms": plain_ms,
            f"{key}_merge_library_ms": lib_ms, f"{key}_merge_bound_ms": b_ms,
            f"{key}_merge_max_abs_err": e, f"{key}_merge_shape": shape,
        })
        print(f"  optional lane merge at {key.upper()} ({shape}): bit-identical on rows, "
              f"match flags and matched lanes, "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    report["expand_rows"]["max_abs_err"] = err

    calls, rows = q_hooked_calls(g1, Q24, J, "into_materialize_counted")
    got = {r["a"]: r["n"] for r in rows}
    check(got == truth["Q24"] and len(calls) == 2, "Q24 (hooked into_materialize_counted)")
    args, kw = calls[0]
    eo, lo, _, total = args
    ms = time_ms(torch, lambda: J.into_materialize_counted(*args, **kw), iters=10)
    # reads: lo and counts per query, eo per lane; writes: row, orig, live
    b_ms, _ = bound(16 * int(lo.shape[0]) + 25 * int(total), 0)
    print(f"  into_materialize_counted at Q24's first probe half (torch ops): {int(total)} "
          f"lanes from {int(lo.shape[0])} queries: {ms:.4f} ms, byte bound {b_ms:.4f} ms")


# ---------------------------------------------------------------------------
# phase 4: the slice through CypherSession.cuda()
# ---------------------------------------------------------------------------


def triangle_truth(ids, src, dst, rows_and_cliques):
    """scipy ground truth over the generator's arrays, with edge
    multiplicity: the directed triangle count trace(A^3), the per-edge
    sum of min(out(b), in(a)) (the count tier's expanded lanes), and per
    node a the 2-paths a->b->c closed by an undirected c-a edge (A^2 o A^T
    plus A^2 o A, by row: Q22 and Q24); with ``rows_and_cliques`` also the
    triangle rows (a, b, c, multiplicity) and the 4-clique count. The
    graphs are loop-free (checked), so distinct endpoints force distinct
    relationships, and no undirected close is a self-loop."""
    import numpy as np
    import scipy.sparse as sp

    check(not (src == dst).any(), "generated graph has a self-loop")
    n = len(ids)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    A = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
    A.sum_duplicates()
    AT = A.T.tocsr()
    out_deg = np.bincount(s, minlength=n)
    in_deg = np.bincount(d, minlength=n)
    truth = {"min_lanes": int(np.minimum(out_deg[d], in_deg[s]).sum())}
    tri = 0
    step = 4096
    close_rows = np.zeros(n, np.int64)
    for lo in range(0, n, step):  # trace(A^3) = sum(A^2 o A^T), by row block
        paths = A[lo:lo + step] @ A
        closed = np.asarray(paths.multiply(AT[lo:lo + step]).sum(axis=1)).ravel()
        tri += int(closed.sum())
        close_rows[lo:lo + step] = closed + np.asarray(
            paths.multiply(A[lo:lo + step]).sum(axis=1)).ravel()
    truth["triangles"] = tri
    truth["close_rows"] = close_rows
    if rows_and_cliques:
        pa, pb = A.nonzero()
        M = A[pb].multiply(AT[pa]).tocoo()  # per (a, b) pair: c with b->c->a
        w = M.data * np.asarray(A[pa[M.row], pb[M.row]]).ravel()
        # scipy's indices are int32: widen before the row code (a*n+b)*n+c
        ta, tb, tc = (x.astype(np.int64) for x in (pa[M.row], pb[M.row], M.col))
        check(int(w.sum()) == tri, "the two triangle counts disagree")
        truth["rows"] = np.sort(np.repeat((ta * n + tb) * n + tc, w))
        closes = np.asarray(A[ta].multiply(A[tb]).multiply(A[tc]).sum(axis=1)).ravel()
        truth["cliques"] = int((w * closes).sum())
        # the 4-clique count tier's lanes over the triangle rows: per row
        # the smallest of out(a), out(b), out(c)
        m3 = np.minimum(np.minimum(out_deg[ta], out_deg[tb]), out_deg[tc])
        truth["clique_min_lanes"] = int((w * m3).sum())
        truth["pivot_lanes"] = int(out_deg[d].sum())
    return truth


def loopy_arrays(n=300, e=3000):
    """A seeded Person/KNOWS graph with self-loops and parallel edges."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    ids = np.arange(n, dtype=np.int64) * 7 + 1
    src, dst = ids[rng.integers(0, n, e)], ids[rng.integers(0, n, e)]
    pairs = src * (1 << 32) + dst
    check((src == dst).any() and len(np.unique(pairs)) < e,
          "the loopy graph lacks self-loops or parallel edges")
    return ids, src, dst


def loopy_triangles(src, dst) -> int:
    """Brute force: relationship triples r0: a->b, r1: b->c, r2: c->a with
    pairwise distinct relationships (openCypher isomorphism)."""
    out = {}
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        out.setdefault(s, []).append((i, d))
    count = 0
    for r0, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        for r1, c in out.get(b, ()):
            for r2, a2 in out.get(c, ()):
                if a2 == a and r0 != r1 and r0 != r2 and r1 != r2:
                    count += 1
    return count


def loopy_closes(src, dst):
    """Brute force on the loopy graph, relationship-unique: the 2-cycles r0:
    a->b, r1: b->a, and the undirected closes r0: a->b, r1: b->c, r2 an
    edge c->a or a->c (a self-loop a->a once)."""
    from collections import defaultdict

    out = defaultdict(list)
    between = defaultdict(list)
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        out[s].append((i, d))
        between[(s, d)].append(i)
    cycles = closes = 0
    for r0, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        for r1, c in out[b]:
            if r1 == r0:
                continue
            if c == a:
                cycles += 1
            ring = between[(c, a)] + (between[(a, c)] if a != c else [])
            closes += sum(1 for r2 in ring if r2 != r0 and r2 != r1)
    return cycles, closes


def optional_rows(ids, near, far):
    """The OPTIONAL MATCH rows (near, far) over the edges (node indices
    ``near[i]`` -> ``far[i]`` in the expand's direction), and one (near,
    None) row per node with no such edge, as a Counter of id pairs."""
    from collections import Counter

    import numpy as np

    deg = np.bincount(near, minlength=len(ids))
    rows = Counter(zip(ids[near].tolist(), ids[far].tolist()))
    rows.update((int(x), None) for x in ids[deg == 0])
    return rows


def optional_page(ids, s, d, n_rows):
    """The first ``n_rows`` rows of the backwards OPTIONAL MATCH (b, a) in
    (b, a) order: each edge a->b, and one (b, None) row per b with no
    in-edge (a null sorts last; such a b has no other row)."""
    import numpy as np

    n = len(ids)
    lone = np.flatnonzero(np.bincount(d, minlength=n) == 0)
    b = np.concatenate([d, lone])
    a = np.concatenate([s, np.full(len(lone), n)])  # n: the null
    order = np.lexsort((a, b))[:n_rows]
    return [(int(ids[x]), None if y == n else int(ids[y]))
            for x, y in zip(b[order].tolist(), a[order].tolist())], len(lone)


def close_truth(ids1, tri1, ids10, s10, d10, tri10, idsl, srcl, dstl):
    """numpy/scipy truth of Q22-Q26 and the loopy graph's closes and
    OPTIONAL rows. Q26 runs on SF10's persons with the KNOWS into the
    even-indexed persons only (``half``), so half the persons have no
    in-edge."""
    import numpy as np

    out10 = np.bincount(s10, minlength=len(ids10))
    close1 = tri1["close_rows"]
    half = d10 % 2 == 0
    page, lone = optional_page(ids10, s10[half], d10[half], Q26_ROWS)
    sl, dl = np.searchsorted(idsl, srcl), np.searchsorted(idsl, dstl)
    cycles, closes = loopy_closes(srcl, dstl)
    return {
        "Q22": int(tri10["close_rows"].sum()),
        "Q23": tri10["triangles"],
        "Q24": {int(ids1[a]): int(close1[a]) for a in np.flatnonzero(close1)},
        "Q24_rows": int(close1.sum()),
        "Q25": {"rows": int(np.maximum(out10, 1).sum()), "matched": int(len(s10))},
        "Q26": page,
        "Q26_half": half,
        "Q26_lone": lone,
        "loopy_2cycle": cycles,
        "loopy_undirected": closes,
        "loopy_opt_fwd": optional_rows(idsl, sl, dl),
        "loopy_opt_bwd": optional_rows(idsl, dl, sl),
    }


def run_query(torch, pg, query, kernels, plan_op="CsrExpandOp", wcoj_tiers=(),
              params=None, warm=1):
    """Run one query cold and then ``warm`` times, and check the
    device-only contract on every run: one device attempt, ``plan_op`` in
    the plan, every kernel of ``kernels`` launched and no kernel off its
    ``kernel`` tier, and each WCOJ tier of ``wcoj_tiers`` hit once (or, a
    dict, as many times as it says). Returns
    (records rows of the last run, seconds list, per-kernel kernel-tier
    launches, materialized lanes of the last run, every run's result, the
    cold run's first)."""
    from tpu_cypher_torch.backend.cuda import bucketing
    from tpu_cypher_torch.backend.cuda import wcoj as W
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    secs = []
    out_rows = None
    launches = {}
    lanes = None
    results = []
    for _ in range(1 + warm):
        before = dispatch.use_counts()
        tiers0 = dict(W.WCOJ_TIER_COUNTS)
        rows0 = bucketing._ROWS_TRUE.value()
        t0 = time.perf_counter()
        result = pg.cypher(query, params)
        recs = result.records
        table = recs.table
        for col in table._cols.values():
            check(col.kind == "obj" or col.data.device == backend_device(),
                  f"result column not on the card: {query}")
        rows = list(recs.collect())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = dispatch.use_counts()
        log = result.execution_log
        check(len(log) == 1 and log[0]["rung"] == "device" and log[0]["ok"],
              f"not one device rung: {log}")
        check(plan_op in result.plans, f"plan has no {plan_op}")
        tiers = {k: v - tiers0.get(k, 0) for k, v in dict(W.WCOJ_TIER_COUNTS).items()}
        want = wcoj_tiers if isinstance(wcoj_tiers, dict) else dict.fromkeys(wcoj_tiers, 1)
        check(tiers == {k: want.get(k, 0) for k in tiers},
              f"WCOJ tiers {tiers}, expected {wcoj_tiers}: {query}")
        for name in after:
            d = {t: after[name][t] - before[name][t] for t in after[name]}
            check(d["fallback"] == 0 and d["plain"] == 0,
                  f"{name} left the kernel tier: {d}")
            launches[name] = launches.get(name, 0) + d["kernel"]
        for name in kernels:
            check(after[name]["kernel"] > before[name]["kernel"],
                  f"{name} not launched by {query}")
        lanes = int(bucketing._ROWS_TRUE.value() - rows0)
        out_rows = rows
        release_tables(result)
        results.append(result)
    return out_rows, secs, launches, lanes, results


def release_tables(result):
    """Drop the memoized operator tables of a finished query's plan (its
    rows are collected), so that a later run starts from the device
    memory the graphs hold, not from this run's intermediates."""
    stack = [result.relational_plan]
    while stack:
        op = stack.pop()
        op._table = None
        stack.extend(op.children)


@contextlib.contextmanager
def recorded(cls, name, out):
    """Append what ``cls.name`` returns to ``out`` while the block runs."""
    inner = getattr(cls, name)

    def hook(self, *args, **kwargs):
        ret = inner(self, *args, **kwargs)
        out.append(ret)
        return ret

    setattr(cls, name, hook)
    try:
        yield
    finally:
        setattr(cls, name, inner)


def two_hop_distinct_pairs(s, d, n) -> int:
    """(distinct (a, c), 2-hop paths) over the paths a->b->c of the edges
    (s, d) (node indices), from numpy: each edge's far end's out-edges,
    packed as a * n + c."""
    import numpy as np

    out = np.bincount(s, minlength=n)
    order = np.argsort(s, kind="stable")
    starts = np.concatenate([[0], np.cumsum(out)])
    reps = out[d]
    total = int(reps.sum())
    base = np.repeat(starts[d] - np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
    c = d[order][base + np.arange(total)]
    a = np.repeat(s, reps)
    return len(np.unique(a.astype(np.int64) * n + c)), total


def two_hop_distinct_scipy(s, d, n, step=8192) -> int:
    """Distinct (a, c) over the 2-walks a->b->c: the nonzeros of A @ A on
    the binary adjacency, by row block (scipy)."""
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    A.data[:] = 1  # duplicates summed: binary again
    A = A.astype(np.int32)
    return sum(int((A[lo:lo + step] @ A).nnz) for lo in range(0, n, step))


def walk_window(est, budget: int, start: int) -> int:
    """bench.py's source window rule: from ``start``, the number of sources
    whose walk estimates ``est`` sum to ``budget`` (at least one)."""
    import numpy as np

    cum = np.cumsum(est[start:])
    return min(max(1, int(np.searchsorted(cum, budget))), len(est) - start)


def walk_estimates(s, d, n, k):
    """[w_1, ..., w_k]: w_j[v] = directed j-walks from v with edge
    multiplicity, exact int64 (a segment sum per node over its out-edges
    in CSR order)."""
    import numpy as np

    order = np.argsort(s, kind="stable")
    rp = np.searchsorted(s[order], np.arange(n + 1))
    dsort = d[order]
    w = [np.bincount(s, minlength=n).astype(np.int64)]
    for _ in range(k - 1):
        c = np.concatenate([[0], np.cumsum(w[-1][dsort])])
        w.append(c[rp[1:]] - c[rp[:-1]])
    return w


def edge_multiplicity(s, d, n):
    """A vectorized ``mult(u, v)``: how many edges run u->v."""
    import numpy as np

    keys = np.sort(s.astype(np.int64) * n + d)

    def mult(u, v):
        q = u.astype(np.int64) * n + v
        return np.searchsorted(keys, q, side="right") - np.searchsorted(keys, q, side="left")

    return mult


def unique_walk_counts(s, d, n, window, k):
    """Relationship-unique directed walks of each length 1..k (k <= 4) from
    the sources in ``window`` (bool[n]) of a loop-free multigraph, by rule:
    the homomorphic count less the walks that reuse an edge. Without loops
    adjacent edges differ, so only e1 = e3 (a->b->a->b), e2 = e4 and
    e1 = e4 can coincide; length 4 takes them by inclusion-exclusion
    (e1 = e3 with e2 = e4 is a->b->a->b->a; every other pair of
    coincidences forces a loop)."""
    import numpy as np

    check(not (s == d).any(), "unique_walk_counts needs a loop-free graph")
    w = walk_estimates(s, d, n, k)
    hom = [int(x[window].sum()) for x in w]
    out = hom[:2]
    if k < 3:
        return out[:k]
    mult = edge_multiplicity(s, d, n)
    ew = window[s]
    sa, sb = s[ew], d[ew]  # the window's first edges (a, b)
    back = mult(sb, sa)  # edges b->a
    out.append(hom[2] - int(back.sum()))  # e1 = e3
    if k == 3:
        return out
    outdeg = w[0]
    s13 = int((back * outdeg[sb]).sum())  # a->b->a->b->?, e3 = e1
    r = np.bincount(s, weights=mult(d, s), minlength=n).astype(np.int64)
    s24 = int(r[sb].sum())  # a->b->c->b->c, e4 = e2
    order = np.argsort(s, kind="stable")
    rp = np.searchsorted(s[order], np.arange(n + 1))
    deg = outdeg[sb]
    first = np.repeat(np.arange(len(sb)), deg)
    off = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    c = d[order][rp[sb][first] + off]  # each window edge's b->c
    s14 = int(mult(c, sa[first]).sum())  # a->b->c->a->b, e4 = e1
    out.append(hom[3] - s13 - s24 - s14 + int(back.sum()))
    return out


def brute_walks(steps, n, sources, k, pairs=False, uses=False):
    """Brute force: enumerate every relationship-unique walk of length
    1..k from each source over ``steps`` = (src, dst, relationship id) of
    each traversable step (an undirected graph lists both orientations of
    a relationship under one id), level by level, a source at a time.
    Returns the walk count per length; with ``pairs`` also the sorted
    (source * n + end) keys of each length, with ``uses`` instead the
    number of walks each relationship is on."""
    import numpy as np

    src, dst, rid = steps
    order = np.argsort(src, kind="stable")
    rp = np.searchsorted(src[order], np.arange(n + 1))
    counts = [0] * k
    keys = [[] for _ in range(k)]
    on = np.zeros(int(rid.max()) + 1 if len(rid) else 0, np.int64)
    for a in sources:
        walks = np.zeros((1, 0), np.int64)
        ends = np.array([a], np.int64)
        for level in range(k):
            deg = rp[ends + 1] - rp[ends]
            row = np.repeat(np.arange(len(ends)), deg)
            off = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
            step = order[rp[ends][row] + off]
            prev = walks[row]
            ok = (prev != rid[step][:, None]).all(axis=1)
            walks = np.concatenate([prev[ok], rid[step][ok][:, None]], axis=1)
            ends = dst[step][ok]
            counts[level] += len(ends)
            if pairs:
                keys[level].append(int(a) * n + ends)
            if uses:
                on += np.bincount(walks.ravel(), minlength=len(on))
            if not len(ends):
                break
    if uses:
        return counts, on
    if not pairs:
        return counts
    return counts, [np.sort(np.concatenate(x)) if x else np.zeros(0, np.int64)
                    for x in keys]


def directed_steps(s, d):
    import numpy as np

    return s, d, np.arange(len(s), dtype=np.int64)


def undirected_steps(s, d):
    """Both orientations of each relationship under its one id, a self-loop
    once (the undirected walk's steps)."""
    import numpy as np

    rid = np.arange(len(s), dtype=np.int64)
    keep = s != d
    return (np.concatenate([s, d[keep]]), np.concatenate([d, s[keep]]),
            np.concatenate([rid, rid[keep]]))


# ---------------------------------------------------------------------------
# phase 5: measurements off the main path, after its counts are read
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_join_probe():
    """``jit_ops.join_probe`` called in the ``join_probe`` gate's place:
    the plain version on the card, for a timing only (the port itself
    never routes an eligible probe so)."""
    from tpu_cypher_torch.backend.cuda import hopper
    from tpu_cypher_torch.backend.cuda import jit_ops as J

    inner = hopper.join_probe

    def plain(rd, r_order, ld, lvalids, nvalid, *, is_f64, is_bool):
        return J.join_probe(rd, r_order, ld, lvalids, nvalid, is_f64=is_f64,
                            is_bool=is_bool)

    hopper.join_probe = plain
    try:
        yield
    finally:
        hopper.join_probe = inner


@contextlib.contextmanager
def wcoj_mode(mode):
    """``TPU_CYPHER_WCOJ`` pinned for a block; the plan cache keys on it."""
    from tpu_cypher_torch.utils import config as C

    C.WCOJ_MODE.set(mode)
    try:
        yield
    finally:
        C.WCOJ_MODE.reset()


def warm_times(torch, pg, query, variants, rows_ok, rounds=3):
    """Warm seconds of ``query`` under each variant ({label: (context
    factory, plan operator its plan must show, one it must not show or
    None)}): one untimed run of each, then ``rounds`` ABBA-interleaved
    passes, so each label gets 2 x ``rounds`` timed runs. Every run's rows
    must pass ``rows_ok``. The interpreter's cyclic garbage collector runs
    before each run, outside its time: a collection of what the earlier
    phases left would otherwise land in one run, and the optimizer's
    feedback (which routes ``auto``) learns from every run. Returns
    {label: (median seconds, median seconds of the ``execute`` phase, all
    seconds, the largest own peak device memory of its runs in GiB)}."""
    import gc
    import statistics

    labels = list(variants)
    timed = {label: [] for label in labels}
    peaks = dict.fromkeys(labels, 0)
    for i, order in enumerate([labels] + [labels + labels[::-1]] * rounds):
        for label in order:
            ctx, must, must_not = variants[label]
            gc.collect()
            with ctx():
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                res = pg.cypher(query)
                rows = [dict(r) for r in res.records.collect()]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated() - held)
                release_tables(res)
            check(rows_ok(rows), f"{label} run of {query!r} gave other rows")
            check(must in res.plans and (must_not is None or must_not not in res.plans),
                  f"{label} plan of {query!r} lacks {must} or shows {must_not}")
            if i:
                timed[label].append((secs, res.profile().phase_seconds()["execute"]))
    return {
        label: (statistics.median(s for s, _ in v), statistics.median(e for _, e in v),
                [round(s, 6) for s, _ in v], peaks[label] / 2**30)
        for label, v in timed.items()
    }


def inject_outlier(pg):
    """One span of the binary triangle plan's class at 100x the class's
    estimate (a collector pause on a served query), folded into the
    graph's calibration before ``auto`` routes the triangle: the estimate,
    a median of the class's last samples, stays within the samples it had
    (the median's rank moves by one, never to the outlier)."""
    from tpu_cypher_torch.optimizer import feedback

    res = pg.cypher(Q6)
    res.records.collect()
    plan = res.relational_plan
    cal = feedback.get(plan.graph, plan.context)
    cls = "CsrExpandIntoOp"
    est, scale = cal.unit_cost(cls), cal.wcoj_scale()
    check(est is not None and est > 0, f"no {cls} samples to inject beside")
    window = list(cal.sec_per_krow[cls][2])
    cal.observe_span(cls, 100 * est, 1000, 1000)  # seconds per 1,000 rows
    after = cal.unit_cost(cls)
    check(after <= max(window), f"one outlier moved {cls}'s estimate {est} to {after}, "
          f"past its samples {window}")
    print(f"    one {cls} span at 100x its estimate {est * 1e3:.6f} ms per 1,000 rows "
          f"injected: the estimate {after * 1e3:.6f} (its samples "
          f"{[round(x * 1e3, 6) for x in window]}), WCOJ scale {scale:.4f} -> "
          f"{cal.wcoj_scale():.4f}")


def run_tck(torch, card):
    """Phase 7: every TCK scenario of ``tests/tck`` through
    ``CypherSession.cuda()`` on the card, with ``tests/test_torch_tck.py``'s
    rules and its list of unanswered scenarios: each whitelisted scenario
    passes, every error it expects of the class the port's ``local()``
    oracle raises, and each blacklisted one fails. Prints the counts, the
    seconds, the launches per (kernel, tier) and the counts the dense tiers
    answered."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_tck as TCK

    from tpu_cypher_torch import CypherSession
    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.tck import TckRunner

    runner, oracle = TckRunner(CypherSession.cuda), TckRunner(CypherSession.local)
    dispatch.reset()
    mxu0 = mxu_tiers()
    t0 = time.perf_counter()
    passed = listed = 0
    for sc in TCK._scenarios.white_list:
        r = runner.run(sc)
        why = TCK.UNANSWERED.get(str(sc))
        if why is not None:
            check(not r.passed and r.message.startswith("TpuUnsupportedExpr")
                  and why in r.message, f"TCK {sc}: listed as {why}, got {r.message}")
            listed += 1
            continue
        check(r.passed, f"TCK {sc}: {r.message}")
        if r.errors:
            want = oracle.run(sc)
            check([type(e) for e in r.errors] == [type(e) for e in want.errors],
                  f"TCK {sc}: raised {r.errors}, the oracle {want.errors}")
        passed += 1
    for sc in TCK._scenarios.black_list:
        check(not runner.run(sc).passed, f"TCK blacklisted {sc} passed")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dispatch.use_counts()
    tiers = {f"{k}/{t}": c[t] for k, c in counts.items() for t in c if c[t]}
    dense = {k: v - mxu0[k] for k, v in mxu_tiers().items()}
    print(f"  TCK on the card ({card}): {passed} whitelisted scenarios passed, {listed} "
          f"listed as unanswered raised their refusal, {len(TCK._scenarios.black_list)} "
          f"blacklisted failed, in {secs:.1f} s; launches per (kernel, tier) {tiers}; "
          f"counts on the dense tiers {dense}")


def print_times(name, times):
    for label, (secs, execute, all_secs, peak) in times.items():
        print(f"    {name} {label}: warm median {secs * 1e3:.3f} ms (execute phase "
              f"{execute * 1e3:.3f} ms); runs (s) {all_secs}; own peak device memory "
              f"{peak:.3f} GiB")


def shaping_truth(ids1, s1, d1, ids10, bday10, s10, d10):
    """numpy truth of Q13 (SF1) and Q14-Q16 (SF10) from the generator's
    arrays (node indices ``s``, ``d`` of each KNOWS edge)."""
    import numpy as np

    truth = {}
    truth["Q13"], truth["Q13_rows"] = two_hop_distinct_pairs(s1, d1, len(ids1))
    out10 = np.bincount(s10, minlength=len(ids10))
    top = np.lexsort((ids10, -out10))[:20]
    truth["Q14"] = [{"id": int(ids10[i]), "deg": int(out10[i])} for i in top]
    e15 = ids10[s10] < Q15_ID_BOUND
    o15 = np.lexsort((bday10[d10[e15]], s10[e15]))
    src15, val15 = s10[e15][o15], bday10[d10[e15]][o15]
    grp, first, size = np.unique(src15, return_index=True, return_counts=True)
    med = val15[first + np.ceil(0.5 * size).astype(np.int64) - 1]
    truth["Q15"] = [
        {"id": int(ids10[g]), "n": int(c), "lo": int(val15[f]), "hi": int(val15[f + c - 1]),
         "med": int(m)}
        for g, f, c, m in zip(grp, first, size, med)
    ]
    truth["Q15_rows"] = int(e15.sum())
    check(0 < len(grp) <= 256, f"Q15 groups {len(grp)}: the WHERE must keep k <= 256")
    distinct = np.unique(bday10[d10])
    truth["Q16"] = [{"d": int(x)} for x in distinct[100:150]]
    truth["Q16_distinct"] = len(distinct)
    return truth


WALK_BUDGET = 60_000_000  # bench.py's SF10 budget of materialized walks
Q20_ROWS = 1_000_000  # Q20's window returns about this many rows
Q21_WALKS = 10_000_000  # Q21's undirected <= 2-walk estimate over its window
LOOPY_LANES = 40_000_000  # LOOPY_FORBID's walk lanes, at most


def window_params(ids, start, k):
    """The source-id window [start, start + k) as the queries' $lo/$hi."""
    return {"lo": int(ids[start]), "hi": int(ids[start + k - 1]) + 1}


def walk_truth(ids1, s1, d1, ids10, s10, d10, idsl, srcl, dstl):
    """numpy truth of the chain-walk queries, relationship uniqueness
    included. Q18 and Q19 take their windows by bench.py's rule over the
    <= 3- and <= 4-walk estimates at the SF10 budget and count by
    ``unique_walk_counts``, each rule first held to the brute-force
    enumeration on the window's first 20 sources; Q20, Q21 and the loopy
    graph's queries count by brute force."""
    import numpy as np

    n1, n10, nl = len(ids1), len(ids10), len(idsl)
    t = {"Q17": two_hop_distinct_scipy(s10, d10, n10)}
    start = n10 // 2
    for name, q, k in (("Q18", Q18, 3), ("Q19", Q19, 4)):
        w = walk_window(sum(walk_estimates(s10, d10, n10, k)), WALK_BUDGET, start)
        sub = np.zeros(n10, bool)
        sub[start:start + min(20, w)] = True
        brute = brute_walks(directed_steps(s10, d10), n10, np.flatnonzero(sub), k)
        rule = unique_walk_counts(s10, d10, n10, sub, k)
        check(rule == brute, f"{name}: the walk rule {rule} != brute force {brute}")
        window = np.zeros(n10, bool)
        window[start:start + w] = True
        counts = unique_walk_counts(s10, d10, n10, window, k)
        t[name] = (window_params(ids10, start, w), sum(counts), w, counts)
    start1 = n1 // 2
    w = walk_window(sum(walk_estimates(s1, d1, n1, 2)), Q20_ROWS, start1)
    counts, keys = brute_walks(directed_steps(s1, d1), n1, np.arange(start1, start1 + w), 2,
                               pairs=True)
    t["Q33"] = counts  # Q20's rows per walk length
    keys = np.concatenate(keys)
    t["Q20"] = (window_params(ids1, start1, w),
                np.sort(ids1[keys // n1] * (1 << 32) + ids1[keys % n1]), w)
    # Q21's window by the same rule over the undirected <= 2-walk estimate:
    # a step into a zipf hub and out again is hundreds of thousands of walks
    us, ud, _ = undirected_steps(s10, d10)
    w = walk_window(sum(walk_estimates(us, ud, n10, 2)), Q21_WALKS, start)
    sources = np.arange(start, start + w)
    und = brute_walks(undirected_steps(s10, d10), n10, sources, 2)
    zero = brute_walks(directed_steps(s10, d10), n10, sources, 2)
    t["Q21"] = (window_params(ids10, start, w), sum(und), w + sum(zero), w)
    sl, dl = np.searchsorted(idsl, srcl), np.searchsorted(idsl, dstl)
    counts, keys = brute_walks(directed_steps(sl, dl), nl, np.arange(nl), 2, pairs=True)
    t["loopy_chain"], t["loopy_distinct"] = counts[1], len(np.unique(keys[1]))
    # LOOPY_FORBID: per fixed relationship r out of the x window, the
    # walks from any c that avoid it
    (w1, w2), on = brute_walks(directed_steps(sl, dl), nl, np.arange(nl), 2, uses=True)
    outdeg = np.bincount(sl, minlength=nl)
    x = walk_window(outdeg * (w1 + w2), LOOPY_LANES, 0)
    fixed = sl < x  # the relationships r out of the window
    t["loopy_forbid"] = ({"hi": int(idsl[x - 1]) + 1},
                         int(fixed.sum()) * (w1 + w2) - int(on[fixed].sum()), x)
    return t


@contextlib.contextmanager
def counted(module, names, calls):
    """Count the calls of ``module.<name>`` for each name while the block
    runs."""
    inner = {name: getattr(module, name) for name in names}

    def hook(name):
        def spy(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return inner[name](*args, **kwargs)
        return spy

    for name in names:
        setattr(module, name, hook(name))
    try:
        yield
    finally:
        for name in names:
            setattr(module, name, inner[name])


def run_walk_queries(torch, run, cold, slice_launches, g1, g10, gl, truth, report):
    """Phase 4's chain-walk queries, Q17-Q21 and the loopy graph's
    uniqueness queries: each cold, then five warm runs, with its warm
    median, peak device memory and ``expand_rows`` launches, checked
    against ``walk_truth``."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.table import CudaTable

    def walked(label, pg, q, params, plan_op, fns=(), per_run=1, uniq=False):
        calls = {}
        distinct_calls = []
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        before = slice_launches.get("expand_rows", 0)
        with counted(J, fns, calls), recorded(CudaTable, "distinct_count", distinct_calls):
            rows, secs, _ = run(label, pg, q, ("expand_rows",), plan_op=plan_op,
                                params=params, warm=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = slice_launches["expand_rows"] - before
        warm = statistics.median(secs[1:])
        print(f"    {label} cold {secs[0] * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms "
              f"over {len(secs) - 1} runs (s: {[round(x, 6) for x in secs[1:]]}); peak "
              f"device memory {peak:.3f} GiB, of which {held:.3f} GiB held before the "
              f"query ({peak - held:.3f} GiB its own); expand_rows launches {launches} "
              f"({launches / len(secs):g} a run)")
        for name in fns:
            check(calls.get(name, 0) == per_run * len(secs),
                  f"{label}: {name} called {calls.get(name, 0)} times in {len(secs)} runs")
        check(not distinct_calls, f"{label} called CudaTable.distinct_count")
        if uniq:
            check("uniq" in cold[label].plans, f"{label}'s plan enforces no pair")
        return [dict(r) for r in rows], warm, launches / len(secs)

    rows, warm, per = walked("Q17 (SF10)", g10, Q17, None, "DistinctOp",
                             ("distinct_pairs_count_final",))
    check(rows == [{"pairs": truth["Q17"]}], f"Q17 {rows} != {truth['Q17']}")
    check(per == 2, f"Q17 launched expand_rows {per} times a run, expected 2")
    er = report["expand_rows"]
    print(f"    Q17 = {truth['Q17']} distinct (a, c) at SF10 (scipy A @ A); of the warm "
          f"median, the final hop's kernel tier {er['q17_tier_ms'] / (warm * 1e3):.1%} "
          f"({er['q17_tier_ms']:.4f} ms) and its sort {er['q17_sort_ms'] / (warm * 1e3):.1%} "
          f"({er['q17_sort_ms']:.4f} ms)")
    for name in ("Q18", "Q19"):
        params, want, w, counts = truth[name]
        rows, _, _ = walked(f"{name} (SF10)", g10, Q18 if name == "Q18" else Q19, params,
                            "CsrVarExpandOp")
        check(rows == [{"walks": want}], f"{name} {rows} != {want}")
        print(f"    {name} = {want} relationship-unique walks from {w} sources "
              f"(per length {counts}); the rule held to brute force on "
              f"{min(20, w)} of them")
    params, keys, w = truth["Q20"]
    rows, _, _ = walked("Q20 (SF1)", g1, Q20, params, "CsrVarExpandOp")
    got = np.sort(np.array([r["a"] * (1 << 32) + r["b"] for r in rows], np.int64))
    check(np.array_equal(got, keys), "Q20 row bag differs from numpy")
    print(f"    Q20 = {len(rows)} (a, b) rows from {w} sources, bag-identical to numpy")
    params, und, zero, w = truth["Q21"]
    rows, _, _ = walked("Q21 undirected (SF10)", g10, Q21_UNDIRECTED, params,
                        "CsrVarExpandOp")
    check(rows == [{"walks": und}], f"Q21 undirected {rows} != {und}")
    rows, _, _ = walked("Q21 *0..2 (SF10)", g10, Q21_ZERO, params, "CsrVarExpandOp")
    check(rows == [{"walks": zero}], f"Q21 *0..2 {rows} != {zero}")
    print(f"    Q21 = {und} undirected *1..2 walks and {zero} directed *0..2 walks from "
          f"{w} sources")
    rows, _, _ = walked("loopy 2-hop count", gl, Q4, None, "CsrExpandOp",
                        ("chain_count_final_unique",), uniq=True)
    check(rows == [{"c": truth["loopy_chain"]}], f"loopy 2-hop {rows}")
    rows, _, _ = walked("loopy 2-hop DISTINCT", gl, Q13, None, "DistinctOp",
                        ("distinct_pairs_count_final_unique",), uniq=True)
    check(rows == [{"pairs": truth["loopy_distinct"]}], f"loopy DISTINCT {rows}")
    params, want, c = truth["loopy_forbid"]
    rows, _, _ = walked("loopy fixed rel vs *1..2", gl, LOOPY_FORBID, params,
                        "CsrVarExpandOp", ("rel_rows_of_ids",), uniq=True)
    check(rows == [{"n": want}], f"loopy forbid {rows} != {want}")
    print(f"    loopy = {truth['loopy_chain']} unique 2-hop walks, "
          f"{truth['loopy_distinct']} distinct (a, c) over them, {want} (r, walk) rows "
          f"with r out of {c} sources and the walk avoiding it; all by brute force")


def run_close_queries(torch, run, cold, g1, g10, g10h, gl, truth, loopy_tri):
    """Phase 4's closing ExpandInto and fused OPTIONAL queries, Q22-Q26 and
    the loopy graph's closes and OPTIONAL rows: each cold, then five warm
    runs, with its warm median and own peak device memory, checked against
    ``close_truth`` and against the path it must take: the plan's
    operator, and the plain functions each run calls (the fused close
    count's ``into_close_queries`` or ``into_close_unique_queries``, the
    materialize's two ``into_probe`` halves, the optional merge's
    ``optional_place``)."""
    from collections import Counter

    from tpu_cypher_torch.backend.cuda import jit_ops as J

    both = ("expand_rows", "intersect")

    def closed(label, pg, q, kernels, plan_op, fns, mode=None):
        calls = {}
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        pinned = wcoj_mode(mode) if mode else contextlib.nullcontext()
        with counted(J, tuple(fns), calls), pinned:
            rows, secs, _ = run(label, pg, q, kernels, plan_op=plan_op, warm=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm = statistics.median(secs[1:])
        print(f"    {label} cold {secs[0] * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms "
              f"over {len(secs) - 1} runs (s: {[round(x, 6) for x in secs[1:]]}); peak "
              f"device memory {peak:.3f} GiB, of which {held:.3f} GiB held before the "
              f"query ({peak - held:.3f} GiB its own)")
        for name, per_run in fns.items():
            check(calls.get(name, 0) == per_run * len(secs),
                  f"{label}: {name} called {calls.get(name, 0)} times in {len(secs)} runs")
        return [dict(r) for r in rows]

    def fused_at_top(label):
        rel = cold[label].plans.split("=== Relational plan ===")[1].strip().splitlines()
        return rel[1].strip().startswith("CsrExpandIntoOp(") and " uniq(" in rel[1]

    rows = closed("Q22 (SF10)", g10, Q22, both, "CsrExpandIntoOp",
                  {"into_close_queries": 1, "into_probe": 0})
    check(rows == [{"t": truth["Q22"]}], f"Q22 {rows} != {truth['Q22']}")
    print(f"    Q22 = {truth['Q22']} 2-paths a->b->c closed by an undirected c-a edge "
          f"(scipy A^2 o (A + A^T)); {truth['Q23']} of them directed triangles; the "
          f"fused close count, both orientations")
    rows = closed("Q23 (SF10, off)", g10, Q23, both, "CsrExpandIntoOp",
                  {"into_close_queries": 1, "into_probe": 0}, mode="off")
    check(rows == [{"triangles": truth["Q23"]}], f"Q23 {rows} != {truth['Q23']}")
    print(f"    Q23 = {truth['Q23']} triangles on the fused close count (Q6's truth)")
    rows = closed("Q24 (SF1)", g1, Q24, both, "CsrExpandIntoOp", {"into_probe": 2})
    check({r["a"]: r["n"] for r in rows} == truth["Q24"] and len(rows) == len(truth["Q24"]),
          "Q24 rows differ from scipy")
    print(f"    Q24 = {len(rows)} groups over {truth['Q24_rows']} closed 2-paths, equal to "
          f"scipy group for group")
    rows = closed("Q25 (SF10)", g10, Q25, ("expand_rows",), "CsrOptionalExpandOp",
                  {"optional_place": 1})
    check(rows == [truth["Q25"]], f"Q25 {rows} != {truth['Q25']}")
    print(f"    Q25 = {rows[0]}")
    rows = closed("Q26 (SF10 half)", g10h, Q26, ("expand_rows",), "CsrOptionalExpandOp",
                  {"optional_place": 1})
    got = [(r["b"], r["a"]) for r in rows]
    check(got == truth["Q26"], f"Q26 rows differ from numpy: {got[:3]} ...")
    nulls = sum(1 for _, a in got if a is None)
    print(f"    Q26 = {len(rows)} (b, a) rows in order, {nulls} of them null-padded, equal "
          f"to numpy row for row ({truth['Q26_lone']} persons with no in-edge)")
    fns_u = {"into_close_unique_queries": 1, "into_close_count_unique": 1, "into_probe": 0}
    rows = closed("loopy triangles (off)", gl, Q6, both, "CsrExpandIntoOp", fns_u, mode="off")
    check(rows == [{"triangles": loopy_tri}], f"loopy triangles (off) {rows}")
    check(fused_at_top("loopy triangles (off)"), "loopy triangle close has a FilterOp above")
    rows = closed("loopy 2-cycle (off)", gl, LOOPY_2CYCLE, both, "CsrExpandIntoOp", fns_u,
                  mode="off")
    check(rows == [{"c": truth["loopy_2cycle"]}], f"loopy 2-cycle {rows}")
    check(fused_at_top("loopy 2-cycle (off)"), "loopy 2-cycle close has a FilterOp above")
    rows = closed("loopy undirected close", gl, Q22, both, "CsrExpandIntoOp",
                  {"into_probe": 2})
    check(rows == [{"t": truth["loopy_undirected"]}], f"loopy undirected close {rows}")
    for name, q, keys in (("fwd", LOOPY_OPT_FWD, ("a", "b")), ("bwd", LOOPY_OPT_BWD, ("b", "a"))):
        rows = closed(f"loopy OPTIONAL {name}", gl, q, ("expand_rows",), "CsrOptionalExpandOp",
                      {"optional_place": 1})
        got = Counter((r[keys[0]], r[keys[1]]) for r in rows)
        check(got == truth[f"loopy_opt_{name}"], f"loopy OPTIONAL {name} rows differ")
    print(f"    loopy = {loopy_tri} triangles and {truth['loopy_2cycle']} 2-cycles on the "
          f"fused unique close count, {truth['loopy_undirected']} undirected closes, "
          f"OPTIONAL rows forward and backward; all by brute force")


def expr_truth(ids, bday, s, d):
    """numpy truth of Q27-Q30 at SF10 from the generator's arrays (node
    indices ``s``, ``d`` of each KNOWS edge; person i's firstname is
    "p" + str(i))."""
    import numpy as np

    diff = bday[d] - bday[s]
    band = np.where(diff > 3650, 0, np.where(-diff > 3650, 2, 1))
    q27 = [{"band": name, "n": int((band == k).sum()), "s": int((bday[d][band == k] % 365).sum())}
           for k, name in enumerate(("older", "peer", "younger")) if (band == k).any()]
    starts = np.array([str(i).startswith("1") for i in range(len(ids))])
    q28 = int((starts[d] & (s % 10 == 3)).sum())
    young = bday < 2000
    hit = young[s] & (bday[d] >= 17_000)
    matched = np.bincount(s[hit], minlength=len(ids))
    q29 = {"na": int(hit.sum() + (young & (matched == 0)).sum()), "nb": int(hit.sum()),
           "db": int(len(np.unique(d[hit])))}
    sel = ids[s] % 1000 == 1
    q30 = [{"t": "KNOWS", "n": int(sel.sum()), "younger": int((bday[d] > bday[s])[sel].sum()),
            "gap": int(np.abs(diff[sel]).max())}] if sel.any() else []
    return {"Q27": q27, "Q28": [{"n": q28}], "Q29": [q29], "Q30": q30}


def expression_seconds(result):
    """Self seconds of the spans that evaluate expressions in one run:
    FilterOp (WHERE), AddOp (projected expressions) and AggregateOp (the
    aggregates' inputs, with the grouping), host wall time."""
    out = {}
    for sp in result.profile().trace.spans():
        if sp.name in ("FilterOp", "AddOp", "AggregateOp"):
            out[sp.name] = out.get(sp.name, 0.0) + sp.self_seconds
    return out


def run_expression_queries(torch, run, last, g10, truth):
    """Phase 4's expression queries, Q27-Q30 at SF10: each cold, then five
    warm runs, with its warm median and the expression spans' share of the
    last run, checked against ``expr_truth``; then ``rand()`` over SF10's
    persons, every value in [0, 1), and the compiler's float ``%`` on the
    card against numpy's fmod at its edge values, bit for bit."""
    import numpy as np

    specs = (
        ("Q27", "OrderByOp"), ("Q28", "FilterOp"), ("Q29", "JoinOp(left_outer"),
        ("Q30", "AggregateOp"),
    )
    for name, plan_op in specs:
        label = f"{name} (SF10)"
        rows, secs, _ = run(label, g10, globals()[name], EXPR_KERNELS[name],
                            plan_op=plan_op, warm=5)
        rows = [dict(r) for r in rows]
        check(rows == truth[name], f"{name} {rows[:3]} != {truth[name][:3]}")
        res = last[label]
        spans = expression_seconds(res)
        total = res.profile().phase_seconds()["execute"]
        share = sum(spans.values()) / total if total else 0.0
        print(f"    {label} warm median {statistics.median(secs[1:]) * 1e3:.3f} ms over "
              f"{len(secs) - 1} runs (s: {[round(x, 6) for x in secs[1:]]}); last run's "
              f"expression spans (self s) {({k: round(v, 6) for k, v in spans.items()})}, "
              f"{share:.3f} of its execute phase {total:.6f} s")
        print(f"    {name} = {rows if len(rows) < 4 else len(rows)}, equal to numpy")
    rows, _, _ = run("rand (SF10)", g10, "MATCH (a:Person) RETURN rand() AS r", (),
                     plan_op="AddOp")
    r = np.array([x["r"] for x in rows])
    check(len(r) == 100_000 and bool(((r >= 0) & (r < 1)).all())
          and len(np.unique(r)) > 99_000, "rand() out of [0, 1) or repeated")
    print(f"    rand over {len(r)} rows: min {r.min()}, max {r.max()}, "
          f"{len(np.unique(r))} distinct")
    from tpu_cypher_torch.backend.cuda.column import Column
    from tpu_cypher_torch.backend.cuda.compiler import CudaEvaluator
    from tpu_cypher_torch.backend.cuda.table import CudaTable
    from tpu_cypher_torch.ir import expr as E
    from tpu_cypher_torch.relational.header import RecordHeader

    a = np.array([5.5, -0.0, -5.5, 1e308, 3.0, 7.0, 0.1, np.inf, 5.0, 2.0**60 + 1, 1e300])
    b = np.array([np.inf, 3.0, np.inf, 1e-308, -0.0, 0.1, 0.03, 2.0, np.nan, 3.0, 3.7])
    pa, pb = (E.Property(E.Var("n"), k) for k in "ab")
    table = CudaTable({k: Column("f64", torch.from_numpy(v).to(backend_device()), None)
                       for k, v in (("a", a), ("b", b))}, len(a))
    got = CudaEvaluator(table, RecordHeader({pa: "a", pb: "b"}), {}).eval(
        E.Modulo(pa, pb)).data.cpu().numpy()
    want = np.fmod(a, b)  # IEEE fmod, exact; the local oracle's math.fmod
    same = (got.view(np.int64) == want.view(np.int64)) | (np.isnan(got) & np.isnan(want))
    check(bool(same.all()), f"float % on the card {got.tolist()} != fmod {want.tolist()}")
    print("    float % at its edge values on the card: IEEE fmod's, bit for bit")


def list_truth(ids, bday, s, d, q33_counts):
    """numpy truth of Q31-Q35 from the generator's arrays (SF10; Q33 at
    SF1 from ``walk_truth``'s per-length walk counts of Q20's window)."""
    import numpy as np

    outdeg = np.bincount(s, minlength=len(ids))
    big = outdeg >= 60
    on = big[s]
    sel = np.flatnonzero(ids % 100 == 1)
    q34_values = [{
        "id": int(ids[i]), "k": ["birthday", "firstname", "id"],
        "p": {"id": int(ids[i]), "birthday": int(bday[i]), "firstname": f"p{i}"},
        "m": {"id": int(ids[i]), "b": int(bday[i] % 7)},
        "s": [f"p{i}", str(int(bday[i] % 10))],
    } for i in sel]
    q35 = {int(ids[i]): sorted(ids[d[s == i]].tolist())
           for i in np.flatnonzero(ids % 1000 == 1) if outdeg[i]}
    return {**list_surface_truth(ids, bday, s, d),
        "Q31": [{"n": int(len(s)), "s": int((bday[d] % 365).sum())}],
        "Q32": [{"n": int(big.sum()), "even": int((on & (ids[d] % 2 == 0)).sum()),
                 "hit": int(len(np.unique(s[on & (ids[d] % 1000 == 1)])))}],
        "Q33": [{"hops": k + 1, "c": int(c)} for k, c in enumerate(q33_counts) if c],
        "Q34": [{"l": ["Person"], "c": int(len(ids))}],
        "Q34 values": q34_values,
        "Q35": q35,
    }


def undirected_window(ids, s, d, budget):
    """Q54 rows' window: by bench.py's rule from the middle person over the
    undirected <= 2-walk estimates (a step into a zipf hub and out again
    is hundreds of thousands of walks), as $lo/$hi."""
    n = len(ids)
    us, ud, _ = undirected_steps(s, d)
    w = walk_window(sum(walk_estimates(us, ud, n, 2)), budget, n // 2)
    return window_params(ids, n // 2, w)


def list_surface_truth(ids, bday, s, d):
    """numpy truth of Q54-Q59 and the windows of Q54 and Q58's window (by
    bench.py's rule from the middle person: Q54 over the <= 2-walk
    estimates at ``Q54_WALKS``, Q58's over the out-degrees at
    ``Q58_FRIENDS``), as ``"<name> params"``. The rows are in the form
    ``list_surface_rows`` gives the engine's. Q54 rows' window is the
    caller's (``undirected_window``), on its own graph."""
    import numpy as np

    n = len(ids)
    start = n // 2
    outdeg = np.bincount(s, minlength=n)
    w54 = walk_window(sum(walk_estimates(s, d, n, 2)), Q54_WALKS, start)
    window = np.zeros(n, bool)
    window[start:start + w54] = True
    q54 = unique_walk_counts(s, d, n, window, 2)
    w58 = walk_window(outdeg, Q58_FRIENDS, start)
    on = (s >= start) & (s < start + w58)
    best = np.zeros(n, np.int64)
    np.maximum.at(best, s[on], ids[d[on]] % 1000)
    key = bday.astype(np.int64) * 2 + ids % 2
    pair = (bday[s] % 12) * 12 + bday[d] % 12
    c57 = np.bincount(pair, minlength=144)
    c57m = np.bincount(bday[s] % 12, minlength=12)
    sel = np.flatnonzero(ids % 100 == 1)
    q59 = [{"m": [int(ids[i]), f"p{i}", bool(bday[i] % 2 == 0), None]} for i in sel]
    return {
        "Q54": [{"l": k + 1, "c": int(c)} for k, c in enumerate(q54) if c],
        "Q54 params": window_params(ids, start, w54),
        "Q55": [{"n": int(np.bincount(key)[key[d]].sum())}],
        "Q56": [{"n": int(len(s)), "s": int(ids[d].sum()), "t": int((bday[d] % 365).sum())}],
        "Q57": [{"k": [int(i // 12), int(i % 12)], "c": int(c)} for i, c in enumerate(c57) if c],
        "Q57 map": [{"k": {"m": int(i)}, "c": int(c)} for i, c in enumerate(c57m) if c],
        "Q58": [{"r": int((ids[d] % 13).sum())}],
        "Q58 window": [{"a": int(ids[i]), "n": int(outdeg[i]), "r": int(best[i])}
                       for i in range(start, start + w58) if outdeg[i]],
        "Q58 window params": window_params(ids, start, w58),
        "Q58 window longest": int(outdeg[start:start + w58].max()),
        "Q59": q59,
        "Q59 unwind": sorted((type(x).__name__, repr(x)) for r in q59 for x in r["m"]),
    }


def list_surface_rows(name, rows):
    """The rows of one of Q54-Q59 in the form of ``list_surface_truth``'s:
    Q58's window by person, Q59 by id, Q59's unwound values as sorted
    (type, value) pairs."""
    if name == "Q58 window":
        return sorted(rows, key=lambda r: r["a"])
    if name == "Q59":
        return sorted(rows, key=lambda r: r["m"][0])
    if name == "Q59 unwind":
        return sorted((type(r["x"]).__name__, repr(r["x"])) for r in rows)
    return rows


def check_path_rows(rows, edges):
    """Q54's rows, decoded: each path starts at a, has one node more than
    relationships (one or two, distinct, of type KNOWS), and each
    relationship joins its neighbours in the path, in either direction,
    along an edge of the graph."""
    from tpu_cypher_torch.api.values import Node, Relationship

    for r in rows:
        ns, rs = r["ns"], r["rs"]
        check(all(isinstance(x, Node) for x in ns) and all(isinstance(x, Relationship)
                                                           for x in rs)
              and 1 <= len(rs) <= 2 and len(ns) == len(rs) + 1 and ns[0].id == r["a"],
              f"Q54 rows: {ns!r} {rs!r} is not a path from {r['a']}")
        check(len({x.id for x in rs}) == len(rs)
              and all(x.rel_type == "KNOWS" and {x.start, x.end} == {u.id, v.id}
                      and ((u.id, v.id) in edges or (v.id, u.id) in edges)
                      for x, u, v in zip(rs, ns, ns[1:])),
              f"Q54 rows: {rs!r} does not join {[x.id for x in ns]} along KNOWS")


def check_rel_lists(rows, edges):
    """Each row's relationship list, decoded: one or two distinct KNOWS
    relationships of the graph that chain from a to b."""
    from tpu_cypher_torch.api.values import Relationship

    for r in rows:
        rs = r["rs"]
        check(1 <= len(rs) <= 2 and all(isinstance(x, Relationship) for x in rs),
              f"Q33 rows: {rs!r} is not a list of one or two relationships")
        check(rs[0].start == r["a"] and rs[-1].end == r["b"]
              and all(x.end == y.start for x, y in zip(rs, rs[1:]))
              and len({x.id for x in rs}) == len(rs)
              and all(x.rel_type == "KNOWS" and (x.start, x.end) in edges for x in rs),
              f"Q33 rows: {rs!r} does not chain from {r['a']} to {r['b']}")


def run_list_queries(torch, run, last, g1, g10, truth, q33_params, edges1):
    """Phase 4's list queries, Q31-Q35: each cold, then five warm runs,
    with its warm median, checked against ``list_truth``; Q31's
    ``AggregateOp`` (the grouping and ``collect``) and ``UnwindOp`` (the
    explode) spans as shares of its execute phase."""
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    for name, (query, plan_op, kernels) in LIST_QUERIES.items():
        sf1 = name in SF1_LIST_QUERIES
        label = f"{name} ({'SF1' if sf1 else 'SF10'})"
        before = dispatch.use_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        params = q33_params if name.startswith("Q33") else truth.get(f"{name} params")
        rows, secs, _ = run(label, g1 if sf1 else g10, query, kernels, plan_op=plan_op,
                            params=params, warm=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = dispatch.use_counts()
        tiers = {f"{k}/{t}": after[k][t] - before[k][t] for k in after for t in after[k]
                 if after[k][t] > before[k][t]}
        rows = [dict(r) for r in rows]
        if name == "Q54 rows":
            check(len(rows) == 1000, f"Q54 rows: {len(rows)} rows")
            check_path_rows(rows, edges1)
            got = "1000 rows, each a path from a along KNOWS of the graph"
        elif name == "Q59 unwind":
            got = list_surface_rows(name, rows)
            check(got == truth[name], f"{name} {got[:4]} != {truth[name][:4]}")
            kinds = {}
            for kind, _ in got:
                kinds[kind] = kinds.get(kind, 0) + 1
            got = f"{len(rows)} values, equal to numpy; per kind {kinds}"
        elif name in ("Q58 window", "Q59"):
            got = list_surface_rows(name, rows)
            check(got == truth[name], f"{name} {got[:2]} != {truth[name][:2]}")
            got = f"{len(rows)} rows, equal to numpy"
            if name == "Q58 window":
                got += f"; the window's longest list {truth['Q58 window longest']}"
        elif name == "Q33 rows":
            check(len(rows) == 1000, f"Q33 rows: {len(rows)} rows")
            check_rel_lists(rows, edges1)
            got = "1000 rows, each list chains from a to b over KNOWS of the graph"
        elif name == "Q34 values":
            got = sorted(rows, key=lambda r: r["id"])
            check(got == truth[name], f"{name} {got[:2]} != {truth[name][:2]}")
            got = f"{len(rows)} rows, equal to numpy"
        elif name == "Q35":
            got = {r["a"]: sorted(n.id for n in r["fs"]) for r in rows}
            check(got == truth[name] and all(
                n.labels == {"Person"} and "birthday" in n.properties
                for r in rows for n in r["fs"]), f"Q35 friend multisets differ from numpy")
            got = f"{len(rows)} persons' friend multisets, equal to numpy"
        else:
            check(rows == truth[name], f"{name} {rows} != {truth[name]}")
            got = rows if len(rows) < 5 else f"{len(rows)} rows in order, equal to numpy"
        res = last[label]
        total = res.profile().phase_seconds()["execute"]
        spans = {}
        for sp in res.profile().trace.spans():
            if sp.name in ("AggregateOp", "UnwindOp"):
                spans[sp.name] = spans.get(sp.name, 0.0) + sp.self_seconds
        shares = {k: round(v / total, 3) for k, v in spans.items()} if total else {}
        print(f"    {label} warm median {statistics.median(secs[1:]) * 1e3:.3f} ms over "
              f"{len(secs) - 1} runs (s: {[round(x, 6) for x in secs[1:]]}); last run's "
              f"AggregateOp/UnwindOp self s {({k: round(v, 6) for k, v in spans.items()})}, "
              f"shares of its execute phase {total:.6f} s: {shares}; peak device memory "
              f"{peak:.3f} GiB, {peak - held:.3f} GiB its own; launches per (kernel, tier) "
              f"over the six runs {tiers}")
        print(f"    {name} = {got}")


# ---------------------------------------------------------------------------
# phase 4: the factorized tier and the optimizer's join order
# ---------------------------------------------------------------------------

# bench.py CLIQUE4_MAT (Q36, under WCOJ and FACTORIZE force), the same
# 4-clique under the defaults (Q37: the multi-close flat decode), the 2-hop
# grouped by a prefix key (Q38: the factorized expand, its weighted
# partials on segment_agg) and the fan's 2-hop rows (Q39, streamed)
Q36 = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)-[:KNOWS]->(a), "
    "(a)-[:KNOWS]->(d:Person), (b)-[:KNOWS]->(d), (c)-[:KNOWS]->(d) "
    "RETURN count(DISTINCT d.id) AS hubs"
)
Q37 = Q36.replace("count(DISTINCT d.id) AS hubs",
                  "count(*) AS n, min(d.id) AS lo, max(d.id) AS hi")
Q38 = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
    "RETURN a.id % 256 AS g, count(*) AS paths, sum(a.id) AS s"
)
Q39 = "MATCH (a:S)-[:R1]->(h)-[:R2]->(b) RETURN a.id AS x, b.id AS y"
FAN = 1024  # Q39's sources and targets: 1,048,576 flat rows
Q39_CHUNK = 65536
# the 4-clique's scale: its WCOJ materialize iterates the pivot (a)->(d)
# over every triangle row, sum(w * out(a)) lanes, 8.0e9 at SF10 and 8.1e8
# at SF1 on the generator's hubs (past expand_rows' int32 lane range, or
# about 70 GB of lane state); SF0.5 gives 4.8e8 lanes
Q36_SCALE = 0.5
# bench.py _JOIN_ORDER_QUERIES, verbatim (Q40-Q44)
JOIN_ORDER_QUERIES = (
    ("Q40 rare_last", "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:RARE]->(c:Admin) "
                      "RETURN count(*) AS c"),
    ("Q41 rare_mid", "MATCH (a:Person)-[:KNOWS]->(b)-[:RARE]->(c)-[:KNOWS]->(d:Person) "
                     "RETURN count(*) AS c"),
    ("Q42 label_last", "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Admin) "
                       "RETURN count(*) AS c"),
    ("Q43 cycle_close", "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:RARE]->(c)-[:KNOWS]->(a) "
                        "RETURN count(*) AS c"),
    ("Q44 filter_hoist", "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Admin) "
                         "WHERE c.id < 40 RETURN count(*) AS c"),
)


# the temporal kinds at SF10 (generate_snb(temporal=True): Person.birthday a
# date, Person.created a datetime at +02:00, KNOWS.creationDate a
# localdatetime in 2010-2013): grouped accessors, a range filter over the
# expand, min and max, the value join on a date (Q11's truth), a truncation
# grouped, a grouped max, a top 20, month arithmetic over every KNOWS and an
# accessor of the zoned clock
Q45 = "MATCH (p:Person) RETURN p.birthday.year AS y, count(*) AS c ORDER BY y"
Q46 = ("MATCH (a:Person)-[k:KNOWS]->(b:Person) "
       "WHERE k.creationDate >= localdatetime('2012-01-01T00:00:00') RETURN count(*) AS n")
Q47 = ("MATCH (a:Person)-[k:KNOWS]->(b:Person) "
       "RETURN min(k.creationDate) AS lo, max(k.creationDate) AS hi")
Q48 = ("MATCH (a:Person)-[:KNOWS]->(b:Person), (c:Person) "
       "WHERE b.birthday = c.birthday RETURN count(*) AS n")
Q49 = ("MATCH (p:Person) WITH date.truncate('quarter', p.birthday) AS q, count(*) AS c "
       "RETURN q, c ORDER BY q")
# Q50 groups the KNOWS of Q15's persons: ids 7k + 1 below Q15_ID_BOUND,
# at most 256 groups, the kernel's bound
Q50 = (f"MATCH (a:Person)-[k:KNOWS]->(b:Person) WHERE a.id < {Q15_ID_BOUND} "
       "RETURN a.id AS id, max(k.creationDate) AS last ORDER BY id")
Q51 = ("MATCH (a:Person)-[k:KNOWS]->(b:Person) "
       "RETURN k.creationDate AS t ORDER BY t DESC LIMIT 20")
Q52 = ("MATCH (a:Person)-[k:KNOWS]->(b:Person) "
       "RETURN (k.creationDate + duration('P1M')).month AS m, count(*) AS c ORDER BY m")
Q53 = "MATCH (p:Person) RETURN p.created.hour AS h, count(*) AS c ORDER BY h"
# (query, plan operator, kernels each run launches); a grouped count(*) is
# one bincount, as the reference's one segment_sum, so Q45, Q49 and Q53
# launch no kernel
TEMPORAL_QUERIES = {
    "Q45": (Q45, "AggregateOp", ()),
    "Q46": (Q46, "CsrExpandOp", ("expand_rows",)),
    "Q47": (Q47, "CsrExpandOp", ("expand_rows", "segment_agg")),
    "Q48": (Q48, "JoinOp(inner", ("expand_rows", "join_probe")),
    "Q49": (Q49, "AggregateOp", ()),
    "Q50": (Q50, "CsrExpandOp", ("expand_rows", "segment_agg")),
    "Q51": (Q51, "CsrExpandOp", ("expand_rows",)),
    "Q52": (Q52, "CsrExpandOp", ("expand_rows",)),
    "Q53": (Q53, "AggregateOp", ()),
}
EXAMPLE_CREATE = (
    "CREATE (:Person {name: 'ada', born: date('1815-12-10')}), "
    "(:Person {name: 'grace', born: date('1906-12-09')}), "
    "(:Person {name: 'alan', born: date('1912-06-23')}), "
    "(:Person {name: 'edsger', born: date('1930-05-11')}), "
    "(:Event {name: 'launch', at: localdatetime('2019-03-09T11:45:22')})"
)
# examples/05_temporal.py's queries, each with its plan operator and the
# rows it prints, written out by hand
EXAMPLE_QUERIES = (
    ("MATCH (p:Person) WHERE p.born >= date('1900-01-01') "
     "RETURN p.name AS name, p.born.year AS year ORDER BY year", "FilterOp",
     [{"name": "grace", "year": 1906}, {"name": "alan", "year": 1912},
      {"name": "edsger", "year": 1930}]),
    ("MATCH (p:Person) WITH date.truncate('decade', p.born) AS dec, count(*) AS c "
     "RETURN toString(dec) AS decade, c ORDER BY decade", "AggregateOp",
     [{"decade": "1810-01-01", "c": 1}, {"decade": "1900-01-01", "c": 1},
      {"decade": "1910-01-01", "c": 1}, {"decade": "1930-01-01", "c": 1}]),
    ("MATCH (p:Person) RETURN p.name AS name, "
     "duration.between(p.born, date('2020-01-01')).years AS age ORDER BY age DESC LIMIT 2",
     "OrderByOp", [{"name": "ada", "age": 204}, {"name": "grace", "age": 113}]),
    ("MATCH (e:Event) RETURN e.at.hour AS h, e.at.minute AS m, e.at.dayOfWeek AS dow",
     "AddOp", [{"h": 11, "m": 45, "dow": 6}]),
)


def temporal_truth(ids, bday, s, d, q11):
    """Q45-Q53 from the generator's arrays with numpy ``datetime64``: the
    dates are the birthday days, the creation times
    ``ldbc.temporal_seconds`` of the edge and person indices."""
    import datetime as dt

    import numpy as np

    from tpu_cypher_torch.io import ldbc

    bdate = np.datetime64("1970-01-01", "D") + bday
    created = ldbc.TEMPORAL_EPOCH + ldbc.temporal_seconds(np.arange(len(s)), ldbc.KNOWS_SPREAD)
    months = bdate.astype("datetime64[M]").astype(np.int64)  # months since 1970-01
    years = months // 12 + 1970

    def groups(keys, conv):
        u, c = np.unique(keys, return_counts=True)
        return [(conv(k), int(n)) for k, n in zip(u, c)]

    def ldt(x):
        return np.datetime64(x, "us").astype(dt.datetime)

    quarter = (months // 3) * 3
    q49 = groups(quarter, lambda m: dt.date(1970 + int(m) // 12, int(m) % 12 + 1, 1))
    cmonth = created.astype("datetime64[M]").astype(np.int64) % 12  # 0..11
    last = np.full(len(ids), -1, np.int64)  # seconds after the epoch; -1: no KNOWS
    src_ok = ids[s] < Q15_ID_BOUND
    np.maximum.at(last, s[src_ok], (created[src_ok] - ldbc.TEMPORAL_EPOCH).astype(np.int64))
    hours = ldbc.temporal_seconds(np.arange(len(ids)), ldbc.CREATED_SPREAD) // 3600 % 24
    check(0 < int((last >= 0).sum()) <= 256, "Q50's groups must stay within 256")
    return {
        "Q45": [{"y": y, "c": c} for y, c in groups(years, int)],
        "Q46": [{"n": int((created >= np.datetime64("2012-01-01T00:00:00")).sum())}],
        "Q47": [{"lo": ldt(created.min()), "hi": ldt(created.max())}],
        "Q48": [{"n": q11}],
        "Q49": [{"q": q, "c": c} for q, c in q49],
        "Q50": [{"id": int(ids[i]), "last": ldt(ldbc.TEMPORAL_EPOCH + last[i])}
                for i in np.flatnonzero(last >= 0)],
        "Q51": [{"t": ldt(x)} for x in np.sort(created)[::-1][:20]],
        "Q52": [{"m": m, "c": c} for m, c in groups((cmonth + 1) % 12 + 1, int)],
        "Q53": [{"h": h, "c": c} for h, c in groups(hours, int)],
    }


def temporal_graph(torch, session, card, scale=10.0):
    """SF10 with its temporal properties (``generate_snb(temporal=True)``),
    generated and ingested through the port's normal graph construction;
    prints the seconds it takes."""
    from tpu_cypher_torch.io import ldbc
    from tpu_cypher_torch.relational.session import PropertyGraph

    t0 = time.perf_counter()
    gt = PropertyGraph(session, ldbc.generate_snb(scale, session, seed=SEED, temporal=True))
    torch.cuda.synchronize()
    print(f"  temporal SF10 graph ({card}): generated and ingested with its date, "
          f"datetime and localdatetime columns in {time.perf_counter() - t0:.3f} s")
    return gt


def run_temporal_queries(torch, run, card, session, truth):
    """Phase 4's temporal block: SF10 with its temporal properties, then
    Q45-Q53, each cold and five times warm against ``temporal_truth``, with
    its warm median, its own peak device memory and its launches per
    (kernel, tier); then ``examples/05_temporal.py``'s queries against
    their printed rows."""
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    gt = temporal_graph(torch, session, card)
    for name, (q, plan_op, kernels) in TEMPORAL_QUERIES.items():
        label = f"{name} (SF10)"
        before = dispatch.use_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        rows, secs, _ = run(label, gt, q, kernels, plan_op=plan_op, warm=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = dispatch.use_counts()
        tiers = {f"{k}/{t}": after[k][t] - before[k][t] for k in after for t in after[k]
                 if after[k][t] > before[k][t]}
        rows = [dict(r) for r in rows]
        check(rows == truth[name], f"{name} {rows[:3]} != {truth[name][:3]}")
        print(f"    {label} ({card}): cold {secs[0] * 1e3:.3f} ms, warm median "
              f"{statistics.median(secs[1:]) * 1e3:.3f} ms over {len(secs) - 1} runs; "
              f"peak device memory {peak:.3f} GiB, {peak - held:.3f} GiB its own; "
              f"launches per (kernel, tier) over the six runs {tiers}")
        print(f"    {name} = {rows if len(rows) < 4 else f'{len(rows)} rows'}, "
              f"equal to numpy datetime64")
    del gt
    ex = session.create_graph_from_create_query(EXAMPLE_CREATE)
    for i, (q, plan_op, want) in enumerate(EXAMPLE_QUERIES):
        rows, secs, _ = run(f"05_temporal query {i + 1}", ex, q, (), plan_op=plan_op)
        rows = [dict(r) for r in rows]
        check(rows == want, f"05_temporal query {i + 1}: {rows} != {want}")
        print(f"    05_temporal query {i + 1} = {rows}, as written by hand")


@contextlib.contextmanager
def pinned(**values):
    """Config options (``tpu_cypher_torch.utils.config`` names) pinned for
    a block; the plan cache keys on the ones that shape a plan."""
    from tpu_cypher_torch.utils import config as C

    opts = [getattr(C, k) for k in values]
    for opt, v in zip(opts, values.values()):
        opt.set(v)
    try:
        yield
    finally:
        for opt in opts:
            opt.reset()


def scan_graph(session, nodes, rels):
    """A graph built from arrays: ``nodes`` {label: ids}, each node with
    its id as property ``id``, and ``rels`` {type: (ids, src, dst)}."""
    from tpu_cypher_torch.api import types as T
    from tpu_cypher_torch.api.mapping import NodeMapping, RelationshipMapping
    from tpu_cypher_torch.api.schema import PropertyGraphSchema
    from tpu_cypher_torch.relational.graphs import ElementTable, ScanGraph
    from tpu_cypher_torch.relational.session import PropertyGraph

    tables = []
    schema = PropertyGraphSchema.empty()
    for label, ids in nodes.items():
        tables.append(ElementTable(
            NodeMapping(id_key="id", implied_labels=frozenset({label}),
                        property_mapping=(("id", "id"),)),
            session.table_cls.from_arrays({"id": ids}),
        ))
        schema = schema.with_node_combination(frozenset({label}),
                                              {"id": T.CTInteger.nullable})
    for rtype, (eids, src, dst) in rels.items():
        tables.append(ElementTable(
            RelationshipMapping(id_key="id", source_key="source", target_key="target",
                                rel_type=rtype),
            session.table_cls.from_arrays({"id": eids, "source": src, "target": dst}),
        ))
        schema = schema.with_relationship_type(rtype, {})
    return PropertyGraph(session, ScanGraph(tables, schema))


def fan_graph(session, k):
    """``tests/test_factorized.py``'s fan from arrays: k sources -> 1 hub ->
    k targets, so the 2-hop has k * k flat rows from 2k edges."""
    import numpy as np

    src_ids = np.arange(k, dtype=np.int64)
    tgt_ids = np.arange(k + 1, 2 * k + 1, dtype=np.int64)
    hub = np.full(k, k, dtype=np.int64)
    return scan_graph(session, {"S": src_ids, "H": np.array([k], np.int64), "T": tgt_ids}, {
        "R1": (np.arange(k, dtype=np.int64) + (1 << 40), src_ids, hub),
        "R2": (np.arange(k, dtype=np.int64) + (1 << 41), hub, tgt_ids),
    })


def join_order_arrays(n=30_000, dense_e=300_000, rare_e=600):
    """``bench.py`` ``_join_order_graph``'s arrays (the same draws from
    ``default_rng(17)``): node ids 0..n-1, 1 in 50 Admin, KNOWS and RARE
    edges with self-loops dropped."""
    import numpy as np

    rng = np.random.default_rng(17)
    ids = np.arange(n, dtype=np.int64)
    rels = {}
    for rtype, count, base in (("KNOWS", dense_e, 1 << 40), ("RARE", rare_e, 1 << 41)):
        src = rng.integers(0, n, count)
        dst = rng.integers(0, n, count)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        rels[rtype] = (np.arange(len(src), dtype=np.int64) + base, src, dst)
    return ids, ids % 50 == 0, rels


def join_order_truth(ids, admin, rels):
    """scipy counts of Q40-Q44 honouring relationship uniqueness. Only Q41
    can bind one KNOWS edge twice (r0 = r2 when a KNOWS edge c->b closes
    the RARE edge b->c): those bindings are taken out. Q42, Q43 and Q44
    would need a self-loop, and there is none."""
    import numpy as np
    import scipy.sparse as sp

    n = len(ids)
    person = ~admin

    def adj(rtype):
        _, s, d = rels[rtype]
        check(not (s == d).any(), f"{rtype} has a self-loop")
        m = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
        m.sum_duplicates()
        return m

    K, Rr = adj("KNOWS"), adj("RARE")
    kin_p = K.T @ person.astype(np.int64)  # KNOWS into each node from persons
    kout_p = K @ person.astype(np.int64)
    kout_a = K @ admin.astype(np.int64)
    rs, rd = Rr.nonzero()
    rw = np.asarray(Rr[rs, rd]).ravel()
    q40 = int((person * kin_p * (Rr @ admin.astype(np.int64))).sum())
    # Q41: a:Person -KNOWS-> b -RARE-> c -KNOWS-> d:Person, less r0 = r2:
    # the edge c->b with c (as a) and b (as d) both persons
    both = person[rs] & person[rd]
    same = np.asarray(K[rd, rs]).ravel() * both
    q41 = int((rw * (kin_p[rs] * kout_p[rd] - same)).sum())
    q42 = int((person * kin_p * kout_a).sum())
    # Q43: per RARE edge b->c with b a person: sum over persons a of
    # K[c, a] * K[a, b]
    KP = K.multiply(person.astype(np.int64)[None, :]).tocsr()
    q43 = int((rw * person[rs] * np.asarray(
        KP[rd].multiply(K.T.tocsr()[rs]).sum(axis=1)).ravel()).sum())
    low_admin = admin & (ids < 40)
    q44 = int((person * kin_p * (K @ low_admin.astype(np.int64))).sum())
    return dict(zip((name for name, _ in JOIN_ORDER_QUERIES), (q40, q41, q42, q43, q44)))


def clique_truth(ids, src, dst):
    """scipy truth of the 4-clique queries: the directed triangle rows
    (a, b, c) with their multiplicity w, then each d with a->d, b->d and
    c->d: Q37's count (every binding, multiplicities multiplied) and its
    min and max d.id, Q36's distinct d, and the pivot lanes
    sum(w * out(a)) the WCOJ materialize iterates. Loop-free (checked), so
    distinct endpoints force distinct relationships."""
    import numpy as np
    import scipy.sparse as sp

    check(not (src == dst).any(), "the Q36 graph has a self-loop")
    n = len(ids)
    s, d = np.searchsorted(ids, src), np.searchsorted(ids, dst)
    A = sp.csr_matrix((np.ones(len(s), np.int64), (s, d)), shape=(n, n))
    A.sum_duplicates()
    AT = A.T.tocsr()
    out_deg = np.bincount(s, minlength=n)
    tri = cliques = pivot = 0
    hubs = np.zeros(n, bool)
    for lo in range(0, n, 512):
        closing = (A[lo:lo + 512] @ A).multiply(AT[lo:lo + 512]).tocoo()
        if closing.nnz == 0:
            continue
        a, c = closing.row.astype(np.int64) + lo, closing.col.astype(np.int64)
        B = A[a].multiply(AT[c]).tocoo()  # per (a, c) pair: b with a->b->c
        w = B.data * np.asarray(AT[a, c]).ravel()[B.row]  # times c->a
        ta, tb, tc = a[B.row], B.col.astype(np.int64), c[B.row]
        tri += int(w.sum())
        pivot += int((w * out_deg[ta]).sum())
        D = A[ta].multiply(A[tb]).multiply(A[tc]).tocoo()
        cliques += int((w[D.row] * D.data).sum())
        hubs[D.col] = True
    hub_ids = ids[hubs]
    return {"triangles": tri, "pivot_lanes": pivot, "Q37": [{
        "n": cliques, "lo": int(hub_ids.min()), "hi": int(hub_ids.max())}],
        "Q36": [{"hubs": int(hubs.sum())}]}


def two_hop_group_truth(ids, s, d):
    """numpy truth of Q38: per a.id % 256, the 2-paths a->b->c (sum over
    b in out(a) of out(b)) and their sum of a.id."""
    import numpy as np

    n = len(ids)
    out_deg = np.bincount(s, minlength=n)
    paths = np.bincount(s, weights=out_deg[d], minlength=n).astype(np.int64)
    g = ids % 256
    return {int(k): (int(paths[g == k].sum()), int((paths * ids)[g == k].sum()))
            for k in np.unique(g) if paths[g == k].sum()}


def factorized_notes(result):
    return [sp.attrs["factorized"] for sp in result.profile().trace.spans()
            if "factorized" in sp.attrs]


def run_factorized_queries(torch, run, last, slice_launches, session, g10, ids10, s10,
                           d10):
    """Phase 4's factorized queries: Q36 and Q37 on SF0.5, Q38 at SF10, and
    the fan streamed through the cursor (Q39); each checked against
    numpy/scipy truth, its tier and its route. Returns what phase 5 needs."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda import bucketing
    from tpu_cypher_torch.backend.cuda.factorized import FactorizedTable
    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    t0 = time.perf_counter()
    g05 = PropertyGraph(session, generate_snb(Q36_SCALE, session, seed=SEED))
    ids05, _, src05, dst05 = graph_arrays(g05)
    cliques = clique_truth(ids05, src05, dst05)
    print(f"  SF{Q36_SCALE}: {len(ids05)} persons, {len(src05)} KNOWS, "
          f"{cliques['triangles']} triangle rows, {cliques['Q37'][0]['n']} 4-cliques over "
          f"{cliques['Q36'][0]['hubs']} distinct d; the materialize's pivot lanes "
          f"{cliques['pivot_lanes']} (scipy, {time.perf_counter() - t0:.1f} s with the graph)")
    wcoj = ("expand_rows", "intersect", "segment_agg")
    mwi = "MultiwayIntersectOp"

    def peaked(label, pg, q, kernels, **kw):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        rows, secs, lanes = run(label, pg, q, kernels, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    {label} cold {secs[0] * 1e3:.3f} ms, warm {secs[1] * 1e3:.3f} ms; "
              f"peak device memory {peak:.3f} GiB, {peak - held:.3f} GiB its own")
        return [dict(r) for r in rows], lanes

    with pinned(WCOJ_MODE="force", FACTORIZE="force"):
        rows, _ = peaked(f"Q36 (SF{Q36_SCALE})", g05, Q36, wcoj, plan_op=mwi,
                         wcoj_tiers={"factorized": 2})
    check(rows == cliques["Q36"], f"Q36 {rows} != {cliques['Q36']}")
    notes = factorized_notes(last[f"Q36 (SF{Q36_SCALE})"])
    big = max(notes, key=lambda x: x["true_rows"])
    print(f"    Q36 = {rows[0]}; factorized notes (flat rows, lanes, runs): "
          f"{[(x['true_rows'], x['padded_rows'], x['run_count']) for x in notes]}; "
          f"the 4-clique's {big['run_count']} lanes against its {big['true_rows']} flat rows")
    check(big["true_rows"] == cliques["Q37"][0]["n"]
          and big["run_count"] == cliques["pivot_lanes"],
          f"Q36's factorized 4-clique {big} != scipy's lanes and rows")
    rows, _ = peaked(f"Q37 (SF{Q36_SCALE})", g05, Q37, wcoj, plan_op=mwi,
                     wcoj_tiers={"materialize": 2})
    check(rows == cliques["Q37"], f"Q37 {rows} != {cliques['Q37']}")
    print(f"    Q37 = {rows[0]} under the defaults: the flat decode at the output extent")

    q38 = two_hop_group_truth(ids10, s10, d10)
    with pinned(FACTORIZE="force"):
        rows, _ = peaked("Q38 (SF10)", g10, Q38, ("expand_rows", "segment_agg"),
                         plan_op="AggregateOp")
    got = {r["g"]: (r["paths"], r["s"]) for r in rows}
    check(got == q38, "Q38 groups differ from numpy")
    res = last["Q38 (SF10)"]
    notes = factorized_notes(res)
    check(any(x["true_rows"] == sum(p for p, _ in q38.values()) for x in notes),
          f"Q38's final hop did not take the factorized route: {notes}")
    check("uniq" not in res.plans and "FilterOp" not in res.plans,
          "Q38's uniqueness pair was not proven redundant")
    print(f"    Q38 = {len(rows)} groups, equal to numpy; factorized notes (flat rows, "
          f"lanes, runs) {[(x['true_rows'], x['padded_rows'], x['run_count']) for x in notes]}; "
          f"the pair r0 <> r1 proven redundant (no FilterOp, no uniq)")

    gfan = fan_graph(session, FAN)
    before = dispatch.use_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with pinned(FACTORIZE="force"):
        res = gfan.cypher(Q39)
        recs = res.records
        table = recs.table
        xs = np.zeros(FAN, np.int64)
        ys = np.zeros(FAN, np.int64)
        nchunks = total = 0
        for chunk in recs.iter_chunks(Q39_CHUNK):
            nchunks += 1
            total += len(chunk)
            xs += np.bincount([r["x"] for r in chunk], minlength=FAN)
            ys += np.bincount([r["y"] - FAN - 1 for r in chunk], minlength=FAN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    after = dispatch.use_counts()
    for name in after:
        dd = {t: after[name][t] - before[name][t] for t in after[name]}
        check(dd["fallback"] == 0 and dd["plain"] == 0, f"Q39: {name} left the kernel tier")
        slice_launches[name] = slice_launches.get(name, 0) + dd["kernel"]
    check(isinstance(table, FactorizedTable), f"Q39 is not factorized: {table!r}")
    check(total == FAN * FAN and (xs == FAN).all() and (ys == FAN).all(),
          "Q39's streamed bag differs from the fan's")
    check(after["expand_rows"]["kernel"] > before["expand_rows"]["kernel"],
          "Q39's decode did not launch expand_rows")
    flat_bytes = FAN * FAN * 2 * 9  # two int64 columns and their validity bytes
    print(f"  Q39 (fan {FAN} x {FAN}): {table!r}; {total} rows in {nchunks} chunks of "
          f"{Q39_CHUNK} in {secs:.3f} s, bag checked by bincount; device peak during the "
          f"stream {peak / 2**20:.3f} MiB over what was held, the flat form "
          f"{flat_bytes / 2**20:.3f} MiB; expand_rows launches "
          f"{after['expand_rows']['kernel'] - before['expand_rows']['kernel']}")
    return g05, cliques, q38


def run_join_order_queries(run, cold, session):
    """Phase 4's join-order queries, Q40-Q44 (``bench.py``'s five) on a
    copy of its graph: under the default ``auto`` and under ``syntax``,
    each count equal to scipy's, each ``join_order`` note printed. Returns
    the graph and the truth for phase 5."""
    from tpu_cypher_torch.optimizer import feedback

    t0 = time.perf_counter()
    arrays = join_order_arrays()
    ids, admin, rels = arrays
    g = scan_graph(session, {"Person": ids[~admin], "Admin": ids[admin]}, rels)
    truth = join_order_truth(*arrays)
    print(f"  join-order graph: {len(ids)} nodes ({int(admin.sum())} Admin), "
          f"{len(rels['KNOWS'][0])} KNOWS, {len(rels['RARE'][0])} RARE; truth {truth} "
          f"({time.perf_counter() - t0:.1f} s)")
    reordered = 0
    for name, query in JOIN_ORDER_QUERIES:
        plan_op = "CsrExpandIntoOp" if "cycle" in name else "CsrExpandOp"
        feedback.reset_for_tests()  # the uncalibrated model, as a first run
        rows, secs, _ = run(f"{name} (auto)", g, query, (), plan_op=plan_op)
        check([dict(r) for r in rows] == [{"c": truth[name]}],
              f"{name} {rows} != {truth[name]}")
        notes = [sp.attrs["join_order"] for sp in cold[f"{name} (auto)"].profile()
                 .trace.spans() if "join_order" in sp.attrs]
        reordered += any(x["chosen"] == "model" for x in notes)
        with pinned(OPT_MODE="syntax"):
            rows_s, _, _ = run(f"{name} (syntax)", g, query, (), plan_op=plan_op)
        check(rows_s == rows, f"{name}: syntax order gave {rows_s}")
        print(f"    {name} = {rows[0]['c']}, equal to scipy and to syntax order; "
              f"join_order {notes}")
    print(f"    auto reordered {reordered} of {len(JOIN_ORDER_QUERIES)} join-order queries")
    return g, truth


def run_shaping_queries(torch, run, slice_launches, g1, g10, truth):
    """Phase 4's row shaping and grouping queries, Q13-Q16: each cold, then
    five warm runs, with its warm median and peak device memory, checked
    against ``shaping_truth``."""
    from tpu_cypher_torch.backend.cuda.table import CudaTable

    def shaped(label, pg, q, kernels, plan_op):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        rows, secs, _ = run(label, pg, q, kernels, plan_op=plan_op, warm=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    {label} warm median {statistics.median(secs[1:]) * 1e3:.3f} ms over "
              f"{len(secs) - 1} runs (s: {[round(x, 6) for x in secs[1:]]}); peak device "
              f"memory {peak:.3f} GiB, of which {held:.3f} GiB held before the query "
              f"(graphs, indexes)")
        return [dict(r) for r in rows]

    def topk_said(topk):
        said = "answered (packed top-k)" if all(t is not None for t in topk) else "returned None"
        return f"order_by_limit {said} in {len(topk)} runs"

    from tpu_cypher_torch.backend.cuda import jit_ops as J

    calls, distinct_calls = {}, []
    launched = slice_launches.get("expand_rows", 0)
    # the fused walk, which the dense tier replaces under the defaults
    # (run_dense_queries)
    with counted(J, ("distinct_pairs_count_final",), calls), \
            recorded(CudaTable, "distinct_count", distinct_calls), pinned(MXU_DENSE="0"):
        rows = shaped("Q13 (SF1, MXU_DENSE=0)", g1, Q13, ("expand_rows",), "DistinctOp")
    launched = slice_launches["expand_rows"] - launched
    check(rows == [{"pairs": truth["Q13"]}], f"Q13 {rows} != {truth['Q13']}")
    check(calls == {"distinct_pairs_count_final": 6} and not distinct_calls
          and launched == 12,
          f"Q13 not on the fused walk: {calls}, {len(distinct_calls)} distinct_count "
          f"calls, {launched} expand_rows launches in six runs")
    print(f"    Q13 = {truth['Q13']} distinct (a, c) over {truth['Q13_rows']} 2-hop rows; "
          f"the fused walk: distinct_pairs_count_final once a run, no distinct_count, "
          f"expand_rows twice a run")
    topk = []
    with recorded(CudaTable, "order_by_limit", topk):
        rows = shaped("Q14 (SF10)", g10, Q14, ("expand_rows",), "OrderByOp")
    check(rows == truth["Q14"], f"Q14 rows differ from numpy: {rows[:3]} ...")
    print(f"    Q14 = the top {len(rows)} by out-degree (first {rows[0]}), equal to numpy "
          f"row for row; {topk_said(topk)}")
    agg_before = slice_launches.get("segment_agg", 0)
    rows = shaped("Q15 (SF10)", g10, Q15, ("expand_rows", "segment_agg"), "AggregateOp")
    check(rows == truth["Q15"], "Q15 rows differ from numpy")
    check(slice_launches["segment_agg"] - agg_before == 12,
          "Q15's six runs did not launch segment_agg twice each (min, max)")
    print(f"    Q15 = {len(rows)} groups (k={len(truth['Q15'])}) over {truth['Q15_rows']} "
          f"rows, equal to numpy row for row; min and max on the segment_agg kernel tier")
    topk = []
    with recorded(CudaTable, "order_by_limit", topk):
        rows = shaped("Q16 (SF10)", g10, Q16, ("expand_rows",), "DistinctOp")
    check(rows == truth["Q16"], f"Q16 rows differ from numpy: {rows[:3]} ...")
    print(f"    Q16 = {len(rows)} of {truth['Q16_distinct']} distinct birthdays after "
          f"SKIP 100, equal to numpy row for row; {topk_said(topk)}")


# ---------------------------------------------------------------------------
# phase 4: the dense count tier, the standalone kernel API, the edge list
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core rate (NVIDIA's data sheet; 700 W)
BF16_FLOPS_PER_S = 989e12
DENSE_TILED_CAP = 8192  # TPU_CYPHER_MXU_DENSE_MAX pinned below SF1's 10,000 persons


def mxu_tiers():
    from tpu_cypher_torch.backend.cuda import expand_op as X

    return dict(X.MXU_TIER_COUNTS)


# the triangle with its arrows reversed: the same directed 3-cycles, so
# the same count, with the hops over in-edges
Q6R = ("MATCH (a:Person)<-[:KNOWS]-(b:Person)<-[:KNOWS]-(c:Person)<-[:KNOWS]-(a) "
       "RETURN count(*) AS triangles")


def run_dense_queries(torch, run, last, g1, q13_truth, tri1):
    """Phase 4's dense count tier at SF1 (10,000 persons, padded to 10,240:
    40 row blocks of 256). Q13 (TWO_HOP_DISTINCT) under the defaults runs
    as bf16 products on the tensor cores; so does Q6R, the triangle with
    its arrows reversed (WCOJ's ``auto`` hands its count back). Q6 itself
    is handed back too, but the reference's float32 guard (max row sum x
    max entry x max closing entry <= 2**24) declines it over out-edges, so
    it walks the binary plan, as the reference does. Each also under
    ``TPU_CYPHER_MXU_DENSE=0`` (the walk: the fused DISTINCT walk, WCOJ's
    count, and for Q6R under ``TPU_CYPHER_WCOJ=off`` the binary plan's
    walk, the path the dense tier takes over) and under the tiled tier
    (``force`` with ``TPU_CYPHER_MXU_DENSE_MAX`` pinned below SF1's N).
    Each runs cold and five times warm (tiled: twice), held to the
    numpy/scipy truth and to its tiers per run, with its warm median and
    own peak device memory. Then the products alone, on the arguments the
    queries passed (CUDA events), against the flop bound 2 * Npad**3 over
    the card's dense bf16 rate, and one whole ``torch.mm`` beside them."""
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.graph_index import GraphIndex

    dense0, walk0 = {"dense": 1, "tiled": 0}, {"dense": 0, "tiled": 0}
    tiled0 = {"dense": 0, "tiled": 1}
    walks = ("expand_rows", "intersect")
    mxu0, wcoj0 = {"MXU_DENSE": "0"}, {"MXU_DENSE": "0", "WCOJ_MODE": "off"}
    tiled = {"MXU_DENSE": "force", "MXU_DENSE_MAX": DENSE_TILED_CAP}
    mwi = "MultiwayIntersectOp"
    variants = (
        # label, query, pins, plan operator, kernels, WCOJ tiers and MXU
        # tiers per run, warm runs
        ("Q13 dense (SF1)", Q13, {}, "CsrExpandOp", (), (), dense0, 5),
        ("Q13 walk (SF1, MXU_DENSE=0)", Q13, mxu0, "CsrExpandOp", ("expand_rows",), (),
         walk0, 5),
        ("Q13 tiled (SF1)", Q13, tiled, "CsrExpandOp", (), (), tiled0, 2),
        ("Q6 defaults (SF1)", Q6, {}, mwi, walks, ("handback",), walk0, 5),
        ("Q6 WCOJ count (SF1, MXU_DENSE=0)", Q6, mxu0, mwi, walks, ("count",), walk0, 5),
        ("Q6R dense (SF1)", Q6R, {}, mwi, (), ("handback",), dense0, 5),
        ("Q6R WCOJ count (SF1, MXU_DENSE=0)", Q6R, mxu0, mwi, walks, ("count",), walk0, 5),
        ("Q6R binary walk (SF1, MXU_DENSE=0, WCOJ off)", Q6R, wcoj0, "CsrExpandIntoOp",
         walks, (), walk0, 5),
        ("Q6R tiled (SF1)", Q6R, tiled, mwi, (), ("handback",), tiled0, 2),
    )
    want = {"Q13": [{"pairs": q13_truth}], "Q6": [{"triangles": tri1}],
            "Q6R": [{"triangles": tri1}]}
    medians, captured = {}, {}
    products = {name: getattr(J, name) for name in ("mxu_distinct_pairs", "mxu_close_count")}

    def capture(name):
        def hook(*args, **kwargs):
            captured[name] = (args, kwargs)
            return products[name](*args, **kwargs)
        return hook

    for label, q, pins, plan_op, kernels, wcoj_tiers, per_run, warm in variants:
        before = mxu_tiers()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for name in products:
            setattr(J, name, capture(name))
        try:
            with pinned(**pins):
                rows, secs, _ = run(label, g1, q, kernels, plan_op=plan_op,
                                    wcoj_tiers=wcoj_tiers, warm=warm)
        finally:
            for name, fn in products.items():
                setattr(J, name, fn)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        moved = {k: v - before[k] for k, v in mxu_tiers().items()}
        key = label.split()[0]
        check([dict(r) for r in rows] == want[key], f"{label}: {rows} != {want[key]}")
        check(moved == {k: n * (1 + warm) for k, n in per_run.items()},
              f"{label}: MXU tiers moved {moved}, expected {per_run} per run")
        medians[label] = statistics.median(secs[1:])
        print(f"    {label} = {rows[0]}; MXU tiers per run {per_run}; warm median "
              f"{medians[label] * 1e3:.3f} ms over {warm} runs (s: "
              f"{[round(x, 6) for x in secs[1:]]}); own peak device memory {peak:.3f} GiB")
    # the float32 guard of the close count, by orientation
    plan = last["Q6 defaults (SF1)"].relational_plan
    gi, ctx = GraphIndex.of(plan.graph), plan.context
    guards = {}
    for rev in (False, True):
        _, entry, rowsum = gi.dense_adj(("KNOWS",), rev, ctx)
        guards["in-edges" if rev else "out-edges"] = (rowsum, entry, rowsum * entry * entry)
    print(f"  the close count's float32 guard (max row sum, max entry, their product with "
          f"the closing entry; the limit 2**24 = {1 << 24}): {guards}")
    check(guards["out-edges"][2] > 1 << 24 >= guards["in-edges"][2],
          "the guard no longer splits the two orientations")
    # the products alone, at the queries' own arguments
    args_d, kw_d = captured["mxu_distinct_pairs"]
    args_c, kw_c = captured["mxu_close_count"]
    check(int(products["mxu_distinct_pairs"](*args_d, **kw_d)) == q13_truth
          and int(products["mxu_close_count"](*args_c, **kw_c)) == tri1,
          "the dense products alone disagree with the truth")
    a = args_d[0]
    npad = int(a.shape[0])
    flops = 2.0 * npad ** 3
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    times = {
        "mxu_distinct_pairs (Q13)": time_ms(
            torch, lambda: products["mxu_distinct_pairs"](*args_d, **kw_d), iters=10),
        "mxu_close_count (Q6R)": time_ms(
            torch, lambda: products["mxu_close_count"](*args_c, **kw_c), iters=10),
        "one torch.mm (bf16 in, float32 out)": time_ms(
            torch, lambda: torch.mm(a, a, out_dtype=torch.float32), iters=10),
    }
    print(f"  dense products at SF1: Npad {npad}, row blocks of {J.MM_ROWS}; 2*Npad^3 = "
          f"{flops:.4e} operations, bound {bound_ms:.4f} ms at {BF16_FLOPS_PER_S:.4g} bf16 "
          f"operations/s")
    for name, ms in times.items():
        print(f"    {name}: {ms:.4f} ms ({bound_ms / ms:.3f} of the bound)")
    for q, base in (("Q13", "Q13 dense (SF1)"), ("Q6R", "Q6R dense (SF1)"),
                    ("Q6", "Q6 defaults (SF1)")):
        others = {k: v for k, v in medians.items() if k.startswith(q + " ") and k != base}
        print(f"    {base} {medians[base] * 1e3:.3f} ms warm median against "
              + ", ".join(f"{k} {v * 1e3:.3f} ms ({v / medians[base]:.2f}x)"
                          for k, v in others.items()))


def run_kernel_api(torch, slice_launches, ids, src, dst, s, d, q4, q17, tri):
    """Phase 4's standalone kernel API (``backend/cuda/kernels.py``) at
    SF10: ``CsrGraph.build`` through the native tier, timed against the
    numpy build and equal to it; ``two_hop_count`` on the
    ``frontier_deg_sum`` kernel tier (Q4's path count), ``two_hop_expand``
    on ``expand_rows`` (Q17's distinct pairs), ``triangle_count`` on
    ``expand_rows`` and ``intersect`` (the triangle truth) and
    ``walk_counts`` (numpy), each timed by the host clock around a
    synchronized call; the launches join the slice's."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda import kernels as K
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    t0 = time.perf_counter()
    g = K.CsrGraph.build(ids, src, dst)
    torch.cuda.synchronize()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = K._build_csr_numpy(ids, src, dst)
    numpy_s = time.perf_counter() - t0
    check(all(np.array_equal(x.cpu().numpy(), y) for x, y in
              zip((g.node_ids, g.row_ptr, g.col_idx, g.src_idx), ref)),
          "the native CSR differs from the numpy build")
    print(f"  kernel API at SF10: CsrGraph.build {native_s:.3f} s through the native "
          f"tier (to the card), numpy's build {numpy_s:.3f} s, equal")
    before = dispatch.use_counts()
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    total = int(timed("two_hop_count", lambda: K.two_hop_count(g.row_ptr, g.col_idx)))
    check(total == q4, f"two_hop_count {total} != {q4}")
    _, _, distinct = timed("two_hop_expand", lambda: K.two_hop_expand(
        g.row_ptr, g.col_idx, g.src_idx, total))
    check(int(distinct) == q17, f"two_hop_expand distinct {int(distinct)} != {q17}")
    got = int(timed("triangle_count", lambda: K.triangle_count(
        g.row_ptr, g.col_idx, g.src_idx, total)))
    check(got == tri, f"triangle_count {got} != {tri}")
    n = len(ids)
    start = np.zeros(n, np.int64)
    start[:1000] = 1
    per_hop = timed("walk_counts", lambda: K.walk_counts(g.src_idx, g.col_idx, start, 3, n))
    p, want = start.astype(np.float64), []
    for _ in range(3):
        p = np.bincount(d, weights=p[s], minlength=n)
        want.append(p)
    want = np.stack(want)
    check(want.max() < 2**53 and np.array_equal(per_hop.cpu().numpy(), want.astype(np.int64)),
          "walk_counts differs from numpy")
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = dispatch.use_counts()
    moved = {k: {t: after[k][t] - before[k][t] for t in after[k]} for k in after}
    expect = {"frontier_deg_sum": 1, "expand_rows": 2, "intersect": 1}
    for name, c in moved.items():
        check(c["fallback"] == 0 and c["plain"] == 0 and c["kernel"] == expect.get(name, 0),
              f"kernel API launches of {name}: {c}, expected {expect.get(name, 0)}")
        slice_launches[name] = slice_launches.get(name, 0) + c["kernel"]
    print(f"    two_hop_count = {total} (Q4), two_hop_expand distinct = {int(distinct)} "
          f"(Q17) over {total} lanes, triangle_count = {got}, walk_counts from 1,000 "
          f"sources over 3 hops = {int(per_hop.sum())} walks; seconds "
          f"{ {k: round(v, 6) for k, v in times.items()} }; launches {expect} on the "
          f"kernel tier; peak device memory {peak:.3f} GiB")
    del g, per_hop, distinct
    torch.cuda.empty_cache()


def run_edge_list(torch, run, session, src, dst):
    """Phase 4's edge-list source: SF10's KNOWS written as a SNAP file in a
    temporary directory, loaded by ``load_edge_list`` (the native parser),
    and Q2's count over its ``E`` relationships on ``frontier_deg_sum``."""
    import tempfile

    import numpy as np

    from tpu_cypher_torch import native
    from tpu_cypher_torch.io import load_edge_list
    from tpu_cypher_torch.relational.session import PropertyGraph

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "knows.txt")
        text = np.char.add(np.char.add(src.astype(str), " "), dst.astype(str))
        with open(path, "w") as f:
            f.write("# SF10 KNOWS, seed 42\n")
            f.write("\n".join(text.tolist()))
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        parsed = native.parse_edge_list_native(data)
        parse_s = time.perf_counter() - t0
        check(parsed is not None and np.array_equal(parsed[0], src)
              and np.array_equal(parsed[1], dst), "the native parser lost edges")
        t0 = time.perf_counter()
        pg = PropertyGraph(session, load_edge_list(path, session))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    rows, _, _ = run("Q2 on the edge list (SF10)", pg,
                     "MATCH (a)-[:E]->(b) RETURN count(*) AS c", ("frontier_deg_sum",))
    check([dict(r) for r in rows] == [{"c": len(src)}], f"edge-list Q2 {rows} != {len(src)}")
    print(f"    edge list: {size} bytes, {len(src)} edges; native parse {parse_s:.3f} s, "
          f"load_edge_list {load_s:.3f} s (parse and ingest); Q2 = {rows[0]['c']}")


def time_q14_fallback(torch, g10, q14_truth, report):
    """The ``segment_agg`` gate's ``min`` at Q14's group ids (about 100,000
    groups, past the kernel's 256): the ``fallback`` tier (the plain
    version's scatter), beside ``Tensor.scatter_reduce(..., "amin")`` alone
    and the byte bound, over seeded int64 values. The evidence for or
    against raising ``MAX_GROUPS``."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda import hopper
    from tpu_cypher_torch.backend.cuda import jit_ops as J
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    calls, rows = q_hooked_calls(g10, Q14, J, "group_index")
    check(rows == q14_truth and len(calls) == 1, "Q14 (hooked group_index)")
    args, kwargs = calls[0]
    seg_j, _ = J.group_index(*args, **kwargs)
    k = int(kwargs.get("k", args[2] if len(args) > 2 else 0))
    n = int(seg_j.shape[0])
    rng = np.random.default_rng(SEED)
    vals = torch.from_numpy(rng.integers(0, 18_000, n)).to(seg_j.device)
    before = dispatch.use_counts()["segment_agg"]

    def gate():
        return hopper.segment_aggregate(vals, None, None, seg_j, name="min", kind="i64", k=k)

    got = gate()
    big = torch.iinfo(torch.int64).max

    def scatter():
        return torch.full((k,), big, dtype=torch.int64, device=vals.device).scatter_reduce(
            0, seg_j, vals, "amin", include_self=True)

    check(torch.equal(got[0], scatter()), "the fallback min differs from scatter_reduce")
    ms = time_ms(torch, gate)
    scatter_ms = time_ms(torch, scatter)
    after = dispatch.use_counts()["segment_agg"]
    check(after["kernel"] == before["kernel"] and after["fallback"] > before["fallback"],
          f"the gate at k={k} did not take the fallback tier: {before} -> {after}")
    b_ms, b_by = bound(16 * n + 9 * k, 3 * n)
    report["segment_agg"].update(
        q14_fallback_min_ms=ms, q14_scatter_reduce_ms=scatter_ms, q14_bound_ms=b_ms,
        q14_shape=f"min(i64) through the gate at Q14's ids: {n} rows, k={k}, no mask",
    )
    print(f"  segment_agg gate min at Q14's ids ({n} rows, k={k}): fallback tier "
          f"{ms:.4f} ms, Tensor.scatter_reduce(amin) alone {scatter_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")


# the Q38 budget: over the first hop's flat rows (4.5M at SF10, under
# 0.3 GB) and under the final hop's (197M, over 6 GB)
Q38_BUDGET = 2 << 30


def time_factorized(torch, g10, g05, gjo, cliques, q38, jo_truth):
    """Phase 5's factorized and join-order measurements, ABBA-interleaved
    with each variant's own peak device memory: Q38 under ``force``, under
    ``auto`` with a memory budget that only the factorized route fits, and
    flat under ``off`` with no budget (``off`` with the budget must raise
    ``AdmissionRejected``); Q36 under ``force`` and its flat decode under
    ``off``; the join-order queries under ``syntax`` and ``force``."""
    from tpu_cypher_torch import errors as ERR

    print("  the factorized tier and the join order (warm, ABBA-interleaved):")
    with pinned(FACTORIZE="auto", MEM_BUDGET=Q38_BUDGET):
        res = g10.cypher(Q38)
        rows = [dict(r) for r in res.records.collect()]
    check({r["g"]: (r["paths"], r["s"]) for r in rows} == q38, "Q38 under a budget")
    notes = factorized_notes(res)
    check(any(x["true_rows"] == sum(p for p, _ in q38.values()) for x in notes),
          f"auto with a {Q38_BUDGET}-byte budget did not route Q38 factorized: {notes}")
    with pinned(FACTORIZE="off", MEM_BUDGET=Q38_BUDGET):
        try:
            g10.cypher(Q38).records.collect()
        except ERR.AdmissionRejected as exc:
            print(f"    Q38 under off with the budget: AdmissionRejected ({exc})")
        else:
            raise SmokeFailure("Q38 under off with the budget was admitted")
    print_times("Q38 (SF10)", warm_times(torch, g10, Q38, {
        "force": (lambda: pinned(FACTORIZE="force"), "AggregateOp", None),
        f"auto, budget {Q38_BUDGET}": (
            lambda: pinned(FACTORIZE="auto", MEM_BUDGET=Q38_BUDGET), "AggregateOp", None),
        "off": (lambda: pinned(FACTORIZE="off"), "AggregateOp", None),
    }, lambda rows: {r["g"]: (r["paths"], r["s"]) for r in rows} == q38))
    mwi = "MultiwayIntersectOp"
    print_times(f"Q36 (SF{Q36_SCALE})", warm_times(torch, g05, Q36, {
        "force": (lambda: pinned(WCOJ_MODE="force", FACTORIZE="force"), mwi, None),
        "off (flat decode)": (lambda: pinned(WCOJ_MODE="force", FACTORIZE="off"), mwi, None),
    }, lambda rows: rows == cliques["Q36"], rounds=2))
    for name, query in JOIN_ORDER_QUERIES:
        want = [{"c": jo_truth[name]}]
        op = "CsrExpandIntoOp" if "cycle" in name else "CsrExpandOp"
        print_times(name, warm_times(torch, gjo, query, {
            "syntax": (lambda: pinned(OPT_MODE="syntax"), op, None),
            "force": (lambda: pinned(OPT_MODE="force"), op, None),
        }, lambda rows, want=want: rows == want))


def serve_smoke(torch, session, tri1):
    """Phase 6, from ``scripts/serve_smoke.py`` beside this script."""
    import importlib.util

    path = os.path.join(HERE, "scripts", "serve_smoke.py")
    spec = importlib.util.spec_from_file_location("serve_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.run(sys.modules[__name__], torch, session, tri_small=tri1)


# ---------------------------------------------------------------------------
# phase 8: the mesh
# ---------------------------------------------------------------------------

# the kernels the mesh runs launch: the sharded range count and the grouped
# aggregates' partials once a shard, and Q11's join probe on the one
# device's path
MESH_KERNELS = ("intersect", "segment_agg", "join_probe")
# an integer grouped aggregate over every KNOWS (count, sum, min, max and
# avg as per-shard partials) and a DISTINCT count pushed down to the table
MESH_AGG_Q = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.id % 256 AS g, count(b.id) AS c, "
    "sum(b.birthday) AS s, min(b.birthday) AS lo, max(b.birthday) AS hi, avg(b.birthday) AS m"
)
MESH_DISTINCT_Q = (
    "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH DISTINCT b.birthday AS d RETURN count(*) AS n"
)
MESH_SHARDS = 4


def mesh_truth(ids, bday, s, d):
    """numpy truth of MESH_AGG_Q ({g: (c, s, lo, hi, m)}) and
    MESH_DISTINCT_Q."""
    import numpy as np

    g = ids[s] % 256
    v = bday[d]
    c = np.bincount(g, minlength=256)
    sm = np.zeros(256, np.int64)
    np.add.at(sm, g, v)
    lo = np.full(256, np.iinfo(np.int64).max)
    np.minimum.at(lo, g, v)
    hi = np.full(256, np.iinfo(np.int64).min)
    np.maximum.at(hi, g, v)
    agg = {int(k): (int(c[k]), int(sm[k]), int(lo[k]), int(hi[k]), float(sm[k] / c[k]))
           for k in range(256) if c[k]}
    return agg, int(len(np.unique(v)))


def mesh_notes(result, key):
    return [sp.attrs[key] for sp in result.profile().trace.spans() if key in sp.attrs]


def run_mesh_phase(torch, session, g10, arrays10, truth, tri10):
    """Phase 8: the SF10 queries of the mesh tiers on a virtual 4-shard mesh
    on cuda:0 and, where there is more than one card, on a mesh over every
    card; each answer equal to the numpy truth and to the single-device
    run, every launch of the mesh runs on the ``kernel`` tier (the counts
    zeroed before each query's mesh runs and read after them) and each
    sharded query's launches of its kernel a multiple of the shard count.
    Prints warm medians (single device against the mesh) and own peak
    device memory, and returns the per-kernel launches of the mesh runs."""
    import numpy as np

    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.obs.metrics import REGISTRY
    from tpu_cypher_torch.parallel import mesh as PM

    ids10, bday10, src10, dst10, s10, d10 = arrays10
    agg, distinct = mesh_truth(ids10, bday10, s10, d10)
    print(f"  truth: {len(agg)} groups, {distinct} distinct birthdays")

    def agg_ok(rows):
        return {r["g"]: (r["c"], r["s"], r["lo"], r["hi"], r["m"]) for r in rows} == agg

    # (label, query, pins, rows check, its kernel, launched once a shard,
    # plan op, WCOJ tiers, the tier counter that must advance)
    cases = [
        ("Q4 2-hop count", Q4, {}, lambda r: r == [{"c": truth["Q4"]}], None, False,
         "CsrExpandOp", (), None),
        ("Q6 (WCOJ force)", Q6, {"WCOJ_MODE": "force"},
         lambda r: r == [{"triangles": tri10["triangles"]}], "intersect", True,
         "MultiwayIntersectOp", ("count",), "tpu_cypher_mesh_wcoj_total"),
        ("grouped a.id % 256", MESH_AGG_Q, {}, agg_ok, "segment_agg", True, "AggregateOp",
         (), "tpu_cypher_mesh_agg_total"),
        ("DISTINCT count", MESH_DISTINCT_Q, {}, lambda r: r == [{"n": distinct}], None, False,
         "DistinctOp", (), None),
        ("Q11 value join", Q11, {}, lambda r: r == [{"n": truth["Q11"]}], "join_probe", False,
         "JoinOp(inner", (), None),
    ]
    meshes = [(f"{MESH_SHARDS} virtual shards on cuda:0",
               PM.make_row_mesh(["cuda:0"] * MESH_SHARDS))]
    cards = torch.cuda.device_count()
    if cards > 1:
        meshes.append((f"{cards} cards", PM.make_row_mesh()))
    else:
        print("  one card: it cannot show launches across devices; the virtual mesh "
              "runs every tier on cuda:0")

    def single(pg, query, warm=3):
        """The one-device run beside the mesh's: warm seconds and own peak
        memory (its tiers are phase 4's to check; avg runs the
        ``segment_agg`` gate's ``fallback`` there, as it does in phase 4)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = []
        for _ in range(1 + warm):
            t0 = time.perf_counter()
            result = pg.cypher(query)
            rows = [dict(r) for r in result.records.collect()]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            release_tables(result)
        return rows, secs, (torch.cuda.max_memory_allocated() - base) / 2**30

    def timed(pg, query, kernels, plan_op, tiers, warm):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rows, secs, launches, _, results = run_query(
            torch, pg, query, kernels, plan_op=plan_op, wcoj_tiers=tiers, warm=warm)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        return [dict(r) for r in rows], secs, launches, results, peak

    mesh_launches = {}
    for label, mesh in meshes:
        nsh = mesh.size
        print(f"  mesh: {label}")
        total = {}
        for name, query, pins, ok, kernel, per_shard, plan_op, tiers, counter in cases:
            kernels = (kernel,) if kernel else ()
            with pinned(**pins):
                rows1, secs1, peak1 = single(g10, query)
                check(ok(rows1), f"{name} on one device: {rows1[:3]}")
                before = REGISTRY.counter(counter).value() if counter else 0
                # run_query checks every mesh run: one device rung, the
                # plan, and no kernel launch off the kernel tier
                dispatch.reset()
                with PM.use_mesh(mesh):
                    rows, secs, launches, results, peak = timed(
                        g10, query, kernels, plan_op, tiers, 5)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            check(ok(rows), f"{name} on the mesh: {rows[:3]}")
            check(sorted(map(str, rows)) == sorted(map(str, rows1)),
                  f"{name}: the mesh's rows differ from the single device's")
            if counter:
                check(REGISTRY.counter(counter).value() >= before + len(results),
                      f"{name}: {counter} did not advance on every run")
            if name.startswith("Q4"):
                got = [mesh_notes(r, "expand_shards") for r in results]
                check(all(g == [nsh] for g in got), f"{name}: expand_shards {got}")
            per = ""
            if kernel:
                n = launches.get(kernel, 0)
                check(n > 0, f"{name}: no {kernel} launch on the mesh")
                per = f"; {kernel} {n // len(results)} a run"
            if per_shard:
                check(n % (nsh * len(results)) == 0,
                      f"{name}: {n} {kernel} launches over {len(results)} runs of {nsh} shards")
                per += f", {n // len(results) // nsh} a shard"
            print(f"    {name}: single device warm median {statistics.median(secs1[1:]) * 1e3:.3f} "
                  f"ms, own peak {peak1:.3f} GiB; mesh cold {secs[0]:.3f} s, warm median "
                  f"{statistics.median(secs[1:]) * 1e3:.3f} ms (fastest "
                  f"{min(secs[1:]) * 1e3:.3f}, slowest {max(secs[1:]) * 1e3:.3f}), own peak "
                  f"{peak:.3f} GiB; launches {launches}{per}")
        for k in MESH_KERNELS:
            check(total.get(k, 0) > 0, f"{k} never launched on the mesh")
        mesh_launches[label] = {k: total.get(k, 0) for k in MESH_KERNELS}
        print(f"    kernel-tier launches of the mesh runs on this mesh: {total}")
    return mesh_launches


def run_multihost(torch, two_hop_sf1):
    """Phase 8's multi-process run: two worker processes on cuda:0 joined
    over ``gloo`` (NCCL refuses two ranks on one card), 2 virtual shards
    each, run ``dryrun_multihost`` at SF1; both check their answers against
    numpy, and both must agree with each other and with SF1's 2-hop
    truth."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    try:
        for rank in (0, 1):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                       PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpu_cypher_torch.parallel.multihost", "--scale", "1.0",
                 "cuda:0", "cuda:0"],
                cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports = []
        for p in procs:
            out, _ = p.communicate(timeout=300)
            lines = [l for l in out.splitlines() if l.startswith("REPORT ")]
            check(p.returncode == 0 and lines, f"multihost worker failed: {out[-3000:]}")
            reports.append(json.loads(lines[-1][len("REPORT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check([r["processes"] for r in reports] == [2, 2]
          and [r["devices"] for r in reports] == [4, 4]
          and {r["host0"] for r in reports} == {True, False},
          f"multihost reports {reports}")
    check(reports[0]["two_hop"] == reports[1]["two_hop"] == two_hop_sf1
          and reports[0]["rows"] == reports[1]["rows"],
          f"the two processes disagree: {reports}")
    print(f"  multihost: 2 processes x 2 virtual shards on cuda:0 over "
          f"{reports[0]['backend']}, SF1 2-hop {reports[0]['two_hop']} in both (numpy "
          f"{two_hop_sf1}), rows {reports[0]['rows']}; {time.perf_counter() - t0:.1f} s")
    return reports[0]["backend"]


# ---------------------------------------------------------------------------
# phase 9: the graph sources
# ---------------------------------------------------------------------------

SOURCE_KERNELS = ("expand_rows", "frontier_deg_sum", "segment_agg", "intersect",
                  "join_probe")
# the generator's arrays as two SQL views, mapped by Graph DDL
SOURCE_DDL = """
SET SCHEMA mem.snb
CREATE GRAPH TYPE snbType (
  Person ( id INTEGER, birthday INTEGER, firstname STRING ),
  KNOWS,
  (Person), (Person)-[KNOWS]->(Person)
)
CREATE GRAPH snb OF snbType (
  (Person) FROM persons,
  (Person)-[KNOWS]->(Person)
    FROM knows e
      START NODES (Person) FROM persons p JOIN ON p.id = e.src
      END   NODES (Person) FROM persons p JOIN ON p.id = e.dst
)
"""
# a join keyed on the element ids (under HASHED_ID, 63-bit keys)
Q_ID_JOIN = ("MATCH (a:Person)-[:KNOWS]->(b), (c:Person) WHERE id(b) = id(c) "
             "RETURN count(*) AS n")
Q_MAX_ID = "MATCH (p:Person) RETURN max(id(p)) AS m, min(id(p)) AS lo"


def source_truth(ids1, bday1, s1, d1):
    """The SF1 answers of phase 9 from the generator's arrays: Q11, and
    Q47's min and max ``KNOWS.creationDate`` (``ldbc.temporal_seconds`` of
    the edge index)."""
    import datetime as dt

    import numpy as np

    from tpu_cypher_torch.io import ldbc

    created = ldbc.TEMPORAL_EPOCH + ldbc.temporal_seconds(np.arange(len(s1)),
                                                          ldbc.KNOWS_SPREAD)

    def ldt(x):
        return np.datetime64(x, "us").astype(dt.datetime)

    return {
        "Q11": int(np.bincount(bday1, minlength=18_000)[bday1[d1]].sum()),
        "Q47": [{"lo": ldt(created.min()), "hi": ldt(created.max())}],
    }


class Steps:
    """Phase 9's steps: each one's seconds (host clock, ending in a
    synchronize) and own peak device memory, printed as it ends."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}

    @contextlib.contextmanager
    def step(self, label):
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.seconds[label] = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(f"    {label}: {self.seconds[label]:.3f} s, own peak device memory "
              f"{peak:.3f} GiB")


def run_source_queries(torch, pg, name, cases):
    """Each of ``cases`` (label, query, kernels, plan operator, WCOJ tiers,
    expected rows) cold and five times warm through ``run_query``'s
    device-only checks, each answer equal to the truth; prints the cold
    seconds, the warm median and the query's own peak device memory.
    Returns {label: (cold, warm median)}."""
    out = {}
    for label, q, kernels, plan_op, wcoj_tiers, want in cases:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        rows, secs, launches, _, _ = run_query(torch, pg, q, kernels, plan_op=plan_op,
                                               wcoj_tiers=wcoj_tiers, warm=5)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        check([dict(r) for r in rows] == want, f"{name} {label}: {rows} != {want}")
        out[label] = (secs[0], statistics.median(secs[1:]))
        print(f"    {name} {label} = {dict(rows[0]) if len(rows) == 1 else len(rows)}: "
              f"cold {secs[0]:.3f} s, warm median {out[label][1] * 1e3:.3f} ms "
              f"(s: {[round(x, 6) for x in secs[1:]]}); own peak device memory "
              f"{peak:.3f} GiB; launches {launches}")
    return out


def run_sources_phase(torch, session, card, g1, arrays1, truth, tri1, tri10,
                      sf10=10.0, sf1=1.0):
    """Phase 9: the graph sources on the card, in a temporary directory.
    (a) a newly generated SF10 stored as parquet through the session's
    catalog (``FSGraphSource``, ``store_graph``), loaded back
    (``session.graph``), its arrays equal to the generator's, and Q2, Q3,
    Q6 (WCOJ under ``auto``), Q11 and Q15 on it; (b) SF1 with its temporal
    columns stored as CSV and loaded back, Q2 and Q47; (c) SF1's arrays as
    two ``InMemoryTables`` views mapped by ``SOURCE_DDL``
    (``SqlPropertyGraphDataSource``) under ``HASHED_ID`` (ids up to 2**63:
    one of 2**54 or more required) and ``SERIALIZED_ID``, with Q2, Q6,
    Q11 and the join on ``id(b) = id(c)``; (d) SF1's Neo4j bulk CSV export
    (``Neo4jBulkCSVDataSink``), its row counts and headers. Every answer is
    held to numpy's truth, every launch to the ``kernel`` tier. pandas or
    pyarrow missing: (a), (b) and (d) are reported as not run and (c) runs.
    Returns the phase's launches per kernel (the counts are zeroed at its
    start)."""
    import csv
    import importlib
    import tempfile

    import numpy as np

    from tpu_cypher_torch.backend.cuda.expand_op import _mxu_dense_mode
    from tpu_cypher_torch.backend.cuda.hopper import dispatch
    from tpu_cypher_torch.io import FSGraphSource, Neo4jBulkCSVDataSink
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.io.sql import (
        IdGenerationStrategy,
        InMemoryTables,
        SqlPropertyGraphDataSource,
    )
    from tpu_cypher_torch.relational.session import PropertyGraph

    t9 = time.perf_counter()
    ids1, bday1, src1, dst1, s1, d1 = arrays1
    sub = source_truth(ids1, bday1, s1, d1)
    missing = []
    for module in ("pandas", "pyarrow"):
        try:
            importlib.import_module(module)
        except ImportError as exc:
            missing.append(f"{module} ({exc})")
    steps = Steps(torch)
    # WCOJ hands SF1's triangle count back where the dense tier is live (on
    # the card), and the float32 guard then has it walk, as in phase 4
    q6_sf1_tiers = ("handback",) if _mxu_dense_mode() else ("count",)
    wcoj = ("expand_rows", "intersect")
    mwi = "MultiwayIntersectOp"
    dispatch.reset()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sources_") as tmp:
        if missing:
            print(f"  NOT RUN: (a) parquet, (b) CSV and (d) the Neo4j bulk export need "
                  f"pandas and pyarrow; missing here: {', '.join(missing)}")
        else:
            # (a) parquet at SF10
            print(f"  (a) SF10 through FSGraphSource(parquet) ({card}):")
            with steps.step("(a) generate and ingest SF10"):
                g10 = PropertyGraph(session, generate_snb(sf10, session, seed=SEED))
            arrays10 = graph_arrays(g10)
            session.register_source("fs", FSGraphSource(os.path.join(tmp, "pq"), "parquet"))
            with steps.step("(a) store fs.snb10"):
                session.store_graph("fs.snb10", g10)
            del g10
            torch.cuda.empty_cache()
            with steps.step("(a) load fs.snb10"):
                loaded = session.graph("fs.snb10")
            check(all(np.array_equal(x, y) for x, y in zip(arrays10, graph_arrays(loaded))),
                  "the loaded SF10 differs from the generated arrays")
            size = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(os.path.join(tmp, "pq")) for f in fs)
            print(f"    stored {size} bytes; the loaded graph's ids, birthdays and KNOWS "
                  f"equal the generator's")
            with steps.step("(a) queries"):
                run_source_queries(torch, loaded, "(a)", [
                    ("Q2", Q2, ("frontier_deg_sum",), "CsrExpandOp", (),
                     [{"c": truth["Q2"]}]),
                    ("Q3", Q3, ("expand_rows", "segment_agg"), "CsrExpandOp", (),
                     [{"lo": truth["Q3"][0], "hi": truth["Q3"][1]}]),
                    ("Q6", Q6, wcoj, mwi, ("count",), [{"triangles": tri10}]),
                    ("Q11", Q11, ("expand_rows", "join_probe"), "JoinOp(inner", (),
                     [{"n": truth["Q11"]}]),
                    ("Q15", Q15, ("expand_rows", "segment_agg"), "CsrExpandOp", (),
                     truth["Q15"]),
                ])
            del loaded
            session.deregister_source("fs")
            torch.cuda.empty_cache()

            # (b) CSV at SF1 with its temporal columns
            print("  (b) SF1 with temporal columns through FSGraphSource(csv):")
            with steps.step("(b) generate and ingest temporal SF1"):
                gt = PropertyGraph(session, generate_snb(sf1, session, seed=SEED,
                                                         temporal=True))
            session.register_source("csv", FSGraphSource(os.path.join(tmp, "csv"), "csv"))
            with steps.step("(b) store csv.snb1t"):
                session.store_graph("csv.snb1t", gt)
            del gt
            with steps.step("(b) load csv.snb1t"):
                loaded = session.graph("csv.snb1t")
            with steps.step("(b) queries"):
                run_source_queries(torch, loaded, "(b)", [
                    ("Q2", Q2, ("frontier_deg_sum",), "CsrExpandOp", (),
                     [{"c": len(src1)}]),
                    ("Q47", Q47, ("expand_rows", "segment_agg"), "CsrExpandOp", (),
                     sub["Q47"]),
                ])
            del loaded
            session.deregister_source("csv")

        # (c) Graph DDL over SQL views at SF1
        print("  (c) SF1's arrays as SQL views through Graph DDL:")
        tables = {
            "snb.persons": {"id": ids1.tolist(), "birthday": bday1.tolist(),
                            "firstname": [f"p{i}" for i in range(len(ids1))]},
            "snb.knows": {"src": src1.tolist(), "dst": dst1.tolist()},
        }
        for strategy in IdGenerationStrategy:
            ns = f"sql_{strategy.value}"
            session.register_source(ns, SqlPropertyGraphDataSource(
                SOURCE_DDL, {"mem": InMemoryTables(tables)}, id_strategy=strategy))
            with steps.step(f"(c) load {ns}.snb"):
                sg = session.graph(f"{ns}.snb")
            m = sg.cypher(Q_MAX_ID).records.collect()[0]
            print(f"    {strategy.name}: node ids from {m['lo']} to {m['m']} "
                  f"(2**54 = {1 << 54})")
            if strategy is IdGenerationStrategy.HASHED_ID:
                check(m["m"] >= 1 << 54, f"HASHED_ID gave no id of 2**54 or more: {m}")
            with steps.step(f"(c) {strategy.name} queries"):
                run_source_queries(torch, sg, f"(c) {strategy.name}", [
                    ("Q2", Q2, ("frontier_deg_sum",), "CsrExpandOp", (),
                     [{"c": len(src1)}]),
                    ("Q6", Q6, wcoj, mwi, q6_sf1_tiers, [{"triangles": tri1}]),
                    ("Q11", Q11, ("expand_rows", "join_probe"), "JoinOp(inner", (),
                     [{"n": sub["Q11"]}]),
                    ("id join", Q_ID_JOIN, ("expand_rows", "join_probe"), "JoinOp(inner",
                     (), [{"n": len(src1)}]),
                ])
            del sg
            session.deregister_source(ns)

        # (d) the Neo4j bulk CSV export of SF1
        if not missing:
            print("  (d) SF1's Neo4j bulk CSV export:")
            root = os.path.join(tmp, "neo4j")
            with steps.step("(d) export"):
                Neo4jBulkCSVDataSink(root).store("snb1", g1._graph)
            counts = {}
            for part, want, heads in (("nodes/Person", len(ids1), ("id:ID",)),
                                      ("relationships/KNOWS", len(src1),
                                       (":START_ID", ":END_ID"))):
                d = os.path.join(root, "snb1", part)
                with open(os.path.join(d, "schema.csv"), newline="") as f:
                    head = next(csv.reader(f))
                with open(os.path.join(d, "part_0.csv"), newline="") as f:
                    n = sum(1 for _ in csv.reader(f))
                check(n == want and all(h in head for h in heads),
                      f"(d) {part}: {n} rows (want {want}), header {head}")
                counts[part] = (n, head)
            check(os.access(os.path.join(root, "snb1", "import.sh"), os.X_OK),
                  "(d) import.sh is missing or not executable")
            print(f"    rows and headers: {counts}")

    launches = dispatch.use_counts()
    for name in SOURCE_KERNELS:
        c = launches[name]
        check(c["kernel"] > 0 and c["plain"] == 0 and c["fallback"] == 0,
              f"phase 9: {name} launches {c}")
    total = time.perf_counter() - t9
    print(f"  phase 9 launches (kernel tier): "
          f"{ {n: launches[n]['kernel'] for n in SOURCE_KERNELS} }; "
          f"{'(a), (b) and (d) not run; ' if missing else ''}steps (s): "
          f"{ {k: round(v, 3) for k, v in steps.seconds.items()} }; total {total:.1f} s")
    return {n: launches[n]["kernel"] for n in SOURCE_KERNELS}


# ---------------------------------------------------------------------------
# phase 10: the static analyzer against the card
# ---------------------------------------------------------------------------

ANALYZER_RULES = 12
ANALYZER_BASELINE = "tpu_cypher_torch/analysis/baseline.json"


def run_analyzer_phase(torch, card, graphs, phase_launches):
    """Phase 10: (a) ``python -m tpu_cypher_torch.analysis --format json
    --facts-out F`` over the checkout's ``tpu_cypher_torch/`` must exit 0
    and report clean with twelve rules and an empty baseline, and write the
    shape facts phase 11 reads; (b) the kernel names and impls
    that ``obs-emission`` collects from the sources must equal
    ``dispatch.registry()``, and each of the five kernels must have
    launched on the ``kernel`` tier in phases 4 and 9 (``phase_launches``);
    (c) ``SYNC_QUERIES`` warm on the phase-4 graphs under torch's sync
    debug mode: per query the syncs and their sites by analyzer status,
    failing when a site whose line holds a sync kind of the taint model
    escaped it (``missed``). Returns (the facts, the CLI's seconds)."""
    import tempfile

    from tpu_cypher_torch.analysis import runner
    from tpu_cypher_torch.analysis import synctrace as ST
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    t10 = time.perf_counter()
    # (a) the CLI, as a user runs it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        facts_out = os.path.join(tmp, "facts.json")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_cypher_torch.analysis", "--format", "json",
             "--facts-out", facts_out, "tpu_cypher_torch"],
            cwd=HERE, capture_output=True, text=True, timeout=300,
        )
        cli_s = time.perf_counter() - t0
        facts = None
        if os.path.exists(facts_out):
            with open(facts_out) as f:
                facts = json.load(f)
    check(proc.returncode == 0,
          f"the analyzer exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    with open(os.path.join(HERE, ANALYZER_BASELINE)) as f:
        committed = json.load(f)["findings"]
    check(got["clean"] and not got["findings"] and not got["baselined"]
          and not committed and got["rules_run"] == ANALYZER_RULES,
          f"the analyzer is not clean with {ANALYZER_RULES} rules and an empty "
          f"baseline: {got['rules_run']} rules, {len(got['findings'])} findings, "
          f"{len(got['baselined'])} baselined, {len(committed)} committed")
    by_rule = {}
    for f in got["suppressed"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    print(f"  analyzer CLI: {got['files_checked']} files checked, {got['rules_run']} "
          f"rules, {len(got['findings'])} findings, {len(got['baselined'])} baselined, "
          f"suppressions by rule {dict(sorted(by_rule.items()))}, {cli_s:.2f} s")
    check(facts is not None and facts["schema_version"] == 1,
          "the analyzer wrote no shape facts")

    # (b) the static registry against the runtime one
    t0 = time.perf_counter()
    report = runner.check_engine()
    smap = ST.SyncMap(report, runner.ENGINE_ROOT)
    static = dict(report.project.dispatch_kernels)
    runtime = {n: spec.impls for n, spec in dispatch.registry().items()}
    check(static == runtime and len(runtime) == 5,
          f"obs-emission's kernels {static} differ from dispatch.registry() {runtime}")
    for name in runtime:
        check(phase_launches.get(name, 0) > 0,
              f"{name} launched on no kernel tier in phases 4 and 9")
    print(f"  registry: the {len(static)} kernels obs-emission collects equal "
          f"dispatch.registry(), impls {static}; kernel-tier launches in phases 4 and 9 "
          f"{phase_launches}; in-process analysis {time.perf_counter() - t0:.2f} s, "
          f"{len(smap.static)} sync sites in its inventory")

    # (c) the card's own sync trace
    torch.cuda.synchronize()
    out, escaped = ST.trace_queries(torch, smap, graphs, SYNC_QUERIES, ST.cuda_sync_trace)
    check(not escaped, f"syncs the taint model missed: {escaped}")
    print(f"phase 10 done in {time.perf_counter() - t10:.1f} s ({card})")
    return facts, cli_s


# ---------------------------------------------------------------------------
# phase 11: the bucket lattice on the card
# ---------------------------------------------------------------------------

LATTICE_MODES = ("pow2", "1.25")
# the kernels a lattice run must launch in both modes; frontier_deg_sum
# answers a count with no materialize, so the lattice never reaches it
LATTICE_KERNELS = ("expand_rows", "segment_agg", "intersect", "join_probe")
LATTICE_MIN_PAIRS = 20
Q20_LATTICE_ROWS = 100_000  # phase 11's Q20 window returns about this many rows
# (file, function, op) of each site where the lattice rounds; the facts
# must classify every one BUCKETED
LATTICE_ROUNDING = (
    ("expand_op.py", "_fused_chain_walk", "round_size"),
    ("expand_op.py", "_apply_enforced_pairs", "_mask_to_idx_bucketed"),
    ("expand_op.py", "_expand_half", "round_size"),
    ("expand_op.py", "_expand_half", "_mask_to_idx_bucketed"),
    ("expand_op.py", "_fused_table", "round_size"),
    ("column.py", "mask_to_idx_bucketed", "mask_nonzero"),
)


@contextlib.contextmanager
def bucket_env(mode):
    """``TPU_CYPHER_BUCKET`` set in the process for a block
    (``bucketing.mode()`` reads it at each call); the old value comes back
    in a ``finally``."""
    old = os.environ.get("TPU_CYPHER_BUCKET")
    os.environ["TPU_CYPHER_BUCKET"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TPU_CYPHER_BUCKET", None)
        else:
            os.environ["TPU_CYPHER_BUCKET"] = old


def lattice_sites(facts, root):
    """{(file, function, op leaf): [site shapes]} of the facts' sites in
    the lattice's two files, each site's function read from the source."""
    import ast

    out = {}
    trees = {}
    for site in facts["sites"]:
        base = os.path.basename(site["path"])
        if base not in ("expand_op.py", "column.py"):
            continue
        if site["path"] not in trees:
            with open(os.path.join(root, site["path"])) as f:
                tree = ast.parse(f.read())
            fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
            trees[site["path"]] = fns
        inner = [fn for fn in trees[site["path"]]
                 if fn.lineno <= site["line"] <= fn.end_lineno]
        name = min(inner, key=lambda fn: fn.end_lineno - fn.lineno).name if inner else ""
        out.setdefault((base, name, site["op"].split(".")[-1]), []).extend(
            a["shape"] for a in site["args"])
    return out


def run_lattice_phase(torch, card, graphs, truth, facts, cli_s):
    """Phase 11: (a) the shape facts phase 10's CLI wrote: their summary,
    the lattice's rounding sites BUCKETED, and the sites a lattice-free
    port would change; (b) phase 11's queries under ``off``, ``pow2`` and
    ``1.25``, each cold and five times warm: every answer equal to the
    ``off`` run's and to the numpy truth, every (true, padded) pair on the
    trace spans equal to ``analysis.shapes.predict_padded`` (at least
    ``LATTICE_MIN_PAIRS`` in each mode), every launch on the ``kernel``
    tier, with launches per (kernel, tier), the distinct padded extents
    per operator span, the warm median and the own peak device memory
    against ``off``. Returns {kernel: {mode: kernel-tier launches}}."""
    from collections import Counter

    import numpy as np

    from tpu_cypher_torch.analysis.shapes import predict_padded
    from tpu_cypher_torch.backend.cuda import bucketing
    from tpu_cypher_torch.backend.cuda.hopper import dispatch

    t11 = time.perf_counter()
    # (a) the facts of the CLI run, as a user runs it
    summary = facts["summary"]
    print(f"  shape facts (the CLI's --facts-out, {cli_s:.2f} s with the lint): "
          f"bucketed_sites {summary['bucketed_sites']}, data_dependent_sites "
          f"{summary['data_dependent_sites']}, facts_emitted {summary['facts_emitted']}; "
          f"lattice bounds {facts['lattice']['bounds']}")
    sites = lattice_sites(facts, HERE)
    for where in LATTICE_ROUNDING:
        got = sites.get(where)
        check(got and all(x.startswith("bucketed") for x in got),
              f"the facts do not classify {where} BUCKETED: {got}")
    acts = [f"{s['path'].replace('tpu_cypher_torch/', '')}:{s['line']} {s['op']}"
            for s in facts["sites"]
            if any(a["shape"].startswith("bucketed") for a in s["args"])]
    print(f"  the {len(acts)} sites the lattice acts at (what a lattice-free port "
          f"changes): {acts}")

    # (b) the queries; Q20 over a window of about Q20_LATTICE_ROWS rows
    # (phase 4's returns 1M rows, whose decode would be most of the phase)
    g1, g10, gl = graphs["small"], graphs["big"], graphs["loopy"]
    walks, closes = truth["walks"], truth["closes"]
    ids1, s1, d1 = truth["sf1_arrays"]
    n1, start1 = len(ids1), len(ids1) // 2
    w = walk_window(sum(walk_estimates(s1, d1, n1, 2)), Q20_LATTICE_ROWS, start1)
    _, keys = brute_walks(directed_steps(s1, d1), n1, np.arange(start1, start1 + w), 2,
                          pairs=True)
    keys = np.concatenate(keys)
    q20 = (window_params(ids1, start1, w),
           np.sort(ids1[keys // n1] * (1 << 32) + ids1[keys % n1]))

    def pair_bag(rows, ka, kb):
        return np.sort(np.array([r[ka] * (1 << 32) + r[kb] for r in rows], np.int64))

    queries = (
        ("Q1 (SF1)", g1, Q1, None, ("expand_rows",), "CsrExpandOp",
         lambda rows: np.array_equal(pair_bag(rows, "a", "b"), truth["Q1_pairs"])),
        ("Q5 (SF1)", g1, Q5, None, ("expand_rows", "segment_agg"), "CsrExpandOp",
         lambda rows: (rows[0]["lo"], rows[0]["hi"]) == truth["Q5"]),
        ("Q11 (SF1)", g1, Q11, None, ("expand_rows", "join_probe"), "JoinOp(inner",
         lambda rows: rows == [{"n": truth["Q11_sf1"]}]),
        ("Q24 (SF1)", g1, Q24, None, ("expand_rows", "intersect"), "CsrExpandIntoOp",
         lambda rows: {r["a"]: r["n"] for r in rows} == closes["Q24"]
         and len(rows) == len(closes["Q24"])),
        (f"Q20 (SF1, {w} sources)", g1, Q20, q20[0], ("expand_rows",), "CsrVarExpandOp",
         lambda rows: np.array_equal(pair_bag(rows, "a", "b"), q20[1])),
        ("loopy 2-hop count", gl, Q4, None, ("expand_rows",), "CsrExpandOp",
         lambda rows: rows == [{"c": walks["loopy_chain"]}]),
        ("loopy 2-hop DISTINCT", gl, Q13, None, ("expand_rows",), "DistinctOp",
         lambda rows: rows == [{"pairs": walks["loopy_distinct"]}]),
        ("loopy fixed rel vs *1..2", gl, LOOPY_FORBID, walks["loopy_forbid"][0],
         ("expand_rows",), "CsrVarExpandOp",
         lambda rows: rows == [{"n": walks["loopy_forbid"][1]}]),
        ("Q17 (SF10)", g10, Q17, None, ("expand_rows",), "DistinctOp",
         lambda rows: rows == [{"pairs": walks["Q17"]}]),
    )
    lattice_launches = {k: {m: 0 for m in LATTICE_MODES} for k in dispatch.registry()}
    npairs = dict.fromkeys(LATTICE_MODES, 0)
    for label, pg, q, params, kernels, plan_op, ok in queries:
        off = None
        for mode in ("off",) + LATTICE_MODES:
            with bucket_env(mode):
                check(bucketing.mode() == mode, f"TPU_CYPHER_BUCKET={mode} not read")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                before = dispatch.use_counts()
                rows, secs, launches, _, results = run_query(
                    torch, pg, q, kernels, plan_op=plan_op, params=params, warm=5)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                after = dispatch.use_counts()
            rows = [dict(r) for r in rows]
            check(ok(rows), f"{label} under {mode}: the answer differs from numpy")
            bag = Counter(repr(sorted(r.items())) for r in rows)
            tiers = {k: {t: after[k][t] - before[k][t] for t in after[k]
                         if after[k][t] > before[k][t]}
                     for k in after if after[k] != before[k]}
            extents, pairs, last = {}, 0, []
            for res in results:
                for span in res.profile().trace.spans():
                    for true_rows, padded in span.attrs.get("rows_pairs", []):
                        check(predict_padded(true_rows, mode) == padded,
                              f"{label} under {mode}: span {span.name} padded {true_rows} "
                              f"to {padded}, predicted {predict_padded(true_rows, mode)}")
                        extents.setdefault(span.name, set()).add(padded)
                        pairs += 1
                        if res is results[-1]:
                            last.append((true_rows, padded))
            warm = statistics.median(secs[1:])
            if mode == "off":
                off = (bag, warm, peak)
                versus = ""
            else:
                check(bag == off[0], f"{label} under {mode}: the answer differs from off's")
                npairs[mode] += pairs
                for k, n in launches.items():
                    lattice_launches[k][mode] += n
                versus = (f" ({warm / off[1]:.3f}x off's warm median, {peak - off[2]:+.3f} "
                          f"GiB against off's own peak)")
            print(f"  {label} [{mode}]: warm median {warm * 1e3:.3f} ms, cold "
                  f"{secs[0] * 1e3:.3f} ms, own peak device memory {peak:.3f} GiB{versus}; "
                  f"launches per (kernel, tier) over the 6 runs {tiers}; {pairs} (true, "
                  f"padded) pairs, the last run's {last}; distinct padded extents per span "
                  f"{ {k: sorted(v) for k, v in sorted(extents.items())} }")
    for mode in LATTICE_MODES:
        check(npairs[mode] >= LATTICE_MIN_PAIRS,
              f"only {npairs[mode]} (true, padded) pairs under {mode}")
    for name in LATTICE_KERNELS:
        check(all(lattice_launches[name][m] > 0 for m in LATTICE_MODES),
              f"{name} launched on no kernel tier under the lattice: "
              f"{lattice_launches[name]}")
    print(f"  pairs checked against predict_padded {npairs}; kernel-tier launches under "
          f"the lattice {lattice_launches}")
    print(f"phase 11 done in {time.perf_counter() - t11:.1f} s ({card})")
    return lattice_launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import tpu_cypher_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a tpu-cypher checkout ({exc})",
              file=sys.stderr)
        return 2
    import numpy as np

    from tpu_cypher_torch import CypherSession, interop
    from tpu_cypher_torch.api.types import CTInteger
    from tpu_cypher_torch.backend.cuda.hopper import _build, dispatch
    from tpu_cypher_torch.io.ldbc import generate_snb
    from tpu_cypher_torch.relational.session import PropertyGraph

    t_start = time.perf_counter()
    # 1. card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel sources in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.nvcc_path()})")
    for name in sorted(built):
        log = _build.build_log(name) or ""
        usage = [l.strip() for l in log.splitlines() if "registers" in l]
        print(f"  {name}: {built[name]:.2f} s; " + (" | ".join(usage) or "(cached)"))

    from tpu_cypher_torch import native

    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          f"the native host tier did not build: {native.build_error()}")
    print(f"native: {os.path.relpath(native.lib_path(), HERE)} built with g++ "
          f"{' '.join(native.CXX_FLAGS)} in {time.perf_counter() - t0:.2f} s")

    session = CypherSession.cuda()
    print(f"backend device: {backend_device()}")

    def graphs():
        t0 = time.perf_counter()
        a = PropertyGraph(session, generate_snb(1.0, session, seed=SEED))
        b = PropertyGraph(session, generate_snb(10.0, session, seed=SEED))
        torch.cuda.synchronize()
        print(f"graphs: SF1 and SF10 generated and ingested in "
              f"{time.perf_counter() - t0:.2f} s")
        return a, b

    g1, g10 = graphs()

    ids1, bday1, src1, dst1 = graph_arrays(g1)
    ids10, bday10, src10, dst10 = graph_arrays(g10)

    def idx(ids, x):
        return np.searchsorted(ids, x)  # ids are generated sorted

    s1, d1 = idx(ids1, src1), idx(ids1, dst1)
    s10, d10 = idx(ids10, src10), idx(ids10, dst10)
    out1 = np.bincount(s1, minlength=len(ids1))
    in1 = np.bincount(d1, minlength=len(ids1))
    out10 = np.bincount(s10, minlength=len(ids10))
    truth = {
        "Q1_pairs": np.sort(src1 * (1 << 32) + dst1),
        "Q2": int(len(src10)),
        "Q3": (int(bday10[d10].min()), int(bday10[s10].max())),
        "Q4": int(out10[d10].sum()),
        "Q5_rows": int(out1[d1].sum()),
        "Q5": (int(bday1[d1[in1[s1] > 0]].min()), int(bday1[d1[in1[s1] > 0]].max())),
    }
    # Q9-Q12 at SF10
    truth["Q9"] = int((bday10[s10] < bday10[d10]).sum())
    me = int(idx(ids10, Q10_PERSON))
    check(ids10[me] == Q10_PERSON, f"person {Q10_PERSON} is not in the SF10 graph")
    friends = np.concatenate([d10[s10 == me], s10[d10 == me]])
    truth["Q10"] = sorted((int(ids10[f]), f"p{f}") for f in friends)
    truth["Q11"] = int(np.bincount(bday10, minlength=18_000)[bday10[d10]].sum())
    young = bday10 < 1000
    hit = young[s10] & (bday10[d10] > 9000)
    n10 = len(ids10)
    unmatched = np.flatnonzero(young & (np.bincount(s10[hit], minlength=n10) == 0))
    truth["Q12"] = np.sort(np.concatenate([
        s10[hit].astype(np.int64) * (n10 + 1) + d10[hit] + 1,
        unmatched.astype(np.int64) * (n10 + 1),
    ]))
    truth["Q12_left"] = int(young.sum())
    truth["Q12_matched"] = int(hit.sum())
    truth.update(shaping_truth(ids1, s1, d1, ids10, bday10, s10, d10))
    temporal = temporal_truth(ids10, bday10, s10, d10, truth["Q11"])
    print(f"truth: SF1 {len(ids1)} persons / {len(src1)} KNOWS; SF10 "
          f"{len(ids10)} persons / {len(src10)} KNOWS; Q4 2-hop paths "
          f"{truth['Q4']}; Q5 second-hop rows {truth['Q5_rows']}; Q9 "
          f"{truth['Q9']}; Q10 {len(truth['Q10'])} friends of {Q10_PERSON}; "
          f"Q11 {truth['Q11']} pairs; Q12 {truth['Q12_left']} left rows, "
          f"{truth['Q12_matched']} matched, {len(unmatched)} padded; Q13 "
          f"{truth['Q13']} distinct (a, c) of {truth['Q13_rows']} 2-hop rows; Q15 "
          f"k={len(truth['Q15'])} groups over {truth['Q15_rows']} rows; Q16 "
          f"{truth['Q16_distinct']} distinct birthdays")
    t0 = time.perf_counter()
    tri10 = triangle_truth(ids10, src10, dst10, rows_and_cliques=False)
    tri1 = triangle_truth(ids1, src1, dst1, rows_and_cliques=True)
    idsl, srcl, dstl = loopy_arrays()
    loopy_truth = loopy_triangles(srcl, dstl)
    print(f"truth: SF10 {tri10['triangles']} triangles, sum of min(out(b), "
          f"in(a)) {tri10['min_lanes']}; SF1 {tri1['triangles']} triangles, "
          f"{tri1['cliques']} 4-cliques; loopy {loopy_truth} triangles "
          f"(scipy and brute force, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    walks = walk_truth(ids1, s1, d1, ids10, s10, d10, idsl, srcl, dstl)
    print(f"truth: Q17 {walks['Q17']} distinct (a, c) at SF10; Q18 {walks['Q18'][1]} "
          f"walks from {walks['Q18'][2]} sources; Q19 {walks['Q19'][1]} walks from "
          f"{walks['Q19'][2]} sources; Q20 {len(walks['Q20'][1])} rows from "
          f"{walks['Q20'][2]} sources; Q21 {walks['Q21'][1]} undirected and "
          f"{walks['Q21'][2]} *0..2 walks; loopy {walks['loopy_chain']} 2-hop, "
          f"{walks['loopy_distinct']} distinct, {walks['loopy_forbid'][1]} forbid rows "
          f"(scipy, rules and brute force, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    closes = close_truth(ids1, tri1, ids10, s10, d10, tri10, idsl, srcl, dstl)
    half = closes["Q26_half"]

    def half_graph():  # Q26's graph: SF10's persons, KNOWS into even indices
        return interop.graph_from_arrays(session, ids10, {}, {"id": CTInteger.nullable},
                                         src10[half], dst10[half])

    print(f"truth: Q22 {closes['Q22']} closed 2-paths at SF10; Q24 {closes['Q24_rows']} "
          f"in {len(closes['Q24'])} groups at SF1; Q25 {closes['Q25']}; Q26 "
          f"{len(closes['Q26'])} rows of {int(half.sum())} KNOWS, {closes['Q26_lone']} "
          f"persons with no in-edge; loopy {closes['loopy_2cycle']} 2-cycles, "
          f"{closes['loopy_undirected']} undirected closes (scipy and brute force, "
          f"{time.perf_counter() - t0:.1f} s)")

    # 3. kernels against their plain versions
    report = {}
    print("kernels vs plain (exact):")
    check_expand_rows(torch, session, g1, g10, tri10["triangles"], report)
    check_expand_rows_walks(torch, g10, walks["Q17"], walks["Q18"][0], walks["Q18"][1],
                            report)
    check_frontier(torch, session, g10, report)
    check_segment_agg(torch, g1, truth["Q5"], truth["Q5_rows"], report)
    check_segment_agg_q15(torch, g10, truth["Q15"], report)
    check_segment_agg_q47(torch, session, card, temporal["Q47"], report)
    check_intersect(torch, g10, tri10["triangles"], report)
    check_join_probe(torch, g10, truth["Q11"], report)
    lists = list_truth(ids10, bday10, s10, d10, walks["Q33"])
    lists["Q54 rows params"] = undirected_window(ids1, s1, d1, Q54_ROWS_WALKS)
    check_explode(torch, g10, lists["Q31"][0], report)
    check_two_streams(torch, session, g10)
    time_materializes(torch, g1, g10, truth["Q11"], tri1["triangles"])
    check_close_shapes(torch, g1, g10, half_graph(), closes, report)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # 4. the slice, on graphs phase 3 has not touched (no CSR built yet)
    print("slice through CypherSession.cuda():")
    arrays3 = (graph_arrays(g1), graph_arrays(g10))
    del g1, g10
    torch.cuda.empty_cache()
    g1, g10 = graphs()
    gl = interop.graph_from_arrays(
        session, idsl, {}, {"id": CTInteger.nullable}, srcl, dstl
    )
    check(all(np.array_equal(x, y)
              for old, new in zip(arrays3, (graph_arrays(g1), graph_arrays(g10)))
              for x, y in zip(old, new)),
          "the generator gave other arrays from the same seed")
    dispatch.reset()
    slice_launches = {}
    cold = {}

    last = {}

    def run(label, pg, q, kernels, **kw):
        rows, secs, launches, lanes, results = run_query(torch, pg, q, kernels, **kw)
        first = results[0]
        last[label] = results[-1]
        for k, v in launches.items():
            slice_launches[k] = slice_launches.get(k, 0) + v
        phases = {k: round(v, 4) for k, v in first.profile().phase_seconds().items()}
        cold[label] = first
        print(f"  {label}: cold {secs[0]:.3f} s, warm {secs[1]:.3f} s; kernel "
              f"launches {launches}; materialized lanes per run {lanes}")
        print(f"    cold run's trace phases (s): {phases}")
        return rows, secs, lanes

    rows, _, _ = run("Q1 (SF1)", g1, Q1, ("expand_rows",))
    got = np.sort(np.array([r["a"] * (1 << 32) + r["b"] for r in rows], np.int64))
    check(np.array_equal(got, truth["Q1_pairs"]), "Q1 pair bag differs from numpy")
    print(f"    Q1 = {len(rows)} (a, b) pairs, bag-identical to numpy")
    rows, _, _ = run("Q2 (SF10)", g10, Q2, ("frontier_deg_sum",))
    check([dict(r) for r in rows] == [{"c": truth["Q2"]}], f"Q2 {rows} != {truth['Q2']}")
    print(f"    Q2 = {rows[0]['c']}")
    rows, _, _ = run("Q3 (SF10)", g10, Q3, ("expand_rows", "segment_agg"))
    check((rows[0]["lo"], rows[0]["hi"]) == truth["Q3"], f"Q3 {rows} != {truth['Q3']}")
    print(f"    Q3 = {rows[0]}")
    rows, secs, _ = run("Q4 (SF10)", g10, Q4, ())
    check([dict(r) for r in rows] == [{"c": truth["Q4"]}], f"Q4 {rows} != {truth['Q4']}")
    expansions = len(src10) + truth["Q4"]
    print(f"    Q4 = {rows[0]['c']}; {expansions} edge expansions, "
          f"{expansions / secs[1]:.1f} expansions/s warm "
          f"({expansions / secs[0]:.1f} cold)")
    rows, _, lanes = run("Q5 (SF1)", g1, Q5, ("expand_rows", "segment_agg"))
    check((rows[0]["lo"], rows[0]["hi"]) == truth["Q5"], f"Q5 {rows} != {truth['Q5']}")
    check(lanes == len(src1) + truth["Q5_rows"],
          f"Q5 materialized {lanes} lanes, expected {len(src1) + truth['Q5_rows']}")
    print(f"    Q5 = {rows[0]} over {truth['Q5_rows']} second-hop rows")
    print("  Q4's cold run, its trace tree (wall ms per span):")
    for line in cold["Q4 (SF10)"].profile().render().splitlines():
        print(f"    {line}")

    # the WCOJ triangle path: count tier at SF10, materialize tier at SF1,
    # both inside the 4-clique, and in-op uniqueness on a loopy graph
    wcoj = ("expand_rows", "intersect")
    mwi = "MultiwayIntersectOp"
    torch.cuda.reset_peak_memory_stats()
    rows, secs, lanes = run("Q6 (SF10)", g10, Q6, wcoj, plan_op=mwi,
                            wcoj_tiers=("count",))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    Q6 peak device memory {peak:.2f} GiB")
    check([dict(r) for r in rows] == [{"triangles": tri10["triangles"]}],
          f"Q6 {rows} != {tri10['triangles']}")
    check(lanes == len(src10) + tri10["min_lanes"],
          f"Q6 expanded {lanes} lanes, expected {len(src10)} + {tri10['min_lanes']}")
    print(f"    Q6 = {rows[0]['triangles']}; expanded lanes {len(src10)} + "
          f"{tri10['min_lanes']} = {lanes} (the binary plan's 2-hop: "
          f"{truth['Q4']}); {lanes / secs[1]:.1f} lanes/s warm")
    rows, _, lanes = run("Q7 (SF1)", g1, Q7, wcoj, plan_op=mwi,
                         wcoj_tiers=("materialize",))
    n1 = len(ids1)
    got = np.sort(np.array(
        [(idx(ids1, r["a"]) * n1 + idx(ids1, r["b"])) * n1 + idx(ids1, r["c"])
         for r in rows], np.int64))
    check(np.array_equal(got, tri1["rows"]), "Q7 triangle row bag differs from scipy")
    want_lanes = len(src1) + tri1["pivot_lanes"] + tri1["triangles"]
    check(lanes == want_lanes, f"Q7 materialized {lanes} lanes, expected {want_lanes}")
    print(f"    Q7 = {len(rows)} triangle rows, bag-identical to scipy "
          f"(parallel-edge multiplicity included); pivot lanes {tri1['pivot_lanes']}")
    rows, _, lanes = run("Q8 (SF1)", g1, Q8, wcoj, plan_op=mwi,
                         wcoj_tiers=("materialize", "count"))
    check([dict(r) for r in rows] == [{"cliques": tri1["cliques"]}],
          f"Q8 {rows} != {tri1['cliques']}")
    want_lanes = want_lanes + tri1["clique_min_lanes"]
    check(lanes == want_lanes, f"Q8 expanded {lanes} lanes, expected {want_lanes}")
    print(f"    Q8 = {rows[0]['cliques']}; the count tier expanded "
          f"{tri1['clique_min_lanes']} lanes over {tri1['triangles']} triangle rows")
    with wcoj_mode("force"):  # the operator's own pair enforcement
        rows, _, _ = run("loopy triangles", gl, Q6, wcoj, plan_op=mwi,
                         wcoj_tiers=("materialize",))
    check([dict(r) for r in rows] == [{"triangles": loopy_truth}],
          f"loopy {rows} != brute force {loopy_truth}")
    check("uniq" in cold["loopy triangles"].plans, "loopy plan enforces no pair")
    print(f"    loopy = {loopy_truth} triangles with distinct relationships "
          f"({len(srcl)} KNOWS with self-loops and parallel edges), "
          f"bag-identical to the brute-force count")
    print("  Q6's cold run, its trace tree (wall ms per span):")
    for line in cold["Q6 (SF10)"].profile().render().splitlines():
        print(f"    {line}")

    # the classic filter and equi-join path at SF10
    rows, _, _ = run("Q9 (SF10)", g10, Q9, ("expand_rows",), plan_op="FilterOp")
    check([dict(r) for r in rows] == [{"n": truth["Q9"]}], f"Q9 {rows} != {truth['Q9']}")
    print(f"    Q9 = {rows[0]['n']} of {len(src10)} KNOWS kept")
    rows, _, _ = run("Q10 (SF10)", g10, Q10, ("expand_rows",), plan_op="OrderByOp",
                     params={"personId": Q10_PERSON})
    got = [(r["friendId"], r["firstName"]) for r in rows]
    check(got == truth["Q10"], f"Q10 rows differ from numpy: {got[:5]} ...")
    print(f"    Q10 = {len(rows)} friends of person {Q10_PERSON}, in friendId order, "
          f"equal to numpy row for row")
    join_kernels = ("expand_rows", "join_probe")
    rows, _, _ = run("Q11 (SF10)", g10, Q11, join_kernels, plan_op="JoinOp(inner")
    check([dict(r) for r in rows] == [{"n": truth["Q11"]}], f"Q11 {rows} != {truth['Q11']}")
    print(f"    Q11 = {rows[0]['n']} (b, c) pairs")

    def q12_ok(rows):
        got = np.sort(np.array(
            [idx(ids10, r["a"]) * (n10 + 1) + (idx(ids10, r["b"]) + 1 if r["b"] is not None else 0)
             for r in rows], np.int64))
        return np.array_equal(got, truth["Q12"])

    rows, _, _ = run("Q12 (SF10)", g10, Q12, join_kernels, plan_op="JoinOp(left_outer")
    check(q12_ok(rows), "Q12 row bag differs from numpy")
    print(f"    Q12 = {len(rows)} rows: {truth['Q12_matched']} matched, "
          f"{len(rows) - truth['Q12_matched']} null-padded, bag-identical to numpy")
    print("  Q11's cold run, its trace tree (wall ms per span):")
    for line in cold["Q11 (SF10)"].profile().render().splitlines():
        print(f"    {line}")

    # row shaping and grouping
    run_shaping_queries(torch, run, slice_launches, g1, g10, truth)
    # the dense count tier at SF1, the standalone kernel API and the edge
    # list at SF10
    print("  the dense count tier:")
    run_dense_queries(torch, run, last, g1, truth["Q13"], tri1["triangles"])
    run_kernel_api(torch, slice_launches, ids10, src10, dst10, s10, d10, truth["Q4"],
                   walks["Q17"], tri10["triangles"])
    run_edge_list(torch, run, session, src10, dst10)
    # the chain walk: the 2-hop DISTINCT and the var-length expand
    run_walk_queries(torch, run, cold, slice_launches, g1, g10, gl, walks, report)
    # the closing ExpandInto and the fused OPTIONAL expand
    run_close_queries(torch, run, cold, g1, g10, half_graph(), gl, closes, loopy_truth)
    # the expression compiler and elements as values
    run_expression_queries(torch, run, last, g10, expr_truth(ids10, bday10, s10, d10))
    # lists, maps and elements as values
    run_list_queries(torch, run, last, g1, g10, lists, walks["Q20"][0],
                     set(zip(src1.tolist(), dst1.tolist())))
    # the factorized tier and the optimizer's join order
    g05, cliques, q38 = run_factorized_queries(torch, run, last, slice_launches, session,
                                               g10, ids10, s10, d10)
    gjo, jo_truth = run_join_order_queries(run, cold, session)
    # the temporal kinds at SF10, and examples/05_temporal.py's queries
    run_temporal_queries(torch, run, card, session, temporal)
    counts = dispatch.use_counts()
    for name, c in counts.items():
        check(c["fallback"] == 0 and c["plain"] == 0, f"{name} fallbacks: {c}")
        check(c["kernel"] == slice_launches.get(name, 0) and c["kernel"] > 0,
              f"{name} launch count {c} vs {slice_launches}")
    print(f"slice launches (kernel tier, cold + warm runs): "
          f"{ {n: c['kernel'] for n, c in counts.items()} }")

    # 5. off the main path: Q11 and Q12 warm on the kernel tier against the
    # plain version in the gate's place, and the triangle count on the WCOJ
    # tier against the binary plan (``CsrExpandIntoOp``'s fused close count,
    # which the reference's ``auto`` keeps under TPU_CYPHER_WCOJ_MIN_ROWS)
    # at four graph sizes
    print("measurements off the main path (warm, ABBA-interleaved):")
    tiers = {"kernel tier": (contextlib.nullcontext, "JoinOp", None),
             "plain version": (plain_join_probe, "JoinOp", None)}
    print_times("Q11 (SF10)", warm_times(
        torch, g10, Q11, tiers, lambda rows: rows == [{"n": truth["Q11"]}], rounds=10))
    print_times("Q12 (SF10)", warm_times(torch, g10, Q12, tiers, q12_ok, rounds=4))
    plans = {"WCOJ (force)": (lambda: wcoj_mode("force"), "MultiwayIntersectOp", None),
             "binary plan (off)": (lambda: pinned(WCOJ_MODE="off", MXU_DENSE="0"),
                                   "CsrExpandIntoOp", "MultiwayIntersectOp")}
    ids_s, src_s, dst_s = loopy_arrays(100, 300)
    g01 = PropertyGraph(session, generate_snb(0.1, session, seed=SEED))
    ids01, _, src01, dst01 = graph_arrays(g01)
    for name, pg, ids, src, dst, want in (
        ("loopy 100 nodes", interop.graph_from_arrays(
            session, ids_s, {}, {"id": CTInteger.nullable}, src_s, dst_s),
         ids_s, src_s, dst_s, loopy_triangles(src_s, dst_s)),
        ("loopy 300 nodes", gl, idsl, srcl, dstl, loopy_truth),
        ("SNB SF0.1", g01, ids01, src01, dst01,
         triangle_truth(ids01, src01, dst01, rows_and_cliques=False)["triangles"]),
        ("SNB SF10", g10, ids10, src10, dst10, tri10["triangles"]),
    ):
        s_i, d_i = idx(ids, src), idx(ids, dst)
        out_max = int(np.bincount(s_i, minlength=len(ids)).max())
        in_max = int(np.bincount(d_i, minlength=len(ids)).max())
        print(f"  triangle count on {name}: {len(src)} KNOWS, max out-degree "
              f"{out_max}, max in-degree {in_max}, {want} triangles")
        print_times(name, warm_times(
            torch, pg, Q6, plans, lambda rows: rows == [{"triangles": want}]))
        if name in ("loopy 100 nodes", "SNB SF10"):
            # auto routes as the reference does: the binary plan under
            # TPU_CYPHER_WCOJ_MIN_ROWS, WCOJ above it
            plan = "CsrExpandIntoOp" if name == "loopy 100 nodes" else "MultiwayIntersectOp"
            if name == "loopy 100 nodes":
                inject_outlier(pg)
            res = pg.cypher(Q6)
            check([dict(r) for r in res.records.collect()] == [{"triangles": want}]
                  and plan in res.plans and ("MultiwayIntersectOp" in res.plans) ==
                  (plan == "MultiwayIntersectOp"), f"auto on {name} did not plan {plan}")
            print(f"    {name} auto: plans {plan}, {want} triangles")

    time_q14_fallback(torch, g10, truth["Q14"], report)
    time_factorized(torch, g10, g05, gjo, cliques, q38, jo_truth)

    # 6. the serving tier on the card
    serve_smoke(torch, session, tri1["triangles"])

    # 7. the TCK on the card
    print("the TCK through CypherSession.cuda():")
    run_tck(torch, card)

    # 8. the mesh
    t8 = time.perf_counter()
    print(f"the mesh ({card}):")
    mesh_launches = run_mesh_phase(torch, session, g10,
                                   (ids10, bday10, src10, dst10, s10, d10), truth, tri10)
    backend = run_multihost(torch, truth["Q5_rows"])
    print(f"phase 8 done in {time.perf_counter() - t8:.1f} s")

    # 9. the graph sources
    print(f"the graph sources ({card}):")
    sources_launches = run_sources_phase(
        torch, session, card, g1, (ids1, bday1, src1, dst1, s1, d1), truth,
        tri1["triangles"], tri10["triangles"])

    # 10. the static analyzer against the card
    print(f"the static analyzer ({card}):")
    phase_launches = {n: counts[n]["kernel"] + sources_launches[n]
                      for n in dispatch.registry()}
    facts, cli_s = run_analyzer_phase(torch, card, {"small": g1, "big": g10},
                                      phase_launches)

    # 11. the bucket lattice on the card
    print(f"the bucket lattice ({card}):")
    truth["walks"], truth["closes"] = walks, closes
    truth["sf1_arrays"] = (ids1, s1, d1)
    truth["Q11_sf1"] = int(np.bincount(bday1, minlength=18_000)[bday1[d1]].sum())
    lattice_launches = run_lattice_phase(
        torch, card, {"small": g1, "big": g10, "loopy": gl}, truth, facts, cli_s)

    specs = dispatch.registry()
    kernels = []
    for name in ("expand_rows", "frontier_deg_sum", "segment_agg", "intersect",
                 "join_probe"):
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": specs[name].source,
            "replaces": specs[name].replaces,
            "launches": counts[name]["kernel"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r["library_call"],
            "shape": r["shape"],
            "mesh_launches": {m: n.get(name, 0) for m, n in mesh_launches.items()},
            "multihost_backend": backend,
            "sources_launches": sources_launches[name],
            "lattice_launches": lattice_launches[name],
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_call", "shape")},
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)  # the nvidia-smi line as it came: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
