"""LDBC SNB graph support: datagen CSV loader + synthetic generator.

The driver-defined benchmark ladder (``BASELINE.md``) is LDBC Social Network
Benchmark shaped: Person/KNOWS at SF1..SF100 with 2-hop friends-of-friends,
triangle closure, and IS3-style property queries. Two entry points:

* ``load_snb_csv(dir)``  — reads the LDBC datagen "social_network" CSV layout
  (``person_0_0.csv``, ``person_knows_person_0_0.csv``, pipe-delimited with
  headers) into a property graph.
* ``generate_snb(scale)`` — synthesizes an SNB-like Person/KNOWS graph with
  power-law degrees for benchmarks when datagen output is unavailable
  (deterministic per seed).

The reference has no LDBC loader — its benchmark story is a JMH microbench
harness (``morpheus-jmh``); this module exists to back the TPU bench ladder.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import types as T
from ..api.mapping import NodeMapping, RelationshipMapping
from ..api.schema import PropertyGraphSchema
from ..relational.graphs import ElementTable, ScanGraph
from .datasource import DataSourceError

PERSON_LABEL = "Person"
KNOWS_TYPE = "KNOWS"

# LDBC person ids collide with nothing; KNOWS edge ids go in a disjoint range
EDGE_ID_OFFSET = 1 << 53


def _read_csv(path: str, delimiter: str = "|") -> Tuple[List[str], List[List[str]]]:
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=delimiter)
        header = next(r)
        return header, list(r)


def load_snb_csv(directory: str, session, delimiter: str = "|") -> ScanGraph:
    """Load the LDBC datagen person/knows slice from a ``social_network``
    CSV directory. Recognizes both ``person_0_0.csv`` (datagen v0.3) and
    ``Person.csv`` style names."""

    def find(*names: str) -> Optional[str]:
        for n in names:
            p = os.path.join(directory, n)
            if os.path.isfile(p):
                return p
        return None

    person_path = find("person_0_0.csv", "Person.csv", "person.csv")
    knows_path = find(
        "person_knows_person_0_0.csv", "Person_knows_Person.csv",
        "person_knows_person.csv",
    )
    if person_path is None or knows_path is None:
        raise DataSourceError(
            f"No LDBC person/knows CSVs under {directory!r} "
            "(expected person_0_0.csv + person_knows_person_0_0.csv)"
        )

    header, rows = _read_csv(person_path, delimiter)
    cols = {h.split(":")[0].lower(): i for i, h in enumerate(header)}
    if "id" not in cols:
        raise DataSourceError(f"LDBC person CSV lacks an id column: {header}")
    ids = [int(r[cols["id"]]) for r in rows]
    person_cols: Dict[str, List] = {"id": ids}
    prop_types: Dict[str, T.CypherType] = {}
    for key, ct in (
        ("firstname", T.CTString),
        ("lastname", T.CTString),
        ("gender", T.CTString),
        ("birthday", T.CTString),
        ("creationdate", T.CTString),
    ):
        if key in cols:
            person_cols[key] = [r[cols[key]] for r in rows]
            prop_types[key] = ct.nullable

    kh, krows = _read_csv(knows_path, delimiter)
    kcols = {h.split(":")[0].lower(): i for i, h in enumerate(kh)}
    # datagen names the endpoint columns Person1Id/Person2Id (or :START_ID)
    s_i = kcols.get("person1id", kcols.get("person.id", 0))
    t_i = kcols.get("person2id", 1 if len(kh) > 1 else 0)
    src = [int(r[s_i]) for r in krows]
    dst = [int(r[t_i]) for r in krows]

    return _graph_from_arrays(
        session,
        np.asarray(ids, dtype=np.int64),
        person_cols,
        prop_types,
        np.asarray(src, dtype=np.int64),
        np.asarray(dst, dtype=np.int64),
        undirected_knows=True,
    )


# the temporal graph's spans: creation times fall in 2010-2013, to the second
TEMPORAL_EPOCH = np.datetime64("2010-01-01T00:00:00", "s")
TEMPORAL_SPAN_S = 1461 * 86_400
# the multipliers of ``temporal_seconds`` for Person.created and
# KNOWS.creationDate
CREATED_SPREAD = 40_503
KNOWS_SPREAD = 2_654_435_761


def temporal_seconds(index: np.ndarray, mult: int) -> np.ndarray:
    """Seconds after ``TEMPORAL_EPOCH`` for rows ``index``: a fixed
    multiplicative spread over the span."""
    return (index.astype(np.int64) * mult) % TEMPORAL_SPAN_S


def generate_snb(
    scale: float, session, seed: int = 42, temporal: bool = False
) -> ScanGraph:
    """Synthetic SNB-like Person/KNOWS graph. ``scale=1.0`` approximates SF1
    density (~10k persons, ~450k directed KNOWS edges); degrees are
    power-law-ish (preferential-attachment flavored).

    ``temporal=True`` makes the LDBC SNB temporal properties device
    temporal columns: ``Person.birthday`` a date (the same days since
    1970-01-01, ingested value by value), ``Person.created`` a datetime at
    +02:00 (value by value) and ``KNOWS.creationDate`` a localdatetime (a
    ``datetime64[us]`` array, the bulk path), both in 2010-2013 by
    ``temporal_seconds`` of the row index."""
    num_people = max(2, int(10_000 * scale))
    num_knows = int(num_people * 45)
    rng = np.random.default_rng(seed)
    ids = np.arange(num_people, dtype=np.int64) * 7 + 1
    head = rng.zipf(1.35, size=num_knows) % num_people
    uni = rng.integers(0, num_people, size=num_knows)
    src_i = np.where(rng.random(num_knows) < 0.5, head, uni)
    dst_i = rng.integers(0, num_people, size=num_knows)
    keep = src_i != dst_i
    src, dst = ids[src_i[keep]], ids[dst_i[keep]]
    # birthday: days-since-epoch ints (IS3-style property filters); numpy so
    # the bulk ingestion path stays one H2D copy per column at SF10 scale
    birthday = rng.integers(0, 18_000, size=num_people, dtype=np.int64)
    person_cols: Dict[str, Any] = {"id": ids, "birthday": birthday}
    # expose the id column as a property too (LDBC queries anchor on
    # ``a.id`` ranges; the bench's var-length source filter does the same)
    prop_types: Dict[str, T.CypherType] = {
        "id": T.CTInteger.nullable,
        "birthday": T.CTInteger.nullable,
    }
    knows_cols: Dict[str, Any] = {}
    knows_types: Dict[str, T.CypherType] = {}
    if temporal:
        import datetime as _dt

        epoch = _dt.date(1970, 1, 1)
        person_cols["birthday"] = [epoch + _dt.timedelta(days=int(b)) for b in birthday]
        prop_types["birthday"] = T.CTDate.nullable
        tz = _dt.timezone(_dt.timedelta(hours=2))
        start = _dt.datetime(2010, 1, 1, tzinfo=tz)
        person_cols["created"] = [
            start + _dt.timedelta(seconds=int(x))
            for x in temporal_seconds(np.arange(num_people), CREATED_SPREAD)
        ]
        prop_types["created"] = T.CTDateTime.nullable
        secs = temporal_seconds(np.arange(len(src)), KNOWS_SPREAD)
        knows_cols["creationDate"] = (TEMPORAL_EPOCH + secs).astype("datetime64[us]")
        knows_types["creationDate"] = T.CTLocalDateTime.nullable
    if num_people <= 200_000:  # string props only at list-walkable sizes
        person_cols["firstname"] = [f"p{i}" for i in range(num_people)]
        prop_types["firstname"] = T.CTString.nullable
    return _graph_from_arrays(
        session,
        ids,
        person_cols,
        prop_types,
        src,
        dst,
        undirected_knows=False,
        knows_cols=knows_cols,
        knows_types=knows_types,
    )


def _graph_from_arrays(
    session,
    ids: np.ndarray,
    person_cols: Dict[str, List],
    prop_types: Dict[str, T.CypherType],
    src: np.ndarray,
    dst: np.ndarray,
    undirected_knows: bool,
    knows_cols: Optional[Dict[str, Any]] = None,
    knows_types: Optional[Dict[str, T.CypherType]] = None,
) -> ScanGraph:
    """Assemble the Person/KNOWS ScanGraph. LDBC datagen stores KNOWS once
    per unordered pair; Cypher's SNB queries traverse it both ways, so
    ``undirected_knows=True`` materializes both orientations (the reference
    models undirected traversal as a union of orientations at plan time; for
    a benchmark-focused loader, storing both directions keeps every hop a
    plain directed expand). ``knows_cols`` adds KNOWS properties, one
    value per edge in ``src`` order (both orientations share it), typed by
    ``knows_types``."""
    knows_cols = dict(knows_cols or {})
    if undirected_knows:
        src, dst = (
            np.concatenate([src, dst]),
            np.concatenate([dst, src]),
        )
        knows_cols = {k: np.concatenate([v, v]) for k, v in knows_cols.items()}
    edge_ids = np.arange(len(src), dtype=np.int64) + EDGE_ID_OFFSET
    if len(ids) and int(ids.max(initial=0)) >= EDGE_ID_OFFSET:
        raise DataSourceError("LDBC ids exceed the supported id range")

    node_table = session.table_cls.from_arrays(person_cols)
    rel_table = session.table_cls.from_arrays(
        {"id": edge_ids, "source": src, "target": dst, **knows_cols}
    )
    schema = (
        PropertyGraphSchema.empty()
        .with_node_combination(frozenset({PERSON_LABEL}), prop_types)
        .with_relationship_type(KNOWS_TYPE, dict(knows_types or {}))
    )
    return ScanGraph(
        [
            ElementTable(
                NodeMapping(
                    id_key="id",
                    implied_labels=frozenset({PERSON_LABEL}),
                    property_mapping=tuple((k, k) for k in prop_types),
                ),
                node_table,
            ),
            ElementTable(
                RelationshipMapping(
                    id_key="id",
                    source_key="source",
                    target_key="target",
                    rel_type=KNOWS_TYPE,
                    property_mapping=tuple((k, k) for k in knows_cols),
                ),
                rel_table,
            ),
        ],
        schema,
    )


# The SNB query shapes the benchmark ladder runs (BASELINE.md configs 2-4)
FRIENDS_OF_FRIENDS = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) "
    "RETURN count(*) AS paths"
)
TRIANGLES = (
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) "
    "RETURN count(*) AS triangles"
)
