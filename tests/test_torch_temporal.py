"""The temporal kinds on the port (``backend/cuda/temporal.py`` and the
``DATE``, ``LDT``, ``ZDT``, ``ZT``, ``LT`` and ``DUR`` columns) against the
JAX package, on the CPU.

* The calendar math against Python's ``datetime`` over +-200 years, at
  the endpoints of years 1 and 9999, and under ``hypothesis``.
* The column round trip of all six kinds with nulls, and the values that
  stay host objects (dates mixed with datetimes, offsets that differ from
  row to row, zones named by region).
* Every query of ``tests/test_temporal_device.py`` and
  ``tests/test_duration_device.py``, and ``examples/05_temporal.py``'s,
  across the reference's ``CypherSession.tpu()``, its ``local()`` oracle
  and the port; a wider corpus of this slice's expressions (every kind's
  accessors, arithmetic, truncation, ordering, grouping, joins, lists and
  maps, the range and type errors) against ``local()``.
* A date written by ``SET``, read back from the delta snapshot and from a
  WAL replay, and one served query that returns a date.

Every comparison is exact: values compare as themselves (a duration of
either package as its four components), ordered where the query orders
and as bags elsewhere; an error compares by type name and message.
"""

import asyncio
import datetime as dt
import json
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import tpu_cypher as R
import tpu_cypher.serve as RS

from tpu_cypher_torch import CypherSession
import tpu_cypher_torch.serve as PS
import tpu_cypher_torch.storage as PST
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import temporal as TP
from tpu_cypher_torch.backend.cuda.column import Column
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD

sys.path.insert(0, os.path.dirname(__file__))
import test_duration_device as DUR_REF  # noqa: E402
import test_temporal_device as TEMP_REF  # noqa: E402

torch.set_num_threads(1)

UTC2 = dt.timezone(dt.timedelta(hours=2))


@pytest.fixture(autouse=True)
def _cpu():
    PDEV.use("cpu")
    yield


def canon(v):
    """A value of either package as a plain comparable: a duration as its
    four components, lists and maps element by element."""
    if type(v).__name__ == "Duration":
        return ("duration", v.months, v.days, v.seconds, v.microseconds)
    if isinstance(v, (list, tuple)):
        return [canon(x) for x in v]
    if hasattr(v, "items"):
        return {k: canon(x) for k, x in v.items()}
    return v


def rows_of(graph, q, params=None):
    return [canon(dict(r)) for r in graph.cypher(q, params).records.collect()]


def outcome(graph, q):
    try:
        return ("rows", rows_of(graph, q))
    except Exception as exc:  # an error compares by its type and message
        return ("error", type(exc).__name__, str(exc))


def same(q, got, want):
    if "ORDER BY" in q or got[0] == "error":
        assert got == want, q
    else:
        key = lambda r: json.dumps(r, sort_keys=True, default=repr)  # noqa: E731
        assert got[0] == want[0] and Counter(map(key, got[1])) == Counter(map(key, want[1])), q


# ---------------------------------------------------------------------------
# calendar math
# ---------------------------------------------------------------------------


def _check_days(days):
    z = torch.tensor(days, dtype=torch.int64)
    y, m, d = TP.civil_from_days(z)
    back = TP.days_from_civil(y, m, d)
    dow = TP.iso_weekday(z)
    week, weekyear = TP.iso_week_and_year(z)
    for i, zi in enumerate(days):
        pd_ = dt.date.fromordinal(int(zi) + TP.EPOCH_ORDINAL)
        assert (int(y[i]), int(m[i]), int(d[i])) == (pd_.year, pd_.month, pd_.day), pd_
        assert int(back[i]) == zi
        assert int(dow[i]) == pd_.isoweekday(), pd_
        iso = pd_.isocalendar()
        assert (int(week[i]), int(weekyear[i])) == (iso[1], iso[0]), pd_
        assert int(TP.date_accessor("ordinalday", z[i:i + 1])[0]) == pd_.timetuple().tm_yday


def test_calendar_against_python():
    """Days over +-200 years around 1970 and the endpoints of years 1 and
    9999: civil fields, their inverse, ISO weekday, week and week year."""
    rng = np.random.default_rng(3)
    ends = list(range(TP.MIN_DAYS, TP.MIN_DAYS + 400)) + list(range(TP.MAX_DAYS - 400, TP.MAX_DAYS + 1))
    _check_days([int(x) for x in rng.integers(-73000, 73000, 3000)] + ends)


@settings(max_examples=200, deadline=None)
@given(st.integers(TP.MIN_DAYS, TP.MAX_DAYS), st.integers(0, TP.US_PER_DAY - 1),
       st.integers(-30, 30), st.integers(-40, 40))
def test_calendar_hypothesis(days, tod, months, ddays):
    """A datetime's split, accessors and truncation, and a month and day
    shift, against Python's datetime (floor semantics before 1970)."""
    _check_days([days])
    us = torch.tensor([days * TP.US_PER_DAY + tod])
    want = TP.decode_ldt(int(us[0]))
    d, t = TP.split_ldt(us)
    assert int(d[0]) == days and int(t[0]) == tod
    assert int(TP.time_accessor("minute", t)[0]) == want.minute
    assert int(TP.time_accessor("millisecond", t)[0]) == want.microsecond // 1000
    week = TP.truncate_ldt_micros("week", us)[0]
    assert TP.decode_ldt(int(week[0])).date() == want.date() - dt.timedelta(days=want.weekday())
    out, mid = TP.add_duration_micros(us, torch.tensor([months]), torch.tensor([ddays]),
                                      torch.tensor([0]))
    tot = want.year * 12 + want.month - 1 + months
    y, m = divmod(tot, 12)
    if not 1 <= y <= 9999:
        return
    import calendar

    base = want.replace(year=y, month=m + 1, day=min(want.day, calendar.monthrange(y, m + 1)[1]))
    assert int(mid[0]) == TP.encode_date(base.date())
    try:
        shifted = base + dt.timedelta(days=ddays)
    except OverflowError:  # past year 9999 or before year 1
        return
    assert TP.decode_ldt(int(out[0])) == shifted


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------

ROUND_TRIPS = {
    "date": [dt.date(1987, 6, 15), None, dt.date(1969, 12, 31), dt.date(1, 1, 1),
             dt.date(9999, 12, 31)],
    "ldt": [dt.datetime(2001, 3, 4, 5, 6, 7, 123456), dt.datetime(1969, 12, 31, 23, 59, 59, 999999),
            None, dt.datetime(1, 1, 1)],
    "zdt": [dt.datetime(2020, 1, 1, 12, 0, tzinfo=UTC2), None,
            dt.datetime(1969, 6, 1, 0, 30, 0, 5, tzinfo=UTC2)],
    "zt": [dt.time(9, 30, tzinfo=UTC2), dt.time(1, 0, 0, 250, tzinfo=UTC2), None],
    "lt": [dt.time(9, 30), None, dt.time(23, 59, 59, 999999), dt.time(0)],
    "dur": [R.api.values.Duration(months=14, days=3, seconds=14706), None,
            R.api.values.Duration(months=-1), R.api.values.Duration(microseconds=1_500_000),
            R.api.values.Duration(days=2, microseconds=-1)],
}


@pytest.mark.parametrize("kind", sorted(ROUND_TRIPS))
def test_column_round_trip(kind):
    from tpu_cypher_torch.api.values import Duration

    vals = ROUND_TRIPS[kind]
    if kind == "dur":  # the port's own Duration
        vals = [None if v is None else Duration(v.months, v.days, v.seconds, v.microseconds)
                for v in vals]
    c = Column.from_values(vals)
    assert c.kind == kind
    assert canon(c.to_values()) == canon(vals)
    assert canon(c.take(torch.tensor([2, 0])).to_values()) == canon([vals[2], vals[0]])
    assert canon(c.concat(c).to_values_range(1, len(vals) + 1)) == canon(vals[1:] + vals[:1])
    assert canon(c.to_obj().to_values()) == canon(vals)
    ok = torch.tensor([True, False])
    assert canon(c.take_or_null(torch.tensor([0, 1]), ok).to_values()) == canon([vals[0], None])
    assert c.take_or_null(torch.tensor([0]), ok[:1]).kind == kind


def test_values_that_stay_objects():
    import zoneinfo

    assert Column.from_values([dt.date(2020, 1, 1), dt.datetime(2020, 1, 1)]).kind == "obj"
    mixed = [dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc), dt.datetime(2020, 1, 1, tzinfo=UTC2)]
    assert Column.from_values(mixed).kind == "obj"
    named = [dt.datetime(2020, 1, 1, tzinfo=zoneinfo.ZoneInfo("Europe/Berlin"))]
    assert Column.from_values(named).kind == "obj"
    assert Column.from_values([dt.time(1), dt.time(2, tzinfo=UTC2)]).kind == "obj"
    # two zoned columns of different offsets concatenate as host objects
    a = Column.from_values([mixed[0]])
    b = Column.from_values([mixed[1]])
    assert a.concat(b).kind == "obj" and a.concat(b).to_values() == mixed
    # numpy's datetime64 takes the bulk path; NaT is null
    arr = np.array(["2020-01-02", "NaT", "1969-12-31"], dtype="datetime64[D]")
    assert Column.from_numpy(arr).to_values() == [dt.date(2020, 1, 2), None, dt.date(1969, 12, 31)]
    arr = np.array(["2020-01-02T03:04:05.000006"], dtype="datetime64[us]")
    assert Column.from_numpy(arr).to_values() == [dt.datetime(2020, 1, 2, 3, 4, 5, 6)]


# ---------------------------------------------------------------------------
# the reference's corpora, across the three engines
# ---------------------------------------------------------------------------

EXAMPLE_CREATE = """
CREATE (:Person {name: 'ada',   born: date('1815-12-10')}),
       (:Person {name: 'grace', born: date('1906-12-09')}),
       (:Person {name: 'alan',  born: date('1912-06-23')}),
       (:Person {name: 'edsger', born: date('1930-05-11')}),
       (:Event {name: 'launch', at: localdatetime('2019-03-09T11:45:22')})
"""
# the queries of examples/05_temporal.py
EXAMPLE_QUERIES = [
    "MATCH (p:Person) WHERE p.born >= date('1900-01-01') "
    "RETURN p.name AS name, p.born.year AS year ORDER BY year",
    "MATCH (p:Person) WITH date.truncate('decade', p.born) AS dec, count(*) AS c "
    "RETURN toString(dec) AS decade, c ORDER BY decade",
    "MATCH (p:Person) RETURN p.name AS name, "
    "duration.between(p.born, date('2020-01-01')).years AS age ORDER BY age DESC LIMIT 2",
    "MATCH (e:Event) RETURN e.at.hour AS h, e.at.minute AS m, e.at.dayOfWeek AS dow",
]
# what the example prints, written out by hand
EXAMPLE_TRUTH = [
    [{"name": "grace", "year": 1906}, {"name": "alan", "year": 1912},
     {"name": "edsger", "year": 1930}],
    [{"decade": "1810-01-01", "c": 1}, {"decade": "1900-01-01", "c": 1},
     {"decade": "1910-01-01", "c": 1}, {"decade": "1930-01-01", "c": 1}],
    [{"name": "ada", "age": 204}, {"name": "grace", "age": 113}],
    [{"h": 11, "m": 45, "dow": 6}],
]

CORPORA = {
    "temporal": (TEMP_REF.CREATE, TEMP_REF.DEVICE_QUERIES),
    "duration": (DUR_REF.CREATE, DUR_REF.DEVICE_QUERIES),
    "example": (EXAMPLE_CREATE, EXAMPLE_QUERIES),
}
CASES = [(c, i) for c, (_, qs) in CORPORA.items() for i in range(len(qs))]


@pytest.fixture(scope="module")
def engines():
    """{corpus: (reference tpu(), reference local(), port)} graphs."""
    out = {}
    for name, (create, _) in CORPORA.items():
        out[name] = (
            R.CypherSession.tpu().create_graph_from_create_query(create),
            R.CypherSession.local().create_graph_from_create_query(create),
            CypherSession.cuda(device="cpu").create_graph_from_create_query(create),
        )
    return out


@pytest.mark.parametrize("corpus,i", CASES)
def test_reference_corpora_across_engines(engines, corpus, i):
    q = CORPORA[corpus][1][i]
    tpu, local, port = engines[corpus]
    want = outcome(local, q)
    assert want[0] == "rows", want
    same(q, outcome(tpu, q), want)
    same(q, outcome(port, q), want)
    if corpus == "example":
        assert want[1] == EXAMPLE_TRUTH[i]


def test_join_on_date_through_join_probe(engines):
    """``test_temporal_join_on_date``'s join: the probe runs on the
    ``join_probe`` gate (its plain tier here)."""
    q = "MATCH (a:E), (b:E) WHERE a.d = b.d AND a.t IS NULL RETURN count(*) AS c"
    tpu, local, port = engines["temporal"]
    before = PD.use_counts()["join_probe"]["plain"]
    got = port.cypher(q)
    assert rows_of(local, q) == rows_of(tpu, q) == [canon(dict(r)) for r in got.records.collect()]
    assert "JoinOp" in got.plans
    assert PD.use_counts()["join_probe"]["plain"] > before


def test_duration_order_ties_are_stable():
    """One month and 30.4375 days share the average-length key: ORDER BY
    keeps their row order, as the oracle does."""
    create = ("CREATE (a:T {i: 1, d: duration('P1M')}), "
              "(b:T {i: 2, d: duration({days: 30, hours: 10, minutes: 30})}), "
              "(c:T {i: 3, d: duration('P1M')})")
    local = R.CypherSession.local().create_graph_from_create_query(create)
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
    for q in ("MATCH (x:T) RETURN x.i AS i, x.d AS d ORDER BY d",
              "MATCH (x:T) RETURN x.i AS i, x.d AS d ORDER BY d DESC",
              "MATCH (x:T) RETURN min(x.d) AS lo, max(x.d) AS hi"):
        assert rows_of(port, q) == rows_of(local, q), q
    assert [r["i"] for r in rows_of(port, "MATCH (x:T) RETURN x.i AS i ORDER BY x.d")] == [1, 2, 3]


def test_duration_sum_of_empty_groups():
    """The oracle sums a group with no durations to INTEGER 0: where every
    group is such the port gives INTEGER zeros, where only some are the
    sums mixed with zeros as host values."""
    create = "CREATE (a:G {k: 1}), (b:G {k: 1}), (c:G {k: 2, d: duration('P1D')})"
    local = R.CypherSession.local().create_graph_from_create_query(create)
    port = CypherSession.cuda(device="cpu").create_graph_from_create_query(create)
    for q in ("MATCH (x:G) WHERE x.k = 1 RETURN x.k AS k, sum(x.d) AS s",
              "MATCH (x:G) WHERE x.k = 1 RETURN sum(x.d) AS s",
              "MATCH (x:G) WHERE x.k = 2 RETURN x.k AS k, sum(x.d) AS s, avg(x.d) AS a",
              "MATCH (x:G) RETURN x.k AS k, sum(x.d) AS s, min(x.d) AS m ORDER BY k"):
        assert rows_of(port, q) == rows_of(local, q), q


# ---------------------------------------------------------------------------
# this slice's expressions against the oracle
# ---------------------------------------------------------------------------

WIDE_CREATE = (
    "CREATE (:W {i: 1, d: date('1987-06-15'), t: localdatetime('2001-03-04T05:06:07.123456'), "
    "z: datetime('2020-01-01T23:30:00+02:00'), zt: time('01:00:00+02:00'), "
    "lt: localtime('09:30:15.5'), u: duration('P1Y2M3DT4H5M6.5S')}), "
    "(:W {i: 2, d: date('1969-12-31'), t: localdatetime('1969-12-31T23:59:59.999999'), "
    "z: datetime('1969-06-01T00:30:00+02:00'), zt: time('23:00:00+02:00'), "
    "lt: localtime('23:59:59'), u: duration('-P1M')}), "
    "(:W {i: 3, d: date('0001-01-01'), t: localdatetime('9999-12-31T23:59:59'), "
    "z: datetime('2020-02-29T12:00:00+02:00'), zt: time('12:00:00+02:00'), "
    "lt: localtime('00:00'), u: duration('PT36H')}), "
    "(:W {i: 4, d: date('2020-02-29'), u: duration('P30DT12H')}), "
    "(:W {i: 5}), "
    "(:W {i: 6, d: date('1987-06-15'), t: localdatetime('1987-06-15T00:00:00')}), "
    "(:M {d: date('9999-12-31')})"
)
W = "MATCH (w:W) "
WIDE_QUERIES = [
    # accessors of every kind
    W + "RETURN w.i AS i, w.d.year AS y, w.d.weekYear AS wy, w.d.week AS wk, "
    "w.d.dayOfQuarter AS dq, w.d.ordinalDay AS od ORDER BY i",
    W + "RETURN w.i AS i, w.t.quarter AS q, w.t.second AS s, w.t.millisecond AS ms, "
    "w.t.dayOfWeek AS dw ORDER BY i",
    W + "RETURN w.i AS i, w.z.hour AS h, w.z.day AS d, w.z.epochSeconds AS es, "
    "w.z.epochMillis AS em, w.z.timezone AS tz, w.z.offset AS o, "
    "w.z.offsetMinutes AS om, w.z.offsetSeconds AS os ORDER BY i",
    W + "RETURN w.i AS i, w.zt.hour AS h, w.zt.minute AS m, w.zt.offset AS o, "
    "w.lt.hour AS lh, w.lt.microsecond AS lus ORDER BY i",
    W + "RETURN w.i AS i, w.u.years AS y, w.u.monthsOfYear AS my, w.u.weeks AS wk, "
    "w.u.hours AS h, w.u.minutes AS mi, w.u.seconds AS s, w.u.milliseconds AS ms ORDER BY i",
    # arithmetic
    W + "RETURN w.i AS i, w.d + duration('P1M') AS a, w.d - duration('P1Y3D') AS b, "
    "duration('P2D') + w.d AS c ORDER BY i",
    W + "WHERE w.i <> 3 RETURN w.i AS i, w.t + duration('P1M2DT3H') AS a, "
    "w.t - duration('PT0.000001S') AS b ORDER BY i",
    W + "RETURN w.i AS i, w.z + duration('P1MT1H') AS a, w.zt + duration('PT2H') AS b, "
    "w.lt - duration('PT10H') AS c ORDER BY i",
    W + "RETURN w.i AS i, w.u + w.u AS a, w.u - duration('P1D') AS b, -w.u AS c, "
    "w.u * 2 AS d, w.u / 2 AS e, w.u * 0.5 AS f ORDER BY i",
    W + "WHERE w.i IN [1, 2] RETURN w.i AS i, w.d + duration('PT12H') AS a ORDER BY i",
    # truncation
    W + "RETURN w.i AS i, date.truncate('week', w.d) AS a, date.truncate('quarter', w.d) AS b, "
    "date.truncate('month', w.t) AS c, date.truncate('year', w.z) AS e ORDER BY i",
    W + "WHERE w.i <> 3 RETURN w.i AS i, date.truncate('millennium', w.d) AS a, "
    "localdatetime.truncate('hour', w.t) AS b, localdatetime.truncate('century', w.d) AS c, "
    "datetime.truncate('day', w.z) AS e ORDER BY i",
    W + "RETURN w.i AS i, localdatetime.truncate('millisecond', w.t) AS a, "
    "localdatetime.truncate('decade', w.z) AS b ORDER BY i",
    # comparisons, ordering, grouping
    W + "WHERE w.d < date('1987-06-15') RETURN w.i AS i ORDER BY i",
    W + "WHERE w.z >= datetime('2020-01-01T21:30:00Z') RETURN w.i AS i ORDER BY i",
    W + "WHERE w.zt < time('00:00:00Z') RETURN w.i AS i ORDER BY i",
    W + "RETURN w.i AS i, w.d = w.t AS a, w.d < w.t AS b, w.u < w.u AS c, w.u = w.u AS e, "
    "w.lt = w.zt AS f, w.t = w.z AS g ORDER BY i",
    W + "RETURN w.d AS d, count(*) AS c ORDER BY d DESC",
    W + "RETURN w.z AS z ORDER BY z DESC LIMIT 2",
    W + "RETURN w.zt AS z, w.lt AS l ORDER BY z, l",
    W + "RETURN w.u AS u ORDER BY u DESC",
    W + "RETURN DISTINCT w.d AS d",
    W + "RETURN count(DISTINCT w.d) AS a, count(DISTINCT w.u) AS b, count(w.z) AS c",
    W + "RETURN min(w.z) AS a, max(w.zt) AS b, min(w.lt) AS c, max(w.t) AS d, "
    "percentileDisc(w.d, 0.5) AS e, collect(DISTINCT w.d) AS f",
    W + "RETURN w.d.year < 1970 AS old, min(w.d) AS lo, max(w.u) AS hi, sum(w.u) AS s, "
    "avg(w.u) AS a ORDER BY old",
    "MATCH (a:W), (b:W) WHERE a.t = b.t RETURN a.i AS x, b.i AS y ORDER BY x, y",
    "MATCH (a:W), (b:W) WHERE a.u = b.u RETURN a.i AS x, b.i AS y ORDER BY x, y",
    "MATCH (a:W), (b:W) WHERE a.d = b.t RETURN count(*) AS c",
    # functions
    W + "RETURN w.i AS i, toString(w.d) AS a, toString(w.u) AS b, toString(w.z) AS c "
    "ORDER BY i",
    W + "RETURN w.i AS i, duration.between(w.d, w.t) AS a, duration.inMonths(w.t, w.d) AS b, "
    "duration.inDays(w.d, date('2000-01-01')) AS c, duration.inSeconds(w.t, w.d) AS e ORDER BY i",
    W + "RETURN w.i AS i, duration.between(w.zt, w.zt) AS a ORDER BY i",
    W + "WHERE w.i = 1 RETURN date({year: w.i + 2000, month: 2, day: 3}) AS a, "
    "localdatetime(toString(w.t)) AS b",
    W + "RETURN w.i AS i, coalesce(w.t, localdatetime('2000-01-01T00:00:00')) AS a, "
    "coalesce(w.u, duration('PT1S')) AS b, CASE WHEN w.i > 2 THEN w.d ELSE date('2000-01-01') "
    "END AS c ORDER BY i",
    # lists and maps
    W + "RETURN collect(w.d) AS ds, collect(w.u) AS us",
    "UNWIND [date('2020-01-01'), date('1969-12-31'), null] AS x RETURN x AS d, x.year AS y "
    "ORDER BY d",
    W + "WHERE w.d IN [date('1987-06-15'), date('0001-01-01')] RETURN w.i AS i ORDER BY i",
    W + "WHERE w.u IN [duration('-P1M'), duration('PT36H')] RETURN w.i AS i ORDER BY i",
    W + "RETURN w.i AS i, {d: w.d, y: w.d.year} AS m, [w.d, w.d] AS l ORDER BY i",
    W + "WHERE w.i = 1 RETURN properties(w) AS p",
    W + "WITH w.i AS i, collect(w.t) AS ts UNWIND ts AS t RETURN i, t.year AS y ORDER BY i",
    W + "RETURN [w.d] AS l, count(*) AS c ORDER BY l",
    # the oracle's errors
    "MATCH (m:M) RETURN m.d + duration('P1D') AS a",
    "MATCH (m:M) RETURN m.d + duration('P-10000Y') AS a",
    "MATCH (m:M) RETURN m.d + m.d AS a",
    "MATCH (m:M) RETURN m.d - m.d AS a",
    "MATCH (m:M) RETURN m.d + 'x' AS a",
    "MATCH (m:M) RETURN m.d.hour AS a",
    "MATCH (m:M) RETURN date.truncate('hour', m.d) AS a",
    "MATCH (m:M) RETURN date.truncate('fortnight', m.d) AS a",
    W + "WHERE w.i = 3 RETURN date.truncate('decade', w.d) AS a",
    W + "WHERE w.i = 1 RETURN w.t.epochSeconds AS a",
]


@pytest.fixture(scope="module")
def wide():
    return (R.CypherSession.local().create_graph_from_create_query(WIDE_CREATE),
            CypherSession.cuda(device="cpu").create_graph_from_create_query(WIDE_CREATE))


@pytest.mark.parametrize("i", range(len(WIDE_QUERIES)))
def test_wide_corpus_against_oracle(wide, i):
    q = WIDE_QUERIES[i]
    local, port = wide
    same(q, outcome(port, q), outcome(local, q))


# ---------------------------------------------------------------------------
# writes, snapshots, the WAL and serving
# ---------------------------------------------------------------------------

SEED = "CREATE (a:P {k: 1}), (b:P {k: 2, d: date('1999-01-01')})"
WRITE = ("MATCH (a:P {k: 1}) SET a.d = date('2020-01-02'), "
         "a.z = datetime('2020-01-02T03:04:05+02:00'), a.u = duration('P1M2DT3.5S'), "
         "a.l = [date('2020-01-01'), date('1969-12-31')]")
FINAL = ("CREATE (a:P {k: 1, d: date('2020-01-02'), z: datetime('2020-01-02T03:04:05+02:00'), "
         "u: duration('P1M2DT3.5S'), l: [date('2020-01-01'), date('1969-12-31')]}), "
         "(b:P {k: 2, d: date('1999-01-01')})")
READ = ("MATCH (p:P) RETURN p.k AS k, p.d AS d, p.d.year AS y, p.z AS z, p.u AS u, "
        "p.l AS l ORDER BY d")


def test_set_snapshot_and_wal_replay(tmp_path):
    """A temporal SET reads back from the delta snapshot and, after a WAL
    replay, from a rebuilt graph, as the oracle reads the same final
    state."""
    s = CypherSession.cuda(device="cpu")
    wal = str(tmp_path / "w.wal")
    g = PST.mutable_graph_from_create_query(s, SEED, wal_path=wal)
    g.cypher(WRITE)
    want = rows_of(R.CypherSession.local().create_graph_from_create_query(FINAL), READ)
    assert rows_of(g, READ) == want
    assert rows_of(g, "MATCH (p:P) WHERE p.d > date('2000-01-01') RETURN p.k AS k") == [{"k": 1}]
    replayed = PST.mutable_graph_from_create_query(s, SEED, wal_path=wal)
    assert rows_of(replayed, READ) == want


def test_served_query_returns_a_date():
    """One served query over a graph holding dates: the port's wire rows
    equal the reference server's (dates as Cypher text)."""
    q = "MATCH (e:E) WHERE e.d IS NOT NULL RETURN e.d AS d, e.d.year AS y ORDER BY d"

    async def run(serve, session):
        graph = session.create_graph_from_create_query(TEMP_REF.CREATE)
        srv = serve.QueryServer(session, port=0)
        srv.register_graph("g", graph)
        async with srv:
            reader, writer = await asyncio.open_connection(srv.host, srv.port)
            writer.write((json.dumps({"op": "submit", "graph": "g", "query": q}) + "\n").encode())
            rows = []
            while True:
                m = json.loads(await asyncio.wait_for(reader.readline(), 30))
                rows += m.get("rows", []) if m["type"] == "rows" else []
                if m["type"] in ("done", "error"):
                    break
            writer.close()
            return m["type"], rows

    got = asyncio.run(run(PS, CypherSession.cuda(device="cpu")))
    want = asyncio.run(run(RS, R.CypherSession.tpu()))
    assert got == want and got[0] == "done"
    assert got[1][0] == {"d": "'1970-01-01'", "y": 1970}
