"""Scalar function registry: type signatures + reference semantics.

The reference models ~70 functions as individual ``Expr`` case classes
(``okapi-ir/.../api/expr/Expr.scala``) with per-backend SQL translations
(``FlinkSQLExprMapper.scala:48`` / ``SparkSQLExprMapper.scala``). Here each
function is one table entry: a result-type rule plus a pure-Python reference
implementation (the local backend's evaluator and the oracle for the TPU
kernels; the TPU backend overrides the hot ones with jnp equivalents).

``null_prop`` functions return null when any argument is null (the default
Cypher convention); exceptions (coalesce, toString variants…) opt out.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..api import types as T
from ..api.types import CypherType
from ..api.values import Duration, Node, Path, Relationship, to_cypher_string


class CypherTypeError(Exception):
    pass


@dataclass
class FunctionDef:
    name: str
    min_args: int
    max_args: int  # -1 = varargs
    result_type: Callable[[List[CypherType]], CypherType]
    fn: Callable
    null_prop: bool = True


def _const(t: CypherType):
    return lambda args: t


def _nullable(t: CypherType):
    return lambda args: t.nullable


FUNCTIONS: Dict[str, FunctionDef] = {}


def _register(
    name: str,
    fn: Callable,
    result_type,
    min_args: int = 1,
    max_args: Optional[int] = None,
    null_prop: bool = True,
):
    if isinstance(result_type, CypherType):
        result_type = _const(result_type)
    FUNCTIONS[name] = FunctionDef(
        name,
        min_args,
        min_args if max_args is None else max_args,
        result_type,
        fn,
        null_prop,
    )


# ---------------------------------------------------------------------------
# element functions
# ---------------------------------------------------------------------------


def _f_id(v):
    if isinstance(v, (Node, Relationship)):
        return v.id
    raise CypherTypeError(f"id() expects an element, got {type(v).__name__}")


def _f_labels(v):
    if isinstance(v, Node):
        return sorted(v.labels)
    raise CypherTypeError("labels() expects a node")


def _f_type(v):
    if isinstance(v, Relationship):
        return v.rel_type
    raise CypherTypeError("type() expects a relationship")


def _f_keys(v):
    if isinstance(v, (Node, Relationship)):
        return sorted(k for k, p in v.properties.items() if p is not None)
    if isinstance(v, dict):
        return sorted(v.keys())
    raise CypherTypeError("keys() expects an element or map")


def _f_properties(v):
    if isinstance(v, (Node, Relationship)):
        return dict(v.properties)
    if isinstance(v, dict):
        return dict(v)
    raise CypherTypeError("properties() expects an element or map")


_register("id", _f_id, T.CTInteger)
_register("labels", _f_labels, T.CTList(T.CTString))
_register("type", _f_type, T.CTString)
_register("keys", _f_keys, T.CTList(T.CTString))
_register("properties", _f_properties, T.CTMap(None))
_register(
    "startnode",
    lambda r: r.start if isinstance(r, Relationship) else None,
    T.CTNode(),
)
_register(
    "endnode", lambda r: r.end if isinstance(r, Relationship) else None, T.CTNode()
)


# ---------------------------------------------------------------------------
# scalar / list functions
# ---------------------------------------------------------------------------


def _f_size(v):
    if isinstance(v, (list, tuple, str)):
        return len(v)
    raise CypherTypeError("size() expects a list or string")


def _f_length(v):
    if isinstance(v, Path):
        return sum(1 for e in v.elements if isinstance(e, Relationship))
    if isinstance(v, (list, tuple, str)):
        return len(v)
    raise CypherTypeError("length() expects a path, list or string")


def _f_nodes(v):
    if isinstance(v, Path):
        return [e for e in v.elements if isinstance(e, Node)]
    raise CypherTypeError("nodes() expects a path")


def _f_relationships(v):
    if isinstance(v, Path):
        return [e for e in v.elements if isinstance(e, Relationship)]
    raise CypherTypeError("relationships() expects a path")


def _f_range(*args):
    start, end = args[0], args[1]
    step = args[2] if len(args) > 2 else 1
    if step == 0:
        raise CypherTypeError("range() step must not be zero")
    out = list(range(start, end + (1 if step > 0 else -1), step))
    return out


def _f_coalesce(*args):
    for a in args:
        if a is not None:
            return a
    return None


def _f_head(v):
    return v[0] if v else None


def _f_last(v):
    return v[-1] if v else None


def _f_tail(v):
    return list(v[1:])


def _list_inner(args: List[CypherType]) -> CypherType:
    if args and isinstance(args[0].material, T.CTListType):
        return args[0].material.inner.nullable
    return T.CTAny.nullable


_register("size", _f_size, T.CTInteger)
_register("length", _f_length, T.CTInteger)
_register("nodes", _f_nodes, T.CTList(T.CTNode()))
_register("relationships", _f_relationships, T.CTList(T.CTRelationship()))
_register("range", _f_range, T.CTList(T.CTInteger), min_args=2, max_args=3)
_register(
    "coalesce",
    _f_coalesce,
    lambda args: T.join_types(a for a in args),
    min_args=1,
    max_args=-1,
    null_prop=False,
)
_register("head", _f_head, _list_inner)
_register("last", _f_last, _list_inner)
_register(
    "tail",
    _f_tail,
    lambda args: args[0].material if isinstance(args[0].material, T.CTListType) else T.CTList(T.CTAny),
)
_register("reverse", lambda v: v[::-1], lambda args: args[0])
_register("exists", lambda v: v is not None, T.CTBoolean, null_prop=False)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def _f_tointeger(v):
    if isinstance(v, bool):
        raise CypherTypeError("toInteger() on boolean")
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                return int(float(v))
            except ValueError:
                return None
    raise CypherTypeError("toInteger() expects number or string")


def _f_tofloat(v):
    if isinstance(v, bool):
        raise CypherTypeError("toFloat() on boolean")
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    raise CypherTypeError("toFloat() expects number or string")


def _f_toboolean(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        low = v.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        return None
    raise CypherTypeError("toBoolean() expects boolean or string")


def _f_tostring(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return to_cypher_string(v)
    if isinstance(v, (int, str)):
        return str(v)
    if isinstance(v, (_dt.date, _dt.datetime)):
        return v.isoformat()
    if isinstance(v, Duration):
        return v.cypher_str()
    return str(v)


_register("tointeger", _f_tointeger, _nullable(T.CTInteger))
_register("tofloat", _f_tofloat, _nullable(T.CTFloat))
_register("toboolean", _f_toboolean, _nullable(T.CTBoolean))
_register("tostring", _f_tostring, T.CTString)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------


def _f_substring(s, start, length=None):
    if length is None:
        return s[start:]
    return s[start : start + length]


def _f_split(s, sep):
    return s.split(sep)


_register("touppercase", str.upper, T.CTString)
_register("toupper", str.upper, T.CTString)
_register("tolowercase", str.lower, T.CTString)
_register("tolower", str.lower, T.CTString)
_register("trim", str.strip, T.CTString)
_register("ltrim", str.lstrip, T.CTString)
_register("rtrim", str.rstrip, T.CTString)
_register("substring", _f_substring, T.CTString, min_args=2, max_args=3)
_register("left", lambda s, n: s[:n], T.CTString, min_args=2)
_register("right", lambda s, n: s[-n:] if n > 0 else "", T.CTString, min_args=2)
_register("replace", lambda s, a, b: s.replace(a, b), T.CTString, min_args=3)
_register("split", _f_split, T.CTList(T.CTString), min_args=2)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------


def _numeric_result(args: List[CypherType]) -> CypherType:
    t = args[0].material if args else T.CTNumber
    if t == T.CTInteger:
        return T.CTInteger
    if t == T.CTFloat:
        return T.CTFloat
    return T.CTNumber


def _f_abs(v):
    return abs(v)


def _f_round(v):
    # Cypher rounds half away from zero
    return float(math.floor(v + 0.5)) if v >= 0 else float(math.ceil(v - 0.5))


def _f_sign(v):
    return (v > 0) - (v < 0)


_register("abs", _f_abs, _numeric_result)
_register("ceil", lambda v: float(math.ceil(v)), T.CTFloat)
_register("floor", lambda v: float(math.floor(v)), T.CTFloat)
_register("round", _f_round, T.CTFloat)
_register("sqrt", lambda v: math.sqrt(v), T.CTFloat)
_register("sign", _f_sign, T.CTInteger)
_register("exp", math.exp, T.CTFloat)
_register("log", lambda v: math.log(v) if v > 0 else None, _nullable(T.CTFloat))
_register("log10", lambda v: math.log10(v) if v > 0 else None, _nullable(T.CTFloat))
_register("sin", math.sin, T.CTFloat)
_register("cos", math.cos, T.CTFloat)
_register("tan", math.tan, T.CTFloat)
_register("cot", lambda v: 1.0 / math.tan(v), T.CTFloat)
_register("asin", math.asin, T.CTFloat)
_register("acos", math.acos, T.CTFloat)
_register("atan", math.atan, T.CTFloat)
_register("atan2", math.atan2, T.CTFloat, min_args=2)
_register("degrees", math.degrees, T.CTFloat)
_register("radians", math.radians, T.CTFloat)
_register("haversin", lambda v: (1 - math.cos(v)) / 2, T.CTFloat)
_register("pi", lambda: math.pi, T.CTFloat, min_args=0, max_args=0)
_register("e", lambda: math.e, T.CTFloat, min_args=0, max_args=0)

import random as _random

_register("rand", lambda: _random.random(), T.CTFloat, min_args=0, max_args=0)


# ---------------------------------------------------------------------------
# temporal
# ---------------------------------------------------------------------------

_DATE_RE = re.compile(r"(\d{4})-?(\d{2})?-?(\d{2})?")


def _f_date(v=None):
    if v is None:
        return _dt.date.today()
    if isinstance(v, str):
        m = _DATE_RE.match(v)
        if not m:
            raise CypherTypeError(f"Cannot parse date {v!r}")
        y, mo, d = int(m.group(1)), int(m.group(2) or 1), int(m.group(3) or 1)
        return _dt.date(y, mo, d)
    if isinstance(v, dict):
        return _dt.date(int(v.get("year", 1)), int(v.get("month", 1)), int(v.get("day", 1)))
    raise CypherTypeError("date() expects a string or map")


def _f_localdatetime(v=None):
    if v is None:
        return _dt.datetime.now()
    if isinstance(v, str):
        return _dt.datetime.fromisoformat(v)
    if isinstance(v, dict):
        return _dt.datetime(
            int(v.get("year", 1)),
            int(v.get("month", 1)),
            int(v.get("day", 1)),
            int(v.get("hour", 0)),
            int(v.get("minute", 0)),
            int(v.get("second", 0)),
            int(v.get("millisecond", 0)) * 1000 + int(v.get("microsecond", 0)),
        )
    raise CypherTypeError("localdatetime() expects a string or map")


def _tzinfo_of(spec: str) -> _dt.tzinfo:
    """'+01:00' / 'Z' fixed offsets, else an IANA name via zoneinfo (the
    reference resolves zone ids on the JVM; ``TemporalUdfs.scala:40``)."""
    s = spec.strip()
    if s in ("Z", "z", "UTC"):
        return _dt.timezone.utc
    if s and s[0] in "+-":
        t = _dt.datetime.fromisoformat(f"2000-01-01T00:00:00{s}")
        return t.tzinfo
    from zoneinfo import ZoneInfo

    return ZoneInfo(s)


def _f_datetime(v=None):
    """Zoned datetime (reference CTDateTime / TemporalUdfs): ISO strings
    with offsets, 'Z', or a bracketed zone name; maps with a ``timezone``
    key (DST-correct via zoneinfo); epoch selectors."""
    if v is None:
        return _dt.datetime.now(_dt.timezone.utc)
    if isinstance(v, _dt.datetime):
        return v if v.tzinfo is not None else v.replace(tzinfo=_dt.timezone.utc)
    if isinstance(v, str):
        s = v.strip()
        zone = None
        if s.endswith("]") and "[" in s:
            s, _, z = s.rpartition("[")
            zone = _tzinfo_of(z[:-1])
        if s.endswith(("Z", "z")):
            s = s[:-1] + "+00:00"
        out = _dt.datetime.fromisoformat(s)
        if zone is not None:
            if out.tzinfo is None:
                out = out.replace(tzinfo=zone)
            else:
                out = out.astimezone(zone)
        elif out.tzinfo is None:
            out = out.replace(tzinfo=_dt.timezone.utc)
        return out
    if isinstance(v, dict):
        v = {k.lower(): x for k, x in v.items()}
        tz = _tzinfo_of(str(v.get("timezone", "UTC")))
        if "epochseconds" in v or "epochmillis" in v:
            us = int(v.get("epochseconds", 0)) * 1_000_000
            us += int(v.get("epochmillis", 0)) * 1000
            # integer timedelta arithmetic: a float detour (us / 1e6)
            # rounds at microsecond granularity for large epoch magnitudes
            epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            return (epoch + _dt.timedelta(microseconds=us)).astimezone(tz)
        return _dt.datetime(
            int(v.get("year", 1)),
            int(v.get("month", 1)),
            int(v.get("day", 1)),
            int(v.get("hour", 0)),
            int(v.get("minute", 0)),
            int(v.get("second", 0)),
            int(v.get("millisecond", 0)) * 1000 + int(v.get("microsecond", 0)),
            tzinfo=tz,
        )
    raise CypherTypeError("datetime() expects a string or map")


def _parse_time_body(s: str) -> _dt.time:
    if len(s) == 2:
        s += ":00"
    elif len(s) == 4 and ":" not in s:
        s = s[:2] + ":" + s[2:]
    elif len(s) == 6 and ":" not in s:
        s = s[:2] + ":" + s[2:4] + ":" + s[4:]
    return _dt.time.fromisoformat(s)


def _f_time(v=None):
    if v is None:
        return _dt.datetime.now(_dt.timezone.utc).timetz()
    if isinstance(v, _dt.time):
        return v if v.tzinfo is not None else v.replace(tzinfo=_dt.timezone.utc)
    if isinstance(v, str):
        s = v.strip()
        if s.endswith(("Z", "z")):
            s = s[:-1] + "+00:00"
        out = _parse_time_body(s)
        if out.tzinfo is None:
            out = out.replace(tzinfo=_dt.timezone.utc)
        return out
    if isinstance(v, dict):
        v = {k.lower(): x for k, x in v.items()}
        tz = _tzinfo_of(str(v.get("timezone", "UTC")))
        # named zones resolve their offset against the CURRENT instant (the
        # Neo4j rule) — via an AWARE UTC now: feeding a naive machine-local
        # wall time to utcoffset() would read it as zone-local, making the
        # result depend on the host's timezone (and wrong near DST edges)
        off = _dt.datetime.now(_dt.timezone.utc).astimezone(tz).utcoffset()
        return _dt.time(
            int(v.get("hour", 0)),
            int(v.get("minute", 0)),
            int(v.get("second", 0)),
            int(v.get("millisecond", 0)) * 1000 + int(v.get("microsecond", 0)),
            tzinfo=_dt.timezone(off),
        )
    raise CypherTypeError("time() expects a string or map")


def _f_localtime(v=None):
    if v is None:
        return _dt.datetime.now().time()
    if isinstance(v, _dt.time):
        return v.replace(tzinfo=None)
    if isinstance(v, str):
        return _parse_time_body(v.strip())
    if isinstance(v, dict):
        v = {k.lower(): x for k, x in v.items()}
        return _dt.time(
            int(v.get("hour", 0)),
            int(v.get("minute", 0)),
            int(v.get("second", 0)),
            int(v.get("millisecond", 0)) * 1000 + int(v.get("microsecond", 0)),
        )
    raise CypherTypeError("localtime() expects a string or map")


def _f_datetime_truncate(unit, v):
    if not isinstance(v, _dt.datetime) or v.tzinfo is None:
        raise CypherTypeError("datetime.truncate() expects a zoned datetime")
    tz = v.tzinfo
    out = _truncate_temporal(unit, v.replace(tzinfo=None), allow_sub_day=True)
    return out.replace(tzinfo=tz)


def _f_duration(v):
    if isinstance(v, str):
        return _parse_iso_duration(v)
    if isinstance(v, dict):
        return Duration.of(**{k: v for k, v in v.items()})
    raise CypherTypeError("duration() expects a string or map")


_ISO_DUR = re.compile(
    r"^(?P<sign>-)?P(?:(?P<y>-?[\d.]+)Y)?(?:(?P<mo>-?[\d.]+)M)?(?:(?P<w>-?[\d.]+)W)?"
    r"(?:(?P<d>-?[\d.]+)D)?(?:T(?:(?P<h>-?[\d.]+)H)?(?:(?P<mi>-?[\d.]+)M)?"
    r"(?:(?P<s>-?[\d.]+)S)?)?$"
)


def _parse_iso_duration(s: str) -> Duration:
    m = _ISO_DUR.match(s.strip())
    if not m or s.strip() in ("P", "-P"):
        raise CypherTypeError(f"Cannot parse duration {s!r}")
    g = {k: float(v) if v else 0.0 for k, v in m.groupdict().items() if k != "sign"}
    d = Duration.of(
        years=g["y"], months=g["mo"], weeks=g["w"], days=g["d"],
        hours=g["h"], minutes=g["mi"], seconds=g["s"],
    )
    if m.group("sign"):
        d = -d
    return d


def _add_months(d: _dt.datetime, months: int) -> _dt.datetime:
    y, m = divmod(d.year * 12 + (d.month - 1) + months, 12)
    import calendar

    day = min(d.day, calendar.monthrange(y, m + 1)[1])
    return d.replace(year=y, month=m + 1, day=day)


def _f_duration_between(a, b):
    """Calendar-aware decomposition (Neo4j ``duration.between``): whole
    months truncated toward zero, then whole days, then the time remainder —
    NOT a flat day count, and NOT swap-and-negate. Month-end clamping makes
    those differ: between(2020-03-31, 2020-02-28) anchors at 2020-02-29
    (leap year) giving P-1M-1D, where swap-and-negate would give -(P1M3D);
    in a non-leap year the anchor clamps to Feb 28 exactly, giving P-1M."""
    if isinstance(a, _dt.date) and not isinstance(a, _dt.datetime):
        a = _dt.datetime(a.year, a.month, a.day)
    if isinstance(b, _dt.date) and not isinstance(b, _dt.datetime):
        b = _dt.datetime(b.year, b.month, b.day)
    months = (b.year - a.year) * 12 + (b.month - a.month)
    # pull the month anchor back toward a if it overshot b
    if months > 0 and _add_months(a, months) > b:
        months -= 1
    elif months < 0 and _add_months(a, months) < b:
        months += 1
    anchor = _add_months(a, months)
    delta = b - anchor
    total_us = (delta.days * 86400 + delta.seconds) * 1_000_000 + delta.microseconds
    sign_t = 1 if total_us >= 0 else -1
    day_us = 86400 * 1_000_000
    days = sign_t * (abs(total_us) // day_us)
    rem = total_us - days * day_us
    secs = sign_t * (abs(rem) // 1_000_000)
    us = rem - secs * 1_000_000
    return Duration(months=months, days=days, seconds=secs, microseconds=us)


_TRUNC_UNITS = (
    "millennium", "century", "decade", "year", "quarter", "month", "week",
    "day", "hour", "minute", "second", "millisecond", "microsecond",
)


_SUB_DAY_UNITS = ("hour", "minute", "second", "millisecond", "microsecond")


def _truncate_temporal(unit: str, v, allow_sub_day: bool):
    """Shared truncation core (Neo4j ``<type>.truncate(unit, temporal)``):
    returns a datetime at the start of the requested unit. ``allow_sub_day``
    is False for ``date.truncate`` — a date cannot carry time fields, so
    sub-day units are an error regardless of the input's type."""
    u = str(unit).lower()
    if u not in _TRUNC_UNITS:
        raise CypherTypeError(f"Unknown truncation unit {unit!r}")
    if u in _SUB_DAY_UNITS and not allow_sub_day:
        raise CypherTypeError(f"Unit {unit!r} is too small to truncate a date to")
    if isinstance(v, _dt.datetime):
        y, mo, d = v.year, v.month, v.day
        h, mi, s, us = v.hour, v.minute, v.second, v.microsecond
    elif isinstance(v, _dt.date):
        y, mo, d = v.year, v.month, v.day
        h = mi = s = us = 0
        if u in _SUB_DAY_UNITS:
            raise CypherTypeError(f"Cannot truncate a date to {unit!r}")
    else:
        raise CypherTypeError("truncate() expects a temporal value")

    def year_start(yy: int) -> _dt.datetime:
        if yy < _dt.MINYEAR:  # proleptic range floor (year 0 unrepresentable)
            raise CypherTypeError(
                f"Cannot truncate year {y} to {unit!r}: start of unit is out of range"
            )
        return _dt.datetime(yy, 1, 1)

    if u == "millennium":
        return year_start(y - y % 1000)
    if u == "century":
        return year_start(y - y % 100)
    if u == "decade":
        return year_start(y - y % 10)
    if u == "year":
        return _dt.datetime(y, 1, 1)
    if u == "quarter":
        return _dt.datetime(y, 3 * ((mo - 1) // 3) + 1, 1)
    if u == "month":
        return _dt.datetime(y, mo, 1)
    if u == "week":
        monday = _dt.date(y, mo, d) - _dt.timedelta(
            days=_dt.date(y, mo, d).isoweekday() - 1
        )
        return _dt.datetime(monday.year, monday.month, monday.day)
    if u == "day":
        return _dt.datetime(y, mo, d)
    if u == "hour":
        return _dt.datetime(y, mo, d, h)
    if u == "minute":
        return _dt.datetime(y, mo, d, h, mi)
    if u == "second":
        return _dt.datetime(y, mo, d, h, mi, s)
    if u == "millisecond":
        return _dt.datetime(y, mo, d, h, mi, s, us - us % 1000)
    return _dt.datetime(y, mo, d, h, mi, s, us)


def _f_date_truncate(unit, v):
    return _truncate_temporal(unit, v, allow_sub_day=False).date()


def _f_ldt_truncate(unit, v):
    return _truncate_temporal(unit, v, allow_sub_day=True)


_US_PER_DAY = 86_400 * 1_000_000


def _between_micros(a, b) -> int:
    if isinstance(a, _dt.date) and not isinstance(a, _dt.datetime):
        a = _dt.datetime(a.year, a.month, a.day)
    if isinstance(b, _dt.date) and not isinstance(b, _dt.datetime):
        b = _dt.datetime(b.year, b.month, b.day)
    delta = b - a
    return (delta.days * 86400 + delta.seconds) * 1_000_000 + delta.microseconds


def _f_duration_inmonths(a, b):
    """Whole months between (days/seconds dropped — Neo4j duration.inMonths)."""
    d = _f_duration_between(a, b)
    return Duration(months=d.months, days=0, seconds=0, microseconds=0)


def _f_duration_indays(a, b):
    """Whole days between, no month component (Neo4j duration.inDays)."""
    us = _between_micros(a, b)
    sign = 1 if us >= 0 else -1
    return Duration(months=0, days=sign * (abs(us) // _US_PER_DAY), seconds=0, microseconds=0)


def _f_duration_inseconds(a, b):
    """Exact seconds+microseconds between (Neo4j duration.inSeconds);
    ``Duration`` normalizes the raw microsecond count itself."""
    return Duration(microseconds=_between_micros(a, b))


_register("date", _f_date, T.CTDate, min_args=0, max_args=1)
_register("localdatetime", _f_localdatetime, T.CTLocalDateTime, min_args=0, max_args=1)
_register("datetime", _f_datetime, T.CTDateTime, min_args=0, max_args=1)
_register("time", _f_time, T.CTTime, min_args=0, max_args=1)
_register("localtime", _f_localtime, T.CTLocalTime, min_args=0, max_args=1)
_register("date.truncate", _f_date_truncate, T.CTDate, min_args=2)
_register(
    "localdatetime.truncate", _f_ldt_truncate, T.CTLocalDateTime, min_args=2
)
_register("datetime.truncate", _f_datetime_truncate, T.CTDateTime, min_args=2)
_register("duration", _f_duration, T.CTDuration)
_register("duration.between", _f_duration_between, T.CTDuration, min_args=2)
_register("duration.inmonths", _f_duration_inmonths, T.CTDuration, min_args=2)
_register("duration.indays", _f_duration_indays, T.CTDuration, min_args=2)
_register("duration.inseconds", _f_duration_inseconds, T.CTDuration, min_args=2)


# temporal accessors used via property syntax (d.year, d.month, ...)
TEMPORAL_ACCESSORS: Dict[str, Callable] = {
    "year": lambda d: d.year,
    "month": lambda d: d.month,
    "day": lambda d: d.day,
    "week": lambda d: d.isocalendar()[1],
    "weekyear": lambda d: d.isocalendar()[0],
    "dayofweek": lambda d: d.isoweekday(),
    "ordinalday": lambda d: d.timetuple().tm_yday,
    "quarter": lambda d: (d.month - 1) // 3 + 1,
    "dayofquarter": lambda d: (d - _quarter_start(d)).days + 1,
    "hour": lambda d: d.hour,
    "minute": lambda d: d.minute,
    "second": lambda d: d.second,
    "millisecond": lambda d: d.microsecond // 1000,
    "microsecond": lambda d: d.microsecond,
    # zone accessors (aware datetime/time only — zoneless values raise a
    # typed CypherTypeError, never a raw AttributeError)
    "timezone": lambda d: _zone_name(d),
    "offset": lambda d: _offset_str(d),
    "offsetminutes": lambda d: _offset_total_seconds(d) // 60,
    "offsetseconds": lambda d: _offset_total_seconds(d),
    "epochseconds": lambda d: _epoch_micros(d) // 1_000_000,
    "epochmillis": lambda d: _epoch_micros(d) // 1000,
}


def _offset_total_seconds(d) -> int:
    off = getattr(d, "utcoffset", lambda: None)()
    if off is None:
        raise CypherTypeError(
            f"offset accessor on a zoneless temporal {d!r}"
        )
    return int(off.total_seconds())


def _epoch_micros(d) -> int:
    # aware datetimes ONLY: a naive value's timestamp() would silently
    # read the HOST machine's timezone — nondeterministic across machines
    if not isinstance(d, _dt.datetime) or d.tzinfo is None:
        raise CypherTypeError(
            f"epoch accessor on a non-zoned temporal {d!r}"
        )
    delta = d - _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    return (delta.days * 86400 + delta.seconds) * 1_000_000 + delta.microseconds


def _offset_str(d) -> str:
    from ..api.values import format_utc_offset

    return format_utc_offset(_offset_total_seconds(d))


def _zone_name(d) -> str:
    tz = getattr(d, "tzinfo", None)
    if tz is None:
        raise CypherTypeError("timezone accessor on a zoneless temporal")
    key = getattr(tz, "key", None)  # zoneinfo.ZoneInfo region name
    return key if key is not None else _offset_str(d)

DURATION_ACCESSORS: Dict[str, Callable] = {
    "years": lambda d: d.months // 12,
    "months": lambda d: d.months,
    "monthsofyear": lambda d: d.months % 12,
    "weeks": lambda d: d.days // 7,
    "days": lambda d: d.days,
    "hours": lambda d: d.seconds // 3600,
    "minutes": lambda d: d.seconds // 60,
    "seconds": lambda d: d.seconds,
    "milliseconds": lambda d: d.seconds * 1000 + d.microseconds // 1000,
    "microseconds": lambda d: d.seconds * 1_000_000 + d.microseconds,
}


def _quarter_start(d):
    q_month = 3 * ((d.month - 1) // 3) + 1
    if isinstance(d, _dt.datetime):
        return _dt.datetime(d.year, q_month, 1)
    return _dt.date(d.year, q_month, 1)


# ---------------------------------------------------------------------------
# big decimal
# ---------------------------------------------------------------------------

from decimal import Decimal


def _f_bigdecimal(v, precision=38, scale=18):
    if isinstance(v, bool):
        raise CypherTypeError("bigdecimal() on boolean")
    q = Decimal(str(v)).quantize(Decimal(1).scaleb(-int(scale)))
    return q


_register(
    "bigdecimal",
    _f_bigdecimal,
    lambda args: T.CTBigDecimalType(),
    min_args=1,
    max_args=3,
)


def lookup(name: str) -> FunctionDef:
    f = FUNCTIONS.get(name)
    if f is None:
        raise CypherTypeError(f"Unknown function: {name}")
    return f
