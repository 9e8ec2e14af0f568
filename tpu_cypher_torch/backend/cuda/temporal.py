"""Calendar math for temporal device columns.

The port of ``tpu_cypher/backend/tpu/temporal.py``. A date is int32 days
since 1970-01-01, a localdatetime int64 microseconds since
1970-01-01T00:00, a localtime int64 microseconds since midnight. A zoned
datetime is its int64 UTC microseconds and a zoned time its UNWRAPPED
UTC-adjusted microseconds of day (local minus offset), each with the
column's one offset beside the payload (``column.py``). The civil
calendar fields come from branch-free integer arithmetic over whole
tensors: the era / year-of-era decomposition of the proleptic Gregorian
calendar (Howard Hinnant's public-domain ``civil_from_days``), with
``torch.where`` in place of branches.

Every division here is a FLOOR division (``torch.div(...,
rounding_mode="floor")``) and every remainder ``torch.remainder``, as
Python's ``//`` and ``%`` and the reference's ``jnp.floor_divide`` are:
truncation would put the days and times before 1970 in the wrong day.

The host encoders and decoders turn one Python value into its payload and
back; the tensor functions take and return int64 tensors on any device.
"""

from __future__ import annotations

import datetime as _dt

import torch

EPOCH_ORDINAL = _dt.date(1970, 1, 1).toordinal()
US_PER_SECOND = 1_000_000
US_PER_HOUR = 3600 * US_PER_SECOND
US_PER_DAY = 86_400 * US_PER_SECOND
# the proleptic range Python's datetime holds: years 1 to 9999
MIN_DAYS = _dt.date(1, 1, 1).toordinal() - EPOCH_ORDINAL
MAX_DAYS = _dt.date(9999, 12, 31).toordinal() - EPOCH_ORDINAL


# ---------------------------------------------------------------------------
# host encoders and decoders
# ---------------------------------------------------------------------------


def encode_date(d: _dt.date) -> int:
    return d.toordinal() - EPOCH_ORDINAL


def decode_date(z: int) -> _dt.date:
    return _dt.date.fromordinal(int(z) + EPOCH_ORDINAL)


def encode_ldt(dt: _dt.datetime) -> int:
    days = dt.toordinal() - EPOCH_ORDINAL
    return days * US_PER_DAY + encode_time_of_day(dt)


def decode_ldt(us: int) -> _dt.datetime:
    days, tod = divmod(int(us), US_PER_DAY)
    d = _dt.date.fromordinal(days + EPOCH_ORDINAL)
    t = decode_lt(tod)
    return _dt.datetime(d.year, d.month, d.day, t.hour, t.minute, t.second, t.microsecond)


def offset_seconds_of(v) -> int:
    """The fixed zone offset of an aware datetime or time, in seconds."""
    return int(v.utcoffset().total_seconds())


def offset_str(off_seconds: int) -> str:
    from ...api.values import format_utc_offset

    return format_utc_offset(off_seconds)


def parse_offset_str(s: str) -> int:
    sign = -1 if s.startswith("-") else 1
    parts = s.lstrip("+-").split(":")
    total = int(parts[0]) * 3600 + int(parts[1]) * 60
    if len(parts) > 2:
        total += int(parts[2])
    return sign * total


def column_offset(vocab) -> int:
    """The offset, in seconds, that a ZDT or ZT column's vocab holds."""
    return parse_offset_str((vocab or ["+00:00"])[0])


def encode_zdt(v: _dt.datetime) -> int:
    """Aware datetime -> UTC microseconds since the epoch (the column holds
    the offset)."""
    return encode_ldt(v.replace(tzinfo=None)) - offset_seconds_of(v) * US_PER_SECOND


def decode_zdt(utc_us: int, off_seconds: int) -> _dt.datetime:
    local = decode_ldt(int(utc_us) + off_seconds * US_PER_SECOND)
    return local.replace(tzinfo=_dt.timezone(_dt.timedelta(seconds=off_seconds)))


def encode_time_of_day(t) -> int:
    return (t.hour * 3600 + t.minute * 60 + t.second) * US_PER_SECOND + t.microsecond


def encode_zt(t: _dt.time) -> int:
    """Aware time -> SIGNED unwrapped UTC-adjusted microseconds (local
    minus offset, in (-14 h, 38 h)). Python's aware-time comparison (the
    oracle's) orders and equates zoned times by this value WITHOUT
    wrapping: a lane taken mod 24 h would sort +02:00's 01:00 after 12:00
    and alias 23:00Z with 01:00+02:00. The wrap belongs only to duration
    arithmetic and ``decode_zt``."""
    return encode_time_of_day(t) - offset_seconds_of(t) * US_PER_SECOND


def decode_zt(adj_us: int, off_seconds: int) -> _dt.time:
    local = (int(adj_us) + off_seconds * US_PER_SECOND) % US_PER_DAY
    return decode_lt(local).replace(tzinfo=_dt.timezone(_dt.timedelta(seconds=off_seconds)))


def decode_lt(us: int) -> _dt.time:
    secs, micro = divmod(int(us), US_PER_SECOND)
    h, rem = divmod(secs, 3600)
    m, sec = divmod(rem, 60)
    return _dt.time(h % 24, m, sec, micro)


# ---------------------------------------------------------------------------
# calendar decomposition over tensors
# ---------------------------------------------------------------------------


def fdiv(a, b):
    """Floor division (Python's ``//``) of int64 tensors."""
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z):
    """days since 1970 -> (year, month, day), int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365)  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))  # [0, 365]
    mp = fdiv(5 * doy + 2, 153)  # [0, 11]
    d = doy - fdiv(153 * mp + 2, 5) + 1  # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)  # [1, 12]
    return y + (m <= 2).to(torch.int64), m, d


def days_from_civil(y, m, d):
    """(year, month, day) -> days since 1970 (inverse of ``civil_from_days``)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = fdiv(y, 400)
    yoe = y - era * 400
    doy = fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def is_leap(y):
    return ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) | (
        torch.remainder(y, 400) == 0
    )


def add_duration_micros(us, months, ddays, dmicros):
    """local microseconds + (months, days, microseconds) with the oracle's
    semantics (``eval._add_duration``): the months first, the day clamped
    to the new month's end, then the whole days, then the time remainder.
    Returns (result, the days after the month step): the oracle raises its
    range error at the month step, so a caller bounds both."""
    days, tod = split_ldt(us)
    y, m, d = civil_from_days(days)
    tot = y * 12 + (m - 1) + months
    ny = fdiv(tot, 12)
    nm = torch.remainder(tot, 12) + 1
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int64, device=us.device)[nm - 1]
    dim = dim + ((nm == 2) & is_leap(ny)).to(torch.int64)
    days2 = days_from_civil(ny, nm, torch.minimum(d, dim))
    return (days2 + ddays) * US_PER_DAY + tod + dmicros, days2


def iso_weekday(z):
    """ISO day of the week (Monday 1 .. Sunday 7); day 0 was a Thursday."""
    return torch.remainder(z.to(torch.int64) + 3, 7) + 1


def _ordinal_day(z, y):
    """1-based day of the year."""
    one = torch.ones_like(y)
    return z.to(torch.int64) - days_from_civil(y, one, one) + 1


def _iso_weeks_in_year(y):
    """52 or 53: 53 when Jan 1 or Dec 31 falls on a Thursday."""
    one = torch.ones_like(y)
    jan1 = days_from_civil(y, one, one)
    dec31 = days_from_civil(y, torch.full_like(y, 12), torch.full_like(y, 31))
    return torch.where((iso_weekday(jan1) == 4) | (iso_weekday(dec31) == 4), 53, 52)


def iso_week_and_year(z):
    """(ISO week number, ISO week-based year)."""
    y, _, _ = civil_from_days(z)
    woy = fdiv(_ordinal_day(z, y) - iso_weekday(z) + 10, 7)
    this_weeks = _iso_weeks_in_year(y)
    week = torch.where(woy < 1, _iso_weeks_in_year(y - 1), torch.where(woy > this_weeks, 1, woy))
    year = torch.where(woy < 1, y - 1, torch.where(woy > this_weeks, y + 1, y))
    return week, year


def split_ldt(us):
    """microseconds since the epoch -> (days, microseconds of the day)."""
    us = us.to(torch.int64)
    days = fdiv(us, US_PER_DAY)
    return days, us - days * US_PER_DAY


def date_accessor(key: str, days):
    """One date field over a days tensor as int64, or None when ``key``
    is not a date field (``ir.functions.TEMPORAL_ACCESSORS``)."""
    y, m, d = civil_from_days(days)
    if key == "year":
        return y
    if key == "month":
        return m
    if key == "day":
        return d
    if key == "quarter":
        return fdiv(m - 1, 3) + 1
    if key == "dayofweek":
        return iso_weekday(days)
    if key == "ordinalday":
        return _ordinal_day(days, y)
    if key == "week":
        return iso_week_and_year(days)[0]
    if key == "weekyear":
        return iso_week_and_year(days)[1]
    if key == "dayofquarter":
        qstart = days_from_civil(y, 3 * fdiv(m - 1, 3) + 1, torch.ones_like(y))
        return days.to(torch.int64) - qstart + 1
    return None


def time_accessor(key: str, tod):
    """One time field over microseconds of the day as int64, or None."""
    if key == "hour":
        return fdiv(tod, US_PER_HOUR)
    if key == "minute":
        return torch.remainder(fdiv(tod, 60 * US_PER_SECOND), 60)
    if key == "second":
        return torch.remainder(fdiv(tod, US_PER_SECOND), 60)
    if key == "millisecond":
        return fdiv(torch.remainder(tod, US_PER_SECOND), 1000)
    if key == "microsecond":
        return torch.remainder(tod, US_PER_SECOND)
    return None


SUB_DAY_UNITS = {
    "hour": US_PER_HOUR,
    "minute": 60 * US_PER_SECOND,
    "second": US_PER_SECOND,
    "millisecond": 1000,
    "microsecond": 1,
}
# the year spans of the coarse units: the start of the unit is year
# y - y % span, which for a year below the span is year 0, out of range
_TRUNC_YEARS = {"decade": 10, "century": 100, "millennium": 1000}


def truncate_days(unit: str, days):
    """Truncate days since the epoch to the first day of ``unit`` (a day
    or coarser). Returns (days, first years) — the year each row's unit
    starts in for the decade, century and millennium (year 0 is out of
    range, which the caller checks), else None — or None for a finer
    unit."""
    if unit == "day":
        return days.to(torch.int64), None
    if unit == "week":
        return days.to(torch.int64) - (iso_weekday(days) - 1), None
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(y)
    if unit in _TRUNC_YEARS:
        first = y - torch.remainder(y, _TRUNC_YEARS[unit])
        return days_from_civil(torch.clamp(first, min=1), one, one), first
    if unit == "year":
        return days_from_civil(y, one, one), None
    if unit == "quarter":
        return days_from_civil(y, 3 * fdiv(m - 1, 3) + 1, one), None
    if unit == "month":
        return days_from_civil(y, m, one), None
    return None


def truncate_ldt_micros(unit: str, us):
    """Truncate microseconds since the epoch to the start of ``unit``;
    (micros, first years) as ``truncate_days`` gives them, or None for an
    unknown unit."""
    days, tod = split_ldt(us)
    if unit in SUB_DAY_UNITS:
        return days * US_PER_DAY + (tod - torch.remainder(tod, SUB_DAY_UNITS[unit])), None
    got = truncate_days(unit, days)
    if got is None:
        return None
    return got[0] * US_PER_DAY, got[1]
