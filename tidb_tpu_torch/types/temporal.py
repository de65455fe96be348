# ported from tidb_tpu/types/temporal.py @ a9e9482
"""Temporal type encoding/decoding (host side).

Device encodings are epoch-relative integers: DATE = days since
1970-01-01, DATETIME = microseconds since the epoch.  This copy holds the
host conversions that literals and results need; the lane helpers that
decompose dates on the device arrive with the temporal-function slice
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import datetime as _dt

EPOCH = _dt.date(1970, 1, 1)
MICROS_PER_SEC = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SEC


def date_to_days(y: int, m: int, d: int) -> int:
    return (_dt.date(y, m, d) - EPOCH).days


def parse_date(s: str) -> int:
    s = s.strip()
    y, m, d = s.split("-")
    return date_to_days(int(y), int(m), int(d))


def days_to_date(days: int) -> _dt.date:
    return EPOCH + _dt.timedelta(days=int(days))


def date_to_string(days: int) -> str:
    return days_to_date(days).isoformat()


def parse_datetime(s: str) -> int:
    s = s.strip()
    if " " in s or "T" in s:
        sep = " " if " " in s else "T"
        dpart, tpart = s.split(sep, 1)
    else:
        dpart, tpart = s, "00:00:00"
    days = parse_date(dpart)
    parts = tpart.split(":")
    h = int(parts[0])
    mi = int(parts[1]) if len(parts) > 1 else 0
    sec = parts[2] if len(parts) > 2 else "0"
    if "." in sec:
        sp, fp = sec.split(".")
        micros = int((fp + "000000")[:6])
        s_int = int(sp)
    else:
        micros, s_int = 0, int(sec)
    return (days * MICROS_PER_DAY
            + ((h * 60 + mi) * 60 + s_int) * MICROS_PER_SEC + micros)


def datetime_to_string(micros: int) -> str:
    micros = int(micros)
    days, rem = divmod(micros, MICROS_PER_DAY)
    d = days_to_date(days)
    sec, us = divmod(rem, MICROS_PER_SEC)
    h, rem2 = divmod(sec, 3600)
    mi, s = divmod(rem2, 60)
    base = f"{d.isoformat()} {h:02d}:{mi:02d}:{s:02d}"
    return f"{base}.{us:06d}" if us else base


__all__ = ["EPOCH", "MICROS_PER_SEC", "MICROS_PER_DAY", "date_to_days",
           "parse_date", "days_to_date", "date_to_string", "parse_datetime",
           "datetime_to_string"]
