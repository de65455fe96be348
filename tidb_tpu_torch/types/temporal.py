# ported from tidb_tpu/types/temporal.py @ 9d319cb
"""Temporal type encoding/decoding.

Reference analog: pkg/types/time.go (core time types Time/Duration).  Device
encodings are epoch-relative integers (DATE = int32 days, DATETIME = int64
microseconds, TIME = int64 signed microseconds) so temporal predicates and
EXTRACT compile to integer arithmetic on the VPU.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

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
    h = int(parts[0]); mi = int(parts[1]) if len(parts) > 1 else 0
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


# --- vectorized calendar decomposition (host precompute for device LUTs) --- #

def civil_from_days(xp, days):
    """Vectorized civil-from-days (Howard Hinnant's algorithm) in an array
    namespace `xp` (numpy or jax.numpy) — shared by host decoding and the
    device expression compiler (expr/compile.py year/month/dayofmonth)."""
    z = (days.astype(xp.int64) if hasattr(days, "astype") else days) + 719468
    era = xp.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(xp, y, m, d):
    """Vectorized days-from-civil (inverse of civil_from_days), same
    algorithm family — used by device DATE_ADD month arithmetic."""
    y = y - (m <= 2)
    era = xp.floor_divide(y, 400)
    yoe = y - era * 400
    mp = xp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def is_leap(xp, y):
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=np.int64)


def days_in_month(xp, y, m):
    """Vectorized month length (for DATE_ADD day clamping / LAST_DAY)."""
    base = xp.asarray(_MONTH_DAYS)[xp.clip(m - 1, 0, 11)]
    return base + (is_leap(xp, y) & (m == 2))


def year_month_day_np(days: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    y, m, d = civil_from_days(np, days)
    return y.astype(np.int64), m.astype(np.int64), d.astype(np.int64)


__all__ = [
    "EPOCH", "MICROS_PER_SEC", "MICROS_PER_DAY",
    "date_to_days", "parse_date", "days_to_date", "date_to_string",
    "parse_datetime", "datetime_to_string", "year_month_day_np",
]


def duration_to_string(micros: int) -> str:
    """TIME text: '[-]H:MM:SS[.ffffff]' (types/duration String analog)."""
    sign = "-" if micros < 0 else ""
    us = abs(int(micros))
    s, frac = divmod(us, 1_000_000)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    out = f"{sign}{h:02d}:{m:02d}:{sec:02d}"
    if frac:
        out += f".{frac:06d}".rstrip("0")
    return out


def days_from_civil(xp, y, m, d):
    """Vectorized days-since-epoch from (y, m, d) — the inverse of
    civil_from_days (Howard Hinnant's algorithm), shared by the device
    expression compiler's numeric->DATETIME cast."""
    y = y - (m <= 2)
    era = xp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + xp.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def parse_time(s: str):
    """'[-][D ]HH:MM:SS[.frac]' / 'HH:MM' / bare digits ([H]H[MM][SS])
    -> signed micros, or None (MySQL abbreviated-TIME rules:
    '11:12' = 11:12:00; digits group from the right as [H]HMMSS)."""
    txt = s.strip()
    neg = txt.startswith("-")
    if neg:
        txt = txt[1:]
    try:
        if ":" in txt:
            parts = txt.split(":")
            if len(parts) == 3:
                h, m = int(parts[0]), int(parts[1])
                sec = float(parts[2])
            elif len(parts) == 2:
                # MySQL: 'HH:MM' means HH:MM:00, NOT MM:SS
                h, m, sec = int(parts[0]), int(parts[1]), 0.0
            else:
                return None
        else:
            v = float(txt)
            iv = int(v)
            frac = v - iv
            sec = iv % 100 + frac
            m = iv // 100 % 100
            h = iv // 10_000
        if m >= 60 or sec >= 60:
            return None
        us = int(round((h * 3600 + m * 60 + sec) * 1e6))
        return -us if neg else us
    except ValueError:
        return None
