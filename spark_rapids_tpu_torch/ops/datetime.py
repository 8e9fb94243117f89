"""Date and timestamp field kernels: the port's copy of the JAX
package's `ops/datetime.py`. Integer arithmetic only (Howard Hinnant's
civil-from-days and days-from-civil); dates are int32 days since
1970-01-01, timestamps int64 microseconds since the epoch, UTC. Every
division floors (`torch.div(..., rounding_mode="floor")`, jnp's `//`),
so a date before 1970 or a timestamp before the epoch falls in the right
day, hour, minute and second.
"""
from __future__ import annotations

import torch

__all__ = ["civil_from_days", "days_from_civil", "year", "month", "day",
           "day_of_week", "day_of_year", "quarter", "hour", "minute",
           "second", "micros_to_days", "days_in_month", "last_day",
           "MICROS_PER_DAY", "MICROS_PER_SEC"]

MICROS_PER_DAY = 86400 * 1_000_000
MICROS_PER_SEC = 1_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days):
    """Days since 1970-01-01 -> (year, month, day), int32."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    """(year, month, day) -> int32 days since 1970-01-01."""
    y, m, d = y.to(torch.int64), m.to(torch.int64), d.to(torch.int64)
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def micros_to_days(micros):
    return _fdiv(micros, MICROS_PER_DAY).to(torch.int32)


def year(days):
    return civil_from_days(days)[0]


def month(days):
    return civil_from_days(days)[1]


def day(days):
    return civil_from_days(days)[2]


def quarter(days):
    return (_fdiv(civil_from_days(days)[1] - 1, 3) + 1).to(torch.int32)


def day_of_week(days):
    """Spark dayofweek: 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""
    dow = torch.remainder(days.to(torch.int64) + 4, 7)
    return (dow + 1).to(torch.int32)


def day_of_year(days):
    y, m, d = civil_from_days(days)
    start = days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    return (days.to(torch.int32) - start + 1).to(torch.int32)


def _is_leap(y):
    return ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)


def days_in_month(y, m):
    base = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                        dtype=torch.int32, device=m.device)
    d = base[(m - 1).clamp(0, 11).to(torch.int64)]
    return torch.where((m == 2) & _is_leap(y), 29, d).to(torch.int32)


def last_day(days):
    y, m, d = civil_from_days(days)
    return (days.to(torch.int32) - d + days_in_month(y, m)).to(torch.int32)


def _time_of_day(micros):
    return micros - micros_to_days(micros).to(torch.int64) * MICROS_PER_DAY


def hour(micros):
    return _fdiv(_time_of_day(micros), 3600 * MICROS_PER_SEC).to(
        torch.int32)


def minute(micros):
    return torch.remainder(_fdiv(_time_of_day(micros), 60 * MICROS_PER_SEC),
                           60).to(torch.int32)


def second(micros):
    return torch.remainder(_fdiv(_time_of_day(micros), MICROS_PER_SEC),
                           60).to(torch.int32)
