"""The date and time functions of the port against the JAX package on
the CPU: year, month, dayofmonth, dayofweek, dayofyear, quarter of dates
and timestamps, hour, minute, second, date_add, date_sub, datediff,
last_day, to_date and to_timestamp, over seeded dates from year 1 to
9999 (before 1970 and past 2038 included, leap days and month ends) and
timestamps before and after the epoch, with nulls. Exact. The fields
are also held to Python's `datetime` on the same values, and the
kernels of `ops/datetime.py` over the whole range of days one by one
against the JAX kernels.
"""
import datetime as dtm

import numpy as np
import pyarrow as pa
import pytest

from torch_parity import assert_same, project

N = 120
EPOCH = dtm.date(1970, 1, 1)


def _data(seed=41):
    rng = np.random.default_rng(seed)
    days = rng.integers(-719162, 2932896, N).astype(np.int32)
    edges = [(1, 1, 1), (9999, 12, 31), (1969, 12, 31), (1970, 1, 1),
             (2038, 1, 19), (2038, 1, 20), (2000, 2, 29), (1900, 2, 28),
             (1900, 3, 1), (2024, 12, 31), (1600, 2, 29), (1582, 10, 4)]
    days[:len(edges)] = [(dtm.date(*e) - EPOCH).days for e in edges]
    ts = rng.integers(-62135596800 * 10 ** 6, 253402300799 * 10 ** 6, N)
    ts[:6] = [-1, 0, 1, -86400 * 10 ** 6, -86400 * 10 ** 6 + 1,
              2 ** 31 * 10 ** 6]
    delta = rng.integers(-100000, 100000, N).astype(np.int32)
    nul = rng.random(N) < 0.1
    nul[:12] = False
    strs = [dtm.date.fromordinal(int(d) + EPOCH.toordinal()).isoformat()
            for d in days]
    return {
        "d": pa.array(days, pa.int32(), mask=nul).cast(pa.date32()),
        "e": pa.array(np.roll(days, 7), pa.int32()).cast(pa.date32()),
        "t": pa.array(ts, pa.timestamp("us", tz="UTC"), mask=nul),
        "k": pa.array(delta),
        "s": pa.array(strs[:N // 2] + [
            s + " 12:34:56" for s in strs[N // 2:]], mask=nul),
    }


FIELDS = ("year", "month", "dayofmonth", "dayofweek", "dayofyear",
          "quarter")


def _exprs(F):
    # a date result as its days since 1970: a date outside years 1..9999
    # (date_add and date_sub there) with nulls beside it breaks the JAX
    # package's Arrow conversion, which goes through Python dates
    # (ROADMAP C.2)
    def days(e):
        return F.datediff(e, F.lit(EPOCH))
    out = [getattr(F, fn)(c) for fn in FIELDS for c in ("d", "t")]
    out += [F.hour("t"), F.minute("t"), F.second("t"),
            F.datediff("d", "e"), F.to_timestamp("d"), F.to_timestamp("s"),
            F.to_timestamp("t")]
    out += [days(e) for e in (
        F.date_add("d", "k"), F.date_sub("d", F.lit(30)),
        F.date_add("e", F.lit(-1)), F.last_day("d"), F.last_day("e"),
        F.to_date("t"), F.to_date("s"), F.to_date("d"))]
    return out


def test_date_functions():
    jt, ptab = project(_data(), _exprs)
    assert_same(jt, ptab, "date functions")


def test_fields_equal_python():
    data = _data()
    _, ptab = project(data, lambda F: [getattr(F, fn)("d")
                                       for fn in FIELDS])
    for d, *got in zip(data["d"].to_pylist(),
                       *[ptab.column(i).to_pylist()
                         for i in range(len(FIELDS))]):
        if d is None:
            assert got == [None] * len(FIELDS)
            continue
        want = [d.year, d.month, d.day, d.isoweekday() % 7 + 1,
                d.timetuple().tm_yday, (d.month - 1) // 3 + 1]
        assert got == want, d


def test_kernels_over_every_day():
    """civil_from_days, days_from_civil, last_day and day_of_week of
    every day of years 1..9999 against the JAX kernels."""
    import jax
    import jax.numpy as jnp
    import torch
    from spark_rapids_tpu.ops import datetime as jd
    from spark_rapids_tpu_torch.ops import datetime as pd
    days = np.arange(-719162, 2932897, dtype=np.int32)
    jy, jm, jday = jax.jit(jd.civil_from_days)(jnp.asarray(days))
    py, pm, pday = pd.civil_from_days(torch.from_numpy(days))
    for j, p in ((jy, py), (jm, pm), (jday, pday)):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())
    back = pd.days_from_civil(py, pm, pday)
    np.testing.assert_array_equal(back.numpy(), days)
    for fn in ("last_day", "day_of_week", "day_of_year", "quarter"):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(getattr(jd, fn))(jnp.asarray(days))),
            getattr(pd, fn)(torch.from_numpy(days)).numpy(), fn)


@pytest.mark.parametrize("micros", [
    -1, 0, 1, -86400 * 10 ** 6, -3600 * 10 ** 6 - 1, 59 * 10 ** 6 + 999999,
    -62135596800 * 10 ** 6, 253402300799 * 10 ** 6 + 999999])
def test_time_fields_floor_before_the_epoch(micros):
    """hour, minute and second floor toward negative infinity: one
    microsecond before 1970 is 23:59:59 of the day before."""
    data = {"t": pa.array([micros], pa.timestamp("us", tz="UTC"))}
    jt, ptab = project(data, lambda F: [F.hour("t"), F.minute("t"),
                                        F.second("t"), F.to_date("t")])
    assert_same(jt, ptab, "time fields")
    when = dtm.datetime(1970, 1, 1) + dtm.timedelta(microseconds=micros)
    assert [ptab.column(i)[0].as_py() for i in range(3)] == \
        [when.hour, when.minute, when.second]
