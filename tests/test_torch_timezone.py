"""from_utc_timestamp / to_utc_timestamp in the port, mirroring
`tests/test_timezone.py`'s cases: against Python's `zoneinfo` (the same
IANA data) and against the JAX package on the CPU, exact. Java's
disambiguation at an overlap (the earlier offset) and through a gap
(shifted forward), the POSIX footer's rules past the last stored
transition, years before 1970, an unknown zone refused at bind, and the
port's `utils/tzdb.py` tables equal to the JAX module's.
"""
import datetime as dtm
from zoneinfo import ZoneInfo

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr
from torch_parity import assert_same, project

UTC = ZoneInfo("UTC")
CASES = [
    dtm.datetime(2020, 1, 15, 12, 0, 0),
    dtm.datetime(2020, 7, 15, 12, 0, 0),
    dtm.datetime(2020, 3, 8, 6, 59, 59),   # just before spring forward
    dtm.datetime(2020, 3, 8, 7, 0, 0),     # at spring forward
    dtm.datetime(2020, 11, 1, 5, 59, 59),  # just before fall back
    dtm.datetime(2020, 11, 1, 6, 0, 0),    # at fall back
    dtm.datetime(1950, 6, 1, 0, 0, 0),     # pre-epoch rules
    dtm.datetime(2035, 6, 1, 0, 0, 0),     # POSIX-rule future era
    dtm.datetime(1969, 12, 31, 23, 59, 59),
    dtm.datetime(2090, 11, 5, 9, 30, 0),
]
TS_US = [int(c.replace(tzinfo=UTC).timestamp() * 10 ** 6) for c in CASES]
ZONES = ["America/New_York", "Asia/Kolkata", "Australia/Sydney",
         "Europe/Paris", "America/Sao_Paulo", "America/Los_Angeles", "UTC"]


def _wall(ts_us: int, tz: str) -> int:
    d = dtm.datetime(1970, 1, 1, tzinfo=UTC) + dtm.timedelta(
        microseconds=ts_us)
    off = d.astimezone(ZoneInfo(tz)).utcoffset()
    return ts_us + (off.days * 86400 + off.seconds) * 10 ** 6


def _ts(values):
    return pa.array(values, pa.timestamp("us", tz="UTC"))


@pytest.mark.parametrize("tz", ZONES)
def test_from_utc_timestamp(tz):
    rng = np.random.default_rng(len(tz))
    extra = [int(x) for x in rng.integers(-10 ** 15, 4 * 10 ** 15, 30)]
    ts = TS_US + extra
    jt, ptab = project({"t": _ts(ts)}, lambda F: [
        F.from_utc_timestamp("t", tz),
        F.to_utc_timestamp(F.from_utc_timestamp("t", tz), tz)])
    assert_same(jt, ptab, tz)
    got = ptab.column(0).cast(pa.int64()).to_pylist()
    assert got == [_wall(t, tz) for t in ts]


def test_to_utc_round_trip_unambiguous():
    tz = "America/New_York"
    ts = [t for i, t in enumerate(TS_US) if i != 5]
    _, ptab = project({"t": _ts(ts)}, lambda F: [F.to_utc_timestamp(
        F.from_utc_timestamp("t", tz), tz)])
    assert ptab.column(0).cast(pa.int64()).to_pylist() == ts


@pytest.mark.parametrize("wall,want", [
    # ambiguous 01:30 at the fall back: the earlier offset (EDT)
    ((2020, 11, 1, 1, 30), (2020, 11, 1, 5, 30)),
    # nonexistent 02:30 at the spring forward: shifted forward (EST)
    ((2020, 3, 8, 2, 30), (2020, 3, 8, 7, 30))])
def test_to_utc_overlap_and_gap(wall, want):
    us = int(dtm.datetime(*wall, tzinfo=UTC).timestamp() * 10 ** 6)
    jt, ptab = project({"t": _ts([us])}, lambda F: [
        F.to_utc_timestamp("t", "America/New_York")])
    assert_same(jt, ptab, "overlap / gap")
    assert ptab.column(0).cast(pa.int64())[0].as_py() == int(
        dtm.datetime(*want, tzinfo=UTC).timestamp() * 10 ** 6)


def test_unknown_timezone_rejected():
    s = pt.TpuSession({}, device="cpu")
    with pytest.raises(UnsupportedExpr, match="[Tt]imezone"):
        s.create_dataframe({"t": _ts(TS_US[:1])}).select(
            PF.from_utc_timestamp("t", "Not/AZone").alias("w")).to_arrow()


def test_tables_equal_the_jax_module():
    from spark_rapids_tpu.utils import tzdb as jtz
    from spark_rapids_tpu_torch.utils import tzdb as ptz
    for tz in ZONES + ["Europe/London", "Pacific/Chatham"]:
        for fn in ("load_transitions", "wall_to_utc_tables"):
            for j, p in zip(getattr(jtz, fn)(tz), getattr(ptz, fn)(tz)):
                np.testing.assert_array_equal(j, p)
        t, o = ptz.device_tables(tz, True, "cpu")
        np.testing.assert_array_equal(t.numpy(), jtz.wall_to_utc_tables(
            tz)[0])


def test_posix_footer_future_era():
    from spark_rapids_tpu_torch.utils import tzdb
    for tz in ("America/New_York", "Australia/Sydney", "Europe/Paris"):
        t, o = tzdb.load_transitions(tz)
        for y in (2045, 2090):
            for m in (1, 4, 7, 11):
                ts = int(dtm.datetime(y, m, 15, 12, tzinfo=UTC)
                         .timestamp() * 10 ** 6)
                idx = np.searchsorted(t, ts, side="right") - 1
                want = int(dtm.datetime.fromtimestamp(
                    ts / 1e6, tz=ZoneInfo(tz)).utcoffset()
                    .total_seconds() * 10 ** 6)
                assert int(o[max(idx, 0)]) == want, (tz, y, m)
