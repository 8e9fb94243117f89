"""Time zone database: TZif transition tables for from_utc_timestamp
and to_utc_timestamp.

The port's own copy of the JAX package's `utils/tzdb.py` (which imports
no JAX): the IANA TZif files (RFC 8536) from the system's zoneinfo, or
from the installed `tzdata` package, are parsed on the host, their
64-bit block preferred, and the v2+ POSIX footer extends the rules past
the last stored transition through 2100. `device_tables` gives the
tables as int64 tensors on a device, built once per zone and device; a
conversion is then one `torch.searchsorted` and one gather per batch.

UTC->wall: offset = offs[searchsorted(trans_utc, ts, right) - 1]
wall->UTC: Java/Spark disambiguation (the earlier offset at an overlap,
a shift forward through a gap) falls out of thresholding each transition
at trans[i] + max(off[i-1], off[i]) in wall time.
"""
from __future__ import annotations

import os
import struct
import threading
from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["load_transitions", "utc_to_wall_tables", "wall_to_utc_tables",
           "device_tables"]

_TZPATHS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo",
            "/usr/share/lib/zoneinfo", "/etc/zoneinfo")


def _tzfile(name: str) -> bytes:
    if "/" in name and (name.startswith("/") or ".." in name):
        raise ValueError(f"invalid timezone name: {name}")
    for base in _TZPATHS:
        p = os.path.join(base, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return f.read()
    # fall back to the pip tzdata package (hermetic environments)
    try:
        import importlib.resources as res
        pkg = "tzdata.zoneinfo." + ".".join(name.split("/")[:-1]) \
            if "/" in name else "tzdata.zoneinfo"
        fname = name.split("/")[-1]
        return (res.files(pkg) / fname).read_bytes()
    except Exception:
        raise ValueError(f"unknown timezone: {name!r}")


def _parse_tzif(data: bytes):
    """Parse a TZif file (RFC 8536); prefers the 64-bit v2+ block.
    Returns (trans_unix_seconds int64[n], offsets_seconds int32[n],
    initial_offset_seconds)."""

    def parse_block(buf, off, time_size):
        magic, ver = buf[off:off + 4], buf[off + 4:off + 5]
        if magic != b"TZif":
            raise ValueError("not a TZif file")
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6I", buf[off + 20:off + 44])
        p = off + 44
        fmt = ">%dq" % timecnt if time_size == 8 else ">%di" % timecnt
        trans = np.array(struct.unpack(fmt, buf[p:p + timecnt * time_size]),
                         dtype=np.int64)
        p += timecnt * time_size
        idx = np.frombuffer(buf[p:p + timecnt], dtype=np.uint8)
        p += timecnt
        ttinfo = []
        for i in range(typecnt):
            utoff, isdst, _desig = struct.unpack(
                ">iBB", buf[p + i * 6:p + i * 6 + 6])
            ttinfo.append((utoff, isdst))
        p += typecnt * 6 + charcnt
        # skip leap seconds + std/wall + ut/local indicators
        p += leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return ver, trans, idx, ttinfo, p

    ver, trans, idx, ttinfo, end = parse_block(data, 0, 4)
    footer = b""
    if ver >= b"2":
        # the v2+ 64-bit block immediately follows the v1 block
        ver, trans, idx, ttinfo, end2 = parse_block(data, end, 8)
        # v2/v3 footer: '\n' POSIX-TZ '\n' (RFC 8536 §3.3)
        tail = data[end2:]
        if tail.startswith(b"\n"):
            footer = tail[1:].split(b"\n", 1)[0]
    offs = np.array([ttinfo[i][0] for i in idx], dtype=np.int32) \
        if len(idx) else np.zeros(0, np.int32)
    # initial period: first non-DST type, else type 0 (RFC 8536 §3.2)
    init = 0
    for utoff, isdst in ttinfo:
        if not isdst:
            init = utoff
            break
    else:
        if ttinfo:
            init = ttinfo[0][0]
    trans, offs = _extend_with_posix_rule(trans, offs, footer.decode(
        "ascii", "ignore"))
    return trans, offs, init


# ---------------------------------------------------------------------
# POSIX TZ footer: extends rules past the last stored transition (slim
# zic output stores few explicit transitions and relies on the footer;
# the reference's GpuTimeZoneDB materializes rules to a max year the
# same way).
# ---------------------------------------------------------------------
_MAX_YEAR = 2100


def _parse_posix_offset(s: str, i: int):
    """[+|-]hh[:mm[:ss]] -> (seconds WEST of UTC per POSIX, next index)"""
    sign = 1
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    parts = [0, 0, 0]
    for p in range(3):
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == i:
            break
        parts[p] = int(s[i:j])
        i = j
        if i < len(s) and s[i] == ":":
            i += 1
        else:
            break
    return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2]), i


def _skip_name(s: str, i: int):
    if i < len(s) and s[i] == "<":
        return s.index(">", i) + 1
    while i < len(s) and not (s[i].isdigit() or s[i] in "+-,"):
        i += 1
    return i


def _parse_posix_rule(s: str, i: int):
    """Mm.w.d[/time] or Jn[/time] or n[/time] -> (spec, time_secs, i)"""
    t = 7200  # default 02:00 local
    if s[i] == "M":
        j = i + 1
        nums = []
        while len(nums) < 3:
            k = j
            while k < len(s) and s[k].isdigit():
                k += 1
            nums.append(int(s[j:k]))
            j = k + 1 if k < len(s) and s[k] == "." else k
        spec = ("M", nums[0], nums[1], nums[2])
        i = j
    elif s[i] == "J":
        j = i + 1
        k = j
        while k < len(s) and s[k].isdigit():
            k += 1
        spec = ("J", int(s[j:k]))
        i = k
    else:
        k = i
        while k < len(s) and s[k].isdigit():
            k += 1
        spec = ("n", int(s[i:k]))
        i = k
    if i < len(s) and s[i] == "/":
        t, i = _parse_posix_offset(s, i + 1)
    return spec, t, i


def _rule_day(year: int, spec) -> int:
    """Days since epoch of the rule date in `year` (local calendar)."""
    import datetime as _dt
    if spec[0] == "M":
        _, m, w, d = spec
        first = _dt.date(year, m, 1)
        # day-of-week d (0=Sunday); POSIX week w (5 = last)
        dow_first = (first.weekday() + 1) % 7  # Monday=0 -> Sunday=0 idx
        day = 1 + (d - dow_first) % 7 + (w - 1) * 7
        ndays = ((_dt.date(year + (m == 12), (m % 12) + 1, 1)
                  - first).days)
        while day > ndays:
            day -= 7
        return (first + _dt.timedelta(days=day - 1)
                - _dt.date(1970, 1, 1)).days
    if spec[0] == "J":   # 1-based day, Feb 29 never counted
        n = spec[1]
        leap = (year % 4 == 0 and year % 100 != 0) or year % 400 == 0
        adj = 1 if (leap and n >= 60) else 0
        return (_dt.date(year, 1, 1) - _dt.date(1970, 1, 1)).days \
            + n - 1 + adj
    return (_dt.date(year, 1, 1)
            - _dt.date(1970, 1, 1)).days + spec[1]


def _extend_with_posix_rule(trans, offs, footer: str):
    """Append footer-rule transitions from after the last stored
    transition through _MAX_YEAR."""
    if not footer:
        return trans, offs
    try:
        i = _skip_name(footer, 0)
        std_off, i = _parse_posix_offset(footer, i)
        std = -std_off              # POSIX offsets are west-positive
        if i >= len(footer):        # no DST: constant offset
            return trans, offs
        i = _skip_name(footer, i)
        if i < len(footer) and footer[i] not in ",":
            dst_off, i = _parse_posix_offset(footer, i)
            dst = -dst_off
        else:
            dst = std + 3600
        if i >= len(footer) or footer[i] != ",":
            return trans, offs
        start_spec, start_t, i = _parse_posix_rule(footer, i + 1)
        if i >= len(footer) or footer[i] != ",":
            return trans, offs
        end_spec, end_t, i = _parse_posix_rule(footer, i + 1)
    except Exception:
        return trans, offs
    import datetime as _dt
    last = int(trans[-1]) if len(trans) else 0
    year0 = max(1970, _dt.datetime.fromtimestamp(
        max(last, 0), tz=_dt.timezone.utc).year)
    new_t, new_o = [], []
    for y in range(year0, _MAX_YEAR + 1):
        # DST start: local standard time -> UTC via std offset
        t_start = _rule_day(y, start_spec) * 86400 + start_t - std
        # DST end: local DST time -> UTC via dst offset
        t_end = _rule_day(y, end_spec) * 86400 + end_t - dst
        for t, o in sorted([(t_start, dst), (t_end, std)]):
            if t > last:
                new_t.append(t)
                new_o.append(o)
    if not new_t:
        return trans, offs
    return (np.concatenate([trans, np.array(new_t, np.int64)]),
            np.concatenate([offs, np.array(new_o, np.int32)]))


@lru_cache(maxsize=64)
def load_transitions(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """(trans_utc_micros int64[n+1], offsets_micros int64[n+1]) with a
    sentinel first row covering times before the first transition."""
    if tz in ("UTC", "Z", "GMT", "Etc/UTC", "Etc/GMT"):
        return (np.array([np.iinfo(np.int64).min], np.int64),
                np.zeros(1, np.int64))
    trans, offs, init = _parse_tzif(_tzfile(tz))
    t = np.concatenate([[np.iinfo(np.int64).min // 2], trans * 1_000_000])
    o = np.concatenate([[init], offs.astype(np.int64)]) * 1_000_000
    return t.astype(np.int64), o.astype(np.int64)


@lru_cache(maxsize=64)
def utc_to_wall_tables(tz: str):
    return load_transitions(tz)


@lru_cache(maxsize=64)
def wall_to_utc_tables(tz: str):
    """Thresholds in WALL time: trans[i] + max(off[i-1], off[i]) gives
    Java's earlier-offset-at-overlap / shift-through-gap semantics."""
    t, o = load_transitions(tz)
    if len(t) == 1:
        return t, o
    prev = np.concatenate([[o[0]], o[:-1]])
    thresh = t + np.maximum(prev, o)
    thresh[0] = t[0]
    # enforce monotonicity (pathological zones)
    thresh = np.maximum.accumulate(thresh)
    return thresh.astype(np.int64), o


_DEVICE_TABLES = {}
_DEVICE_LOCK = threading.Lock()


def device_tables(tz: str, to_utc: bool, device):
    """(thresholds, offsets) of `tz` as int64 tensors on `device`: the
    UTC->wall tables, or the wall->UTC ones with `to_utc`. Built once
    per zone, direction and device."""
    import torch
    key = (tz, bool(to_utc), str(device))
    with _DEVICE_LOCK:
        hit = _DEVICE_TABLES.get(key)
        if hit is None:
            t, o = (wall_to_utc_tables if to_utc else utc_to_wall_tables)(tz)
            hit = (torch.from_numpy(np.ascontiguousarray(t)).to(device),
                   torch.from_numpy(np.ascontiguousarray(o)).to(device))
            _DEVICE_TABLES[key] = hit
    return hit
