"""Bind-time timezone compilation for the ``*Local`` date expressions.

The port's own copy of ``supersonic_tpu/exprs/tz.py`` (importing that
module would import JAX).  Reference semantics: the ``*Local`` operators
(YearLocal .. SecondLocal, DateFormatLocal) call ``localtime_r``, i.e.
they render in the process's local timezone, selected by the TZ
environment variable (reference: expression/core/date_evaluators.cc:
204-210, 249-265).

A timezone is compiled at bind time into day-granular LUTs from the IANA
tzdata (Python ``zoneinfo`` reads the same /usr/share/zoneinfo database
glibc's localtime_r uses), and the local shift on the device is one 3-lane
int32 ``lut_gather`` plus a select:

    local_us(us)   = us + utc_offset(us) * 1_000_000
    utc_offset(us) = off_after[day]  if us_in_day >= switch_sec[day] * 1e6
                     off_before[day] otherwise

POSIX defines localtime exactly so (gmtime of ``t + utcoff(t)``), so every
UTC field and format operator applied to ``local_us`` reproduces
localtime_r.  The LUT spans the 32-bit time_t range the reference can
represent (65536 days: 1901-12-13 .. 2081-05-29); days outside clamp to
the edge rule.  At most one UTC-offset change per civil day is supported,
which holds for the whole tzdata database.  A zone that cannot be loaded
(no tzdata on the machine) raises at ``set_local_timezone``.
"""
from __future__ import annotations

import datetime
import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

US_PER_SEC = 1_000_000
US_PER_DAY = 86_400 * US_PER_SEC
SEC_PER_DAY = 86_400

# full signed 32-bit time_t coverage, 65536 days: day -24855 is 1901-12-13
DAY0 = -24855
NDAYS = 65536


class TzTables(NamedTuple):
    """Compiled timezone: per-day offset rule (host numpy arrays)."""

    name: str
    off_before: np.ndarray  # int32 [NDAYS] seconds east of UTC at day start
    off_after: np.ndarray   # int32 [NDAYS] seconds after the day's switch
    switch_sec: np.ndarray  # int32 [NDAYS] second of the day of the switch
    #                         (SEC_PER_DAY when the day has no transition)


_local_tz_name: Optional[str] = None  # None -> TZ env var, else "UTC"
# zone name -> its three LUT lanes, each uploaded once a device
_bound_luts: dict = {}


def set_local_timezone(name: Optional[str]) -> None:
    """Select the timezone the ``*Local`` expressions bind against (None
    restores the default: the TZ environment variable, else UTC, the
    reference's localtime_r contract)."""
    global _local_tz_name
    if name is not None:
        _compile(name)  # validate eagerly
    _local_tz_name = name


def get_local_timezone() -> str:
    if _local_tz_name is not None:
        return _local_tz_name
    return os.environ.get("TZ") or "UTC"


def _offset_at(tz, ts: int) -> int:
    dt = datetime.datetime.fromtimestamp(ts, tz)
    return int(dt.utcoffset().total_seconds())


@functools.lru_cache(maxsize=8)
def _compile(name: str) -> Optional[TzTables]:
    """Compile tzdata into per-day LUTs; None for fixed-zero zones."""
    import zoneinfo

    if name.upper() in ("UTC", "GMT", "UTC0", "GMT0"):
        return None
    tz = zoneinfo.ZoneInfo(name)
    # UTC offset at the start of each LUT day (+1 for the final boundary)
    starts = (np.arange(DAY0, DAY0 + NDAYS + 1, dtype=np.int64)
              * SEC_PER_DAY)
    offs = np.fromiter((_offset_at(tz, int(t)) for t in starts),
                       dtype=np.int64, count=NDAYS + 1)
    if not offs.any():
        return None  # a fixed-zero alias (Etc/UTC, ...)
    off_before = offs[:-1].astype(np.int32)
    off_after = off_before.copy()
    switch_sec = np.full(NDAYS, SEC_PER_DAY, dtype=np.int32)
    for i in np.nonzero(offs[:-1] != offs[1:])[0]:
        # binary-search the transition instant within day i (1 s grain;
        # tzdata transitions are whole seconds)
        lo, hi = int(starts[i]), int(starts[i + 1])
        pre = int(offs[i])
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if _offset_at(tz, mid) == pre:
                lo = mid
            else:
                hi = mid
        if _offset_at(tz, hi) != int(offs[i + 1]):
            raise ValueError(
                f"timezone {name}: more than one UTC-offset transition "
                f"in day {DAY0 + i} — unsupported")
        off_after[i] = np.int32(offs[i + 1])
        switch_sec[i] = np.int32(hi - int(starts[i]))
    return TzTables(name, off_before, off_after, switch_sec)


def current_tables() -> Optional[TzTables]:
    """The compiled timezone the next ``*Local`` bind captures (None is
    UTC: the Local op is the plain UTC op).  An unresolvable TZ
    environment value (a raw POSIX rule string, which zoneinfo does not
    parse) falls back to UTC; a zone set explicitly raises."""
    try:
        return _compile(get_local_timezone())
    except Exception:
        if _local_tz_name is not None:
            raise
        return None


def _luts(tzt: TzTables, device) -> list:
    """The zone's three LUT lanes on ``device``, uploaded once."""
    from ..kernels.lut_gather import BoundLut

    lanes = _bound_luts.get(tzt.name)
    if lanes is None:
        lanes = _bound_luts[tzt.name] = [
            BoundLut(a) for a in (tzt.off_before, tzt.off_after,
                                  tzt.switch_sec)]
    return [lane.on(device) for lane in lanes]


def local_shift(us: torch.Tensor, tzt: TzTables) -> torch.Tensor:
    """UTC microseconds -> local-civil microseconds on the device: one
    3-lane ``lut_gather`` over the day LUT and a select."""
    from ..batch import gather_arrays

    us = us.to(torch.int64)
    day = torch.div(us, US_PER_DAY, rounding_mode="floor")
    idx = (day - DAY0).clamp(0, NDAYS - 1).to(torch.int32)
    ob, oa, sw = gather_arrays(_luts(tzt, us.device), idx)
    us_in_day = us - day * US_PER_DAY
    off = torch.where(us_in_day >= sw.to(torch.int64) * US_PER_SEC, oa, ob)
    return us + off.to(torch.int64) * US_PER_SEC


def local_shift_host(us: int, tzt: Optional[TzTables]) -> int:
    """Host mirror of local_shift (differential tests, host fallbacks)."""
    if tzt is None:
        return int(us)
    day = us // US_PER_DAY
    i = min(max(day - DAY0, 0), NDAYS - 1)
    sec = (us - day * US_PER_DAY) // US_PER_SEC
    off = (int(tzt.off_after[i]) if sec >= int(tzt.switch_sec[i])
           else int(tzt.off_before[i]))
    return int(us) + off * US_PER_SEC
