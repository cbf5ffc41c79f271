"""Time grids and the trading-hours calendar.

Host-side (non-jitted) helpers: calendars are inherently data-dependent Python,
and their outputs (static step counts, day grids) become *static* shapes for the
jitted pricers downstream.

Reference parity:
- TRADING_HOURS_PER_DAY / compute_trading_hours_remaining: options_model_v1.5.py:14-56
- adaptive step clamp ceil(days) in [10, 130]: options_model_3/options_model_3.py:709
  (v1.5 variant clamp [2, 500]: options_model_v1.5.py:221)
- curve day grid i/intervals_per_day: options_model_3/options_model_3.py:706-708
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Tuple

import numpy as np

TRADING_HOURS_PER_DAY = 6.5  # US equity regular session (9:30 - 16:00)


def compute_trading_hours_remaining(
    expiry_date: datetime.date,
    now: Optional[datetime.datetime] = None,
    market_open: Tuple[int, int] = (9, 30),
    market_close: Tuple[int, int] = (16, 0),
) -> float:
    """Remaining regular-session trading hours from ``now`` until ``expiry_date``.

    Counts business days (Mon-Fri); today contributes a partial session based on
    the current clock, the expiry day a full session. ``now`` is injectable for
    testability (the reference hard-wired datetime.now()).
    """
    if now is None:
        now = datetime.datetime.now()
    if expiry_date < now.date():
        return 0.0

    market_open_time = datetime.time(*market_open)
    market_close_time = datetime.time(*market_close)

    days = np.arange(np.datetime64(now.date(), "D"),
                     np.datetime64(expiry_date, "D") + 1)
    bdays = days[np.is_busday(days, weekmask="1111100", holidays=[])]

    hours = 0.0
    for day in bdays.astype(datetime.date):
        if day == now.date():
            if now.time() >= market_close_time:
                add = 0.0
            elif now.time() <= market_open_time:
                add = TRADING_HOURS_PER_DAY
            else:
                close_dt = datetime.datetime.combine(day, market_close_time)
                add = (close_dt - now).total_seconds() / 3600.0
        else:
            add = TRADING_HOURS_PER_DAY
        hours += add

    return max(0.0, hours)


def adaptive_num_steps(days: float, lo: int = 10, hi: int = 130) -> int:
    """Time-step count for a curve point: clamp(ceil(days), lo, hi)."""
    return int(max(lo, min(hi, math.ceil(days))))


def curve_day_grid(total_points: int, intervals_per_day: int) -> np.ndarray:
    """Days-to-expiry grid for one S0 curve, descending from the far point.

    Point i (i = total_points .. 1) sits at d = i / intervals_per_day days,
    T = d / 365 years.
    """
    i = np.arange(total_points, 0, -1, dtype=np.float64)
    return i / float(intervals_per_day)


def year_fraction(days: float) -> float:
    return days / 365.0


def trading_day_grid(total_hours: float, samples_per_day: int) -> np.ndarray:
    """Fractional trading-day grid from remaining trading hours
    (options_model_v1.5.py:326-331): descending days measured in 6.5h sessions."""
    total_days = total_hours / TRADING_HOURS_PER_DAY
    n = max(1, int(math.ceil(total_days * samples_per_day)))
    i = np.arange(n, 0, -1, dtype=np.float64)
    return i * total_days / n
