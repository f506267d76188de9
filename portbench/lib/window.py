"""Arithmetic of the measured window: work pro-rated at its two ends, and
the union of device intervals."""

from __future__ import annotations

import bisect


def decided_at(points: list[tuple[float, float]], t: float) -> float:
    """Cumulative frames decided at time ``t``: ``points`` are (time,
    cumulative count) in time order, one per checkpoint call of the engine,
    joined by straight lines; before the first point the first count holds,
    after the last the last."""
    if not points:
        return 0.0
    times = [p[0] for p in points]
    i = bisect.bisect_right(times, t)
    if i == 0:
        return float(points[0][1])
    if i == len(points):
        return float(points[-1][1])
    (t0, c0), (t1, c1) = points[i - 1], points[i]
    if t1 <= t0:
        return float(c1)
    return c0 + (c1 - c0) * (t - t0) / (t1 - t0)


def decided_in(points: list[tuple[float, float]], start: float, end: float) -> float:
    """Frames decided inside [start, end]: a batch that straddles either end
    counts only the share of its frames that falls inside."""
    return decided_at(points, end) - decided_at(points, start)


def union_length(intervals: list[tuple[float, float]], start: float, end: float) -> float:
    """Length of the union of the intervals, clipped to [start, end]."""
    busy, reach = 0.0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            busy += b - a
            reach = b
    return busy


def gaps(intervals: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, reach = [], start
    for a, b in sorted(intervals):
        if a > reach and reach < end:
            out.append((reach, min(a, end)))
        reach = max(reach, b)
    if reach < end:
        out.append((reach, end))
    return out
