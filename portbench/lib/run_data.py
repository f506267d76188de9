"""What one run of a cell leaves for the metric readers: the clients' ready
messages and reports, and the window's times, all on the monotonic clock
that every process of the machine shares."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

from . import window


@dataclass
class Run:
    cell: dict
    seed: int
    seconds: float
    t_start: float
    t_run: float
    ready: list[dict]
    reports: list[dict]

    @property
    def t_end(self) -> float:
        return self.t_start + self.seconds

    # ---- the engine's stage spans -----------------------------------------

    def stage_seconds(self, names: tuple[str, ...]) -> tuple[float, int] | None:
        """Seconds spent in the engine's stages ``names`` and the number of
        spans of the first name, over every client, from the window's start
        to the start of its profile (the profiler slows the host), or to
        the window's end when it ran none; None without spans."""
        if not all("spans" in r for r in self.reports):
            return None
        total, count = 0.0, 0
        for r in self.reports:
            stop = r["profile"]["start"] if "profile" in r else self.t_end
            for name, t0, t1 in r["spans"]:
                if name in names and t0 >= self.t_start and t1 <= stop:
                    total += t1 - t0
                    count += name == names[0]
        return total, count

    # ---- the device trace ---------------------------------------------------

    def profiles(self) -> list[dict]:
        """The clients' profiles that hold device events."""
        return [r["profile"] for r in self.reports if r.get("profile", {}).get("events")]

    def profile_window(self) -> tuple[float, float] | None:
        """The stretch in which every client's profiler ran."""
        profs = self.profiles()
        if not profs or len(profs) != len(self.reports):
            return None
        a, b = max(p["start"] for p in profs), min(p["stop"] for p in profs)
        return (a, b) if b > a else None

    def device_intervals(self) -> list[tuple[float, float]]:
        return [iv for p in self.profiles() for iv in zip(p["events"]["start"].tolist(),
                                                          p["events"]["end"].tolist())]

    def device_busy(self) -> tuple[float, float] | None:
        """(busy_s, window_s): seconds of the common profile window in which
        an operation of any client ran on the card, and its length."""
        win = self.profile_window()
        if win is None:
            return None
        return window.union_length(self.device_intervals(), *win), win[1] - win[0]

    def kernel_calls(self, pattern) -> list[tuple[list, int, float]]:
        """Per profiled client: (its shape log, the number of its device
        events whose name matches ``pattern``, their summed seconds)."""
        out = []
        for p in self.profiles():
            ev = p["events"]
            match = [i for i, n in enumerate(ev["names"]) if pattern.search(n)]
            sel = [j for j, i in enumerate(ev["name_idx"].tolist()) if i in match]
            dur = float(sum(ev["end"][sel] - ev["start"][sel])) if sel else 0.0
            out.append((p["shapes"], len(sel), dur))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, summed over clients,
        and the longest idle stretches of the card by the engine stage each
        client's host was in (an idle second shared evenly among them)."""
        ops: dict[str, float] = defaultdict(float)
        for p in self.profiles():
            ev = p["events"]
            for i, a, b in zip(ev["name_idx"].tolist(), ev["start"].tolist(), ev["end"].tolist()):
                ops[ev["names"][i][:100]] += b - a
        idle: dict[str, float] = defaultdict(float)
        win = self.profile_window()
        if win is not None and all("spans" in r for r in self.reports):
            spans = [sorted(r["spans"], key=lambda s: s[1]) for r in self.reports]
            starts = [[s[1] for s in sp] for sp in spans]
            for a, b in window.gaps(self.device_intervals(), *win):
                mid = (a + b) / 2
                for sp, st in zip(spans, starts):
                    i = bisect.bisect_right(st, mid) - 1
                    name = sp[i][0] if i >= 0 and sp[i][2] >= mid else "other"
                    idle[f"engine.{name}"] += (b - a) / len(spans)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
