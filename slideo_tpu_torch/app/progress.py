"""Progress reporting: a terminal bar and composition over nested tasks.

Port of ``slideo_tpu/app/progress.py`` (reference crates/app/src/
progress.rs and crates/matching/src/progress.rs): a ProgressReporter is a
callback ``report(processed, total, msg)``; TerminalProgress draws one bar
on stderr; ComposedProgressReporter sums N nested (processed, total) pairs
into one parent report for multi-video runs (progress.rs:5-36).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable

__all__ = ["ProgressReporter", "TerminalProgress", "ComposedProgressReporter", "null_reporter"]

ProgressReporter = Callable[[int, int, str], None]


def null_reporter(processed: int, total: int, msg: str) -> None:  # noqa: ARG001
    return None


class TerminalProgress:
    """One terminal bar: ``[elapsed] [####----] pos/len msg`` (progress.rs:42-70)."""

    def __init__(self, stream=None, min_interval_s: float = 0.1):
        self.stream = stream or sys.stderr
        self.start = time.time()
        self._last = 0.0
        self._min_interval = min_interval_s
        self._lock = threading.Lock()
        self._done = False

    def get_reporter(self) -> ProgressReporter:
        return self.report

    def report(self, processed: int, total: int, msg: str) -> None:
        now = time.time()
        with self._lock:
            if self._done or (now - self._last < self._min_interval and processed < total):
                return
            self._last = now
            elapsed = int(now - self.start)
            width = 30
            frac = processed / total if total else 0.0
            filled = int(width * min(frac, 1.0))
            bar = "#" * filled + "-" * (width - filled)
            line = f"\r[{elapsed // 60:02d}:{elapsed % 60:02d}] [{bar}] {processed}/{total} {msg}"
            self.stream.write(line[:120].ljust(120))
            self.stream.flush()

    def finish(self) -> None:
        with self._lock:
            if not self._done:
                self.stream.write("\n")
                self.stream.flush()
                self._done = True


class ComposedProgressReporter:
    """Sums (processed, total) across nested reporters into one parent bar."""

    def __init__(self, parent: ProgressReporter):
        self.parent = parent
        self._lock = threading.Lock()
        self._parts: list[tuple[int, int]] = []

    def create_nested(self) -> ProgressReporter:
        with self._lock:
            idx = len(self._parts)
            self._parts.append((0, 0))

        def report(processed: int, total: int, msg: str) -> None:
            with self._lock:
                self._parts[idx] = (processed, total)
                p = sum(x for x, _ in self._parts)
                t = sum(y for _, y in self._parts)
            self.parent(p, t, msg)

        return report
