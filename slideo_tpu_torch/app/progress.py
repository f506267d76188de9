"""Progress reporting over nested tasks.

Port of ``slideo_tpu/app/progress.py`` (the reporters the engine uses;
reference crates/matching/src/progress.rs): a ProgressReporter is a callback
``report(processed, total, msg)``; ComposedProgressReporter sums N nested
(processed, total) pairs into one parent report for multi-video runs
(progress.rs:5-36).
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = ["ProgressReporter", "ComposedProgressReporter", "null_reporter"]

ProgressReporter = Callable[[int, int, str], None]


def null_reporter(processed: int, total: int, msg: str) -> None:  # noqa: ARG001
    return None


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
