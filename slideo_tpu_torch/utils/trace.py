"""Per-stage wall-clock spans of a run (``slideo --trace``).

Port of ``StageTracer`` and ``StageStats`` from ``slideo_tpu/utils/trace.py``:

    tracer = StageTracer()
    with tracer.stage("decode"):
        ...
    print(tracer.summary())

Stages nest: a stage entered inside another is its child. An enabled
tracer keeps every span in ``spans`` as (name, start, end, parent), the
parent being the index of the enclosing span in ``spans`` (-1 at the top
level), and per-name totals in ``stats``. Times are ``time.monotonic()``,
which every process of the machine shares, so spans of several processes
and a device trace placed on that clock line up. A stage that ends in a
host read of a device result (``match.fetch``, ``sync.*``) includes the
device work queued before it.

One tracer serves one thread: its stack of open spans is not locked.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

__all__ = ["DISABLED", "Span", "StageStats", "StageTracer"]

_NULL = contextlib.nullcontext()


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


class Span(NamedTuple):
    name: str
    start: float
    end: float      # nan while the span is open
    parent: int     # index in ``StageTracer.spans``, -1 at the top level


@dataclass
class StageTracer:
    stats: dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    enabled: bool = True
    spans: list[Span] = field(default_factory=list)
    _open: list[int] = field(default_factory=list, repr=False)

    def stage(self, name: str):
        """A context that times ``name`` as a child of the innermost open
        stage. Disabled, it is one shared null context: no clock read."""
        if not self.enabled:
            return _NULL
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        i = len(self.spans)
        self.spans.append(Span(name, time.monotonic(), float("nan"), self._open[-1] if self._open else -1))
        self._open.append(i)
        try:
            yield
        finally:
            end = time.monotonic()
            self._open.pop()
            span = self.spans[i] = self.spans[i]._replace(end=end)
            self.stats[name].add(end - span.start)

    def summary(self) -> str:
        """Totals by stage, each child under its parent with the parent's
        self time (its time less what its children cover); shares are of
        the top-level stages' total."""
        stats: dict[tuple[str, ...], StageStats] = defaultdict(StageStats)   # by path from the top
        covered: dict[tuple[str, ...], float] = defaultdict(float)          # children's time; () the top's
        paths: list[tuple[str, ...]] = []
        for s in self.spans:
            path = (paths[s.parent] if s.parent >= 0 else ()) + (s.name,)
            paths.append(path)
            if not math.isnan(s.end):   # closed
                stats[path].add(s.end - s.start)
                covered[path[:-1]] += s.end - s.start
        if not stats:
            return "no stages traced"
        lines: list[str] = []

        def emit(parent: tuple[str, ...]) -> None:
            for path in sorted((p for p in stats if p[:-1] == parent), key=lambda p: -stats[p].total_s):
                st = stats[path]
                share = 100.0 * st.total_s / covered[()] if covered[()] else 0.0
                line = (f"{'  ' * len(path)}{path[-1]:<16} {st.total_s:8.2f}s ({share:4.1f}%)"
                        f"  calls={st.calls:<6} avg={st.total_s / st.calls * 1000:8.2f}ms"
                        f" max={st.max_s * 1000:8.2f}ms")
                if path in covered:
                    line += f" self={st.total_s - covered[path]:8.2f}s"
                lines.append(line)
                emit(path)

        emit(())
        return "per-stage timing:\n" + "\n".join(lines)

    def as_dict(self) -> dict[str, dict]:
        return {
            k: {"calls": v.calls, "total_s": v.total_s, "max_s": v.max_s}
            for k, v in self.stats.items()
        }


# The tracer of code that was given none: shares nothing, records nothing.
DISABLED = StageTracer(enabled=False)
