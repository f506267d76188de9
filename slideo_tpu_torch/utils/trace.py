"""Per-stage wall-clock statistics of a run (``slideo --trace``).

Port of ``StageTracer`` and ``StageStats`` from ``slideo_tpu/utils/trace.py``:

    tracer = StageTracer()
    with tracer.stage("decode"):
        ...
    print(tracer.summary())

The times are the host's clock. A stage that ends in a host read of a
device result (``match.fetch``, ``dedup``) includes the device work queued
before it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["StageStats", "StageTracer"]


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


@dataclass
class StageTracer:
    stats: dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats[name].add(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        total = sum(s.total_s for s in self.stats.values())
        for name, s in sorted(self.stats.items(), key=lambda kv: -kv[1].total_s):
            avg = s.total_s / max(s.calls, 1)
            share = 100.0 * s.total_s / total if total else 0.0
            lines.append(
                f"  {name:<16} {s.total_s:8.2f}s ({share:4.1f}%)"
                f"  calls={s.calls:<6} avg={avg * 1000:8.2f}ms max={s.max_s * 1000:8.2f}ms"
            )
        return "per-stage timing:\n" + "\n".join(lines) if lines else "no stages traced"

    def as_dict(self) -> dict[str, dict]:
        return {
            k: {"calls": v.calls, "total_s": v.total_s, "max_s": v.max_s}
            for k, v in self.stats.items()
        }
