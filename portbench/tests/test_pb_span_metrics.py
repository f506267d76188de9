"""The readers of the matcher's and the engine's inner stages, on a hand-made
run: they count spans only in the window before the profile, give None
without spans or on a program that records none of their stages, and
``screen_ms_per_frame`` gives None where no batch was screened."""

import pytest

from portbench.lib import spec
from portbench.lib.run_data import Run

# Stages of one matched frame and of one dedup, with their durations in ms.
FRAME = [("match.detect", 4), ("sync.count", 1), ("match.describe", 3), ("match.table", 2),
         ("match.draws", 1), ("match.select", 5), ("match.ransac", 10), ("match.verify", 4),
         ("sync.pick", 0.5), ("sync.pick", 0.5), ("sync.pick", 0.5)]
DEDUP = [("dedup.stack", 1), ("sync.upload", 2), ("dedup.compare", 3), ("sync.verdict", 4)]


def batch(t: float, screen: bool, scale: float = 1.0) -> list:
    """The spans of one sampled batch of 2 frames, both matched, from ``t``
    seconds; ``scale`` stretches every duration."""
    spans, now = [], t

    def put(children, parent):
        nonlocal now
        t0 = now
        for name, ms in children:
            spans.append((name, now, now + ms * scale * 1e-3))
            now += ms * scale * 1e-3
        spans.append((parent, t0, now))

    put(DEDUP, "dedup")
    features, cascade = FRAME[:3], FRAME[3:]
    put(features * 2 + ([("match.screen", 5)] if screen else []) + cascade * 2, "match.dispatch")
    spans.append(("match.fetch", now, now + 2 * scale * 1e-3))
    return spans


def make_run(screen: bool = True, parent_only: bool = False) -> Run:
    """Two clients; the window is 100-110 s and each profile starts at 104 s.
    Batches at 101, 102 and 103 s count; one before the window and one
    after the profile's start, ten times as long, do not."""
    reports = []
    for _ in range(2):
        spans = [s for t in (99.5, 101, 102, 103) for s in batch(t, screen)]
        spans += batch(105, screen, scale=10.0)
        if parent_only:
            spans = [s for s in spans if s[0] in ("dedup", "match.dispatch", "match.fetch")]
        reports.append(dict(spans=spans, batch=2, profile=dict(start=104.0, stop=110.0)))
    return Run(cell={}, seed=1, seconds=10.0, t_start=100.0, t_run=90.0, ready=[], reports=reports)


# Per matched frame: detect 4 + describe 3; screen 5 a batch of 2; ... Host
# reads a batch: upload 2 + verdict 4 + count 1 x 2 + pick 1.5 x 2 + fetch 2
# = 13 ms in 11 reads, over its 2 sampled frames.
WANT = {
    "features_ms_per_frame": 7.0, "screen_ms_per_frame": 2.5, "table_ms_per_frame": 2.0,
    "select_ms_per_frame": 5.0, "ransac_ms_per_frame": 11.0, "verify_ms_per_frame": 4.0,
    "host_wait_ms_per_frame": 6.5, "host_syncs_per_frame": 5.5,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_counts_spans_before_the_profile(name):
    assert spec.metric_module(name).read(make_run()) == pytest.approx(WANT[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_spans(name):
    run = make_run()
    for r in run.reports:
        del r["spans"]
    assert spec.metric_module(name).read(run) is None
    # A program that records only the engine's top-level stages.
    assert spec.metric_module(name).read(make_run(parent_only=True)) is None


def test_screen_is_none_where_no_batch_was_screened():
    run = make_run(screen=False)
    assert spec.metric_module("screen_ms_per_frame").read(run) is None
    assert spec.metric_module("table_ms_per_frame").read(run) == pytest.approx(2.0)


def test_the_existing_readers_read_the_same_parent_spans():
    run = make_run()
    # dedup: 10 ms a batch of 2 sampled frames; match: dispatch 2 x 31.5 + 5 screen + fetch 2.
    assert spec.metric_module("dedup_ms_per_frame").read(run) == pytest.approx(5.0)
    assert spec.metric_module("match_ms_per_frame").read(run) == pytest.approx(35.0)
