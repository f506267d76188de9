"""The port's stage tracer and the spans the engine and the ORB matcher
record on it, on the CPU.

1. A disabled tracer records nothing and hands out one shared null context.
2. Spans are stamped with ``time.monotonic``, know their parent, and the
   summary gives each parent's self time and keeps the top-level line
   format that ``--trace`` prints.
3. ``MatchingEngine.match_samples(..., tracer=...)`` on a two-page deck,
   on the exact table per frame and on the batched screened path (with
   ``screen_above_slides`` lowered): every matched frame has one span of
   each matcher stage and three ``sync.pick`` in its ``match.verify``, a
   screened batch one ``match.screen``, every child
   lies inside its ``match.dispatch`` or ``dedup`` and siblings do not
   overlap; a tracer with only ``stage(name)`` works; the timeline and the
   ``FrameMatch`` fields are the same with tracing on and off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from slideo_tpu_torch import DEFAULT_CONFIG
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.models import orb_matcher
from slideo_tpu_torch.utils import trace
from slideo_tpu_torch.utils.trace import DISABLED, StageTracer

torch.set_num_threads(1)

PER_FRAME = ("match.detect", "sync.count", "match.describe", "match.table", "match.draws",
             "match.select", "match.ransac", "match.verify")
DEDUP_CHILDREN = ("dedup.stack", "sync.upload", "dedup.compare", "sync.verdict")


# ---- the tracer -------------------------------------------------------------

def test_a_disabled_tracer_records_nothing_and_shares_one_context():
    off = StageTracer(enabled=False)
    ctx = off.stage("dedup")
    assert isinstance(ctx, contextlib.nullcontext)
    assert off.stage("match.dispatch") is ctx and DISABLED.stage("x") is ctx
    with off.stage("a"), off.stage("b"):
        pass
    assert off.spans == [] and not off.stats and off.summary() == "no stages traced"
    assert DISABLED.spans == [] and not DISABLED.stats


def test_spans_are_on_the_monotonic_clock_with_their_parents():
    t = StageTracer()
    before = time.monotonic()
    with t.stage("outer"):
        with t.stage("inner"):
            pass
        with t.stage("inner"):
            with t.stage("leaf"):
                pass
    with t.stage("outer"):
        pass
    after = time.monotonic()
    assert [(s.name, s.parent) for s in t.spans] == [
        ("outer", -1), ("inner", 0), ("inner", 0), ("leaf", 2), ("outer", -1)]
    assert all(before <= s.start <= s.end <= after for s in t.spans)
    for s in t.spans:
        if s.parent >= 0:
            p = t.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert t.stats["outer"].calls == 2 and t.stats["inner"].calls == 2
    assert t.as_dict()["leaf"]["calls"] == 1


def test_summary_gives_self_time_and_keeps_the_top_level_format(monkeypatch):
    ticks = iter([0.0, 1.0, 3.0, 4.0, 4.5, 10.0, 10.0, 30.0])
    monkeypatch.setattr(trace.time, "monotonic", lambda: next(ticks))
    t = StageTracer()
    with t.stage("match.dispatch"):          # 0 .. 10
        with t.stage("match.detect"):        # 1 .. 3
            pass
        with t.stage("match.verify"):        # 4 .. 4.5
            pass
    with t.stage("decode"):                  # 10 .. 30
        pass
    lines = t.summary().splitlines()
    assert lines[0] == "per-stage timing:"
    assert lines[1].startswith("  decode ") and "(66.7%)" in lines[1] and "self=" not in lines[1]
    assert lines[2].startswith("  match.dispatch ") and "(33.3%)" in lines[2]
    assert lines[2].endswith("self=    7.50s")          # 10 - 2 - 0.5
    assert lines[3].startswith("    match.detect ") and "( 6.7%)" in lines[3]
    assert lines[4].startswith("    match.verify ") and "( 1.7%)" in lines[4]
    assert len(lines) == 5


# ---- the engine's and the matcher's spans ----------------------------------

ROUTES = ["exact", "screened"]


def _config(route: str):
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        orb=dataclasses.replace(DEFAULT_CONFIG.orb, n_features=256, max_keypoints=256,
                                n_levels=3, edge_threshold=32),
        match=dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=256,
                                  max_matches_per_slide=128, min_rating=20.0),
        video=dataclasses.replace(DEFAULT_CONFIG.video, batch_size=2),
    )
    if route == "screened":   # two slides above the limit take the batched screened path
        cfg = dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, screen_above_slides=1))
    return cfg


@pytest.fixture(scope="module")
def deck():
    rng = np.random.RandomState(3)
    pages_np = np.zeros((2, 240, 320), np.uint8)
    for s in range(2):
        for _ in range(25):
            y, x = rng.randint(20, 210), rng.randint(20, 270)
            pages_np[s, y:y + rng.randint(3, 12), x:x + rng.randint(6, 40)] = rng.randint(60, 255)

    def frame_of(page):   # shifted, with noise: an identical copy matches nothing
        f = np.roll(page.astype(np.float32), (2, 3), axis=(0, 1)) + rng.randn(240, 320) * 3
        return np.clip(np.rint(f), 0, 255).astype(np.uint8)

    # Pages alternate, so the dedup passes every sample: 5 frames in
    # batches of 2 are matched in three batches (2, 2, 1).
    samples = [(5 * i, 5.0 * i, frame_of(pages_np[i % 2])) for i in range(5)]
    pages = [PdfPage("deck.pdf", "h", f"p-{i + 1}.png", i + 1) for i in range(2)]
    return dict(pages_np=pages_np, pages=pages, samples=samples)


_RUNS: dict = {}


def _traced(route: str, deck):
    """(engine, timeline untraced, timeline traced, tracer) of one route,
    computed once."""
    if route not in _RUNS:
        engine = MatchingEngine(_config(route), deck["pages"], device="cpu",
                                page_grays=deck["pages_np"])
        plain = engine.match_samples(deck["samples"], total_ms=30000, total_frames=30)
        tracer = StageTracer()
        traced = engine.match_samples(deck["samples"], total_ms=30000, total_frames=30,
                                      tracer=tracer)
        _RUNS[route] = (engine, plain, traced, tracer)
    return _RUNS[route]


def _children(tracer: StageTracer, i: int) -> list:
    return [s for s in tracer.spans if s.parent == i]


@pytest.mark.parametrize("route", ROUTES)
def test_timeline_is_the_same_with_tracing_on_and_off(route, deck):
    _, plain, traced, _ = _traced(route, deck)
    pages = lambda out: [(m.video_ms, m.page.page_nr if m.page else None) for m in out]  # noqa: E731
    assert pages(traced) == pages(plain) == [(0, 1), (5000, 2), (10000, 1), (15000, 2),
                                             (20000, 1), (30000, None)]


@pytest.mark.parametrize("route", ROUTES)
def test_frame_match_fields_are_the_same_with_tracing_on_and_off(route, deck):
    engine = _traced(route, deck)[0]
    frames = torch.from_numpy(np.stack([g for _, _, g in deck["samples"][:3]]))
    seeds = [0, 5, 10]
    args = (frames, seeds, engine.index, engine.slide_hw, engine.cfg)
    tracer = StageTracer()
    on, off = orb_matcher.match_frames(*args, tracer=tracer), orb_matcher.match_frames(*args)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert sum(s.name == "match.describe" for s in tracer.spans) == 3


@pytest.mark.parametrize("route", ROUTES)
def test_every_matched_frame_has_one_span_of_each_matcher_stage(route, deck):
    _, _, _, tracer = _traced(route, deck)
    dispatches = [i for i, s in enumerate(tracer.spans) if s.name == "match.dispatch"]
    assert len(dispatches) == 3
    frames = 0
    for i in dispatches:
        names = [s.name for s in _children(tracer, i)]
        n = names.count("match.describe")
        frames += n
        assert n in (1, 2)
        for name in PER_FRAME:
            assert names.count(name) == n, (name, names)
        assert names.count("match.screen") == (route == "screened")
        assert set(names) <= set(PER_FRAME) | {"match.screen"}
    assert frames == 5
    assert not any(s.name == "match.screen" for s in tracer.spans if s.parent == -1)
    verifies = [i for i, s in enumerate(tracer.spans) if s.name == "match.verify"]
    assert [[s.name for s in _children(tracer, i)] for i in verifies] == [["sync.pick"] * 3] * 5


@pytest.mark.parametrize("route", ROUTES)
def test_dedup_has_its_four_children(route, deck):
    _, _, _, tracer = _traced(route, deck)
    dedups = [i for i, s in enumerate(tracer.spans) if s.name == "dedup"]
    assert len(dedups) == 3
    for i in dedups:
        assert [s.name for s in _children(tracer, i)] == list(DEDUP_CHILDREN)
    # The run's first similarity is written from the host, in its first batch only.
    firsts = [s for s in tracer.spans if s.name == "sync.first"]
    assert len(firsts) == 1 and tracer.spans[firsts[0].parent].name == "dedup.compare"
    assert tracer.spans[firsts[0].parent].parent == dedups[0]
    top = {s.name for s in tracer.spans if s.parent == -1}
    assert top == {"dedup", "match.dispatch", "match.fetch"}


@pytest.mark.parametrize("route", ROUTES)
def test_children_lie_inside_their_parent_and_siblings_do_not_overlap(route, deck):
    _, _, _, tracer = _traced(route, deck)
    for i, parent in enumerate(tracer.spans):
        kids = _children(tracer, i)
        for k in kids:
            assert parent.start <= k.start <= k.end <= parent.end
        for a, b in zip(kids, kids[1:]):
            assert a.end <= b.start
    top = [s for s in tracer.spans if s.parent == -1]
    for a, b in zip(top, top[1:]):
        assert a.end <= b.start


@pytest.mark.parametrize("route", ROUTES)
def test_a_tracer_with_only_stage_works(route, deck):
    engine = _traced(route, deck)[0]
    names: list[str] = []

    class OnlyStage:
        def stage(self, name):
            names.append(name)
            return contextlib.nullcontext()

    out = engine.match_samples(deck["samples"], total_ms=30000, total_frames=30,
                               tracer=OnlyStage())
    assert [m.page.page_nr if m.page else None for m in out] == [1, 2, 1, 2, 1, None]
    assert names.count("match.describe") == 5 and names.count("sync.upload") == 3
    assert names.count("sync.pick") == 15 and names.count("sync.first") == 1
    assert names.count("match.screen") == (3 if route == "screened" else 0)
    assert engine._tracer is DISABLED
