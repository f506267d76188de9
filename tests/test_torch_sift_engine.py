"""The port's SIFT engine against the JAX package, end to end on the CPU.

1. ``match_frame_sift`` on the case of tests/test_sift.py::
   test_sift_engine_end_to_end (a slide seen in perspective, and a noise
   frame), against the JAX deck index carried across with
   ``sift_index_from_numpy`` and with JAX's own RANSAC draws: the same
   slide and rating, the similarity within 1e-4.
2. The carried index and an index the port builds give the same match.
3. ``MatchingEngine(engine="sift", device="cpu").match_samples`` assigns
   the frames of a small stream what JAX ``match_frames_sift`` assigns
   (the production draws differ by design: assignments, not similarities).
4. On a deck of more than 96 slides the screened assignments equal the
   exact ones and the JAX package's screened ones.
5. The frame-parallel SIFT engine on ``["cpu"] * 2`` gives the one-device
   timeline.
6. The SIFT engine runs without importing jax, cv2 or the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.models import sift_matcher as jsm
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.models import sift_matcher as tsm
from test_torch_config import port_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW = (300, 400)

# The cfg of tests/test_sift.py:17-26.
CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, max_keypoints=256, n_octaves=3, border=24),
    match=dataclasses.replace(
        DEFAULT_CONFIG.match, ransac_iters=512, max_matches_per_slide=128, min_rating=15.0
    ),
    engine="sift",
)
TCFG = port_cfg(CFG)
# Tests 3-5 verify 4 candidates on a stride-4 grid: the plain sampling of
# 10 candidates at stride 2 costs ~1 s a frame on one CPU thread.
FAST_CFG = dataclasses.replace(
    CFG, match=dataclasses.replace(CFG.match, top_rated=4, verify_stride=4)
)


def _slides(rng: np.random.RandomState, n: int, hw=HW) -> np.ndarray:
    """tests/test_sift.py's synthetic slides: 30 flat rectangles each."""
    h, w = hw
    slides = np.zeros((n, h, w), np.float32)
    for s in range(n):
        for _ in range(30):
            y, x = rng.randint(30, h - 40), rng.randint(30, w - 60)
            slides[s, y:y + rng.randint(4, 14), x:x + rng.randint(6, 40)] = rng.randint(80, 255)
    return slides


def _perspective(rng: np.random.RandomState, slide: np.ndarray, out_hw, corners=None) -> np.ndarray:
    """``slide`` seen in perspective (each corner moved up to 25 px, or to
    ``corners``), with camera noise of sigma 2."""
    h, w = slide.shape
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + rng.uniform(-25, 25, (4, 2)).astype(np.float32) if corners is None else corners
    frame = cv2.warpPerspective(slide, cv2.getPerspectiveTransform(src, np.float32(dst)),
                                (out_hw[1], out_hw[0])).astype(np.float32)
    return frame + rng.randn(*out_hw).astype(np.float32) * 2


@pytest.fixture(scope="module")
def case():
    """The 4 slides and 2 frames of test_sift_engine_end_to_end, the JAX
    index and JAX's jitted match_frame_sift."""
    rng = np.random.RandomState(0)
    slides = _slides(rng, 4)
    frame = _perspective(rng, slides[2], (360, 480),
                         corners=[[30, 40], [430, 20], [460, 330], [10, 300]])
    noise = (rng.rand(360, 480) * 255).astype(np.float32)
    index = jax.jit(lambda s: jsm.build_slide_index_sift(s, CFG))(jnp.asarray(slides))
    match = jax.jit(lambda f, sd, ix: jsm.match_frame_sift(f, sd, ix, HW, CFG))
    return slides, [(5, frame), (6, noise)], index, match


def _carried(index) -> tsm.SiftSlideIndex:
    return tsm.sift_index_from_numpy(*(np.asarray(f) for f in index), device="cpu")


def test_match_frame_sift_with_jax_index_and_draws(case):
    _, frames, ji, match = case
    ti = _carried(ji)
    n_cand = min(CFG.match.top_slides, ti.pts.shape[0])
    for seed, frame in frames:
        want = match(jnp.asarray(frame), jnp.int32(seed), ji)
        key = jax.random.fold_in(jax.random.key(CFG.match.ransac_seed), jnp.int32(seed))
        u = np.array(jax.random.uniform(key, (n_cand, CFG.match.ransac_iters, 4)))
        got = tsm.match_frame_sift(torch.from_numpy(frame), seed, ti, HW, TCFG, u=torch.from_numpy(u))
        assert int(got.slide) == int(want.slide), seed
        assert float(got.rating) == float(want.rating), seed
        if np.isfinite(float(want.similarity)):
            assert abs(float(got.similarity) - float(want.similarity)) <= 1e-4, seed
        else:
            assert float(got.similarity) == float(want.similarity), seed
    assert [int(match(jnp.asarray(f), jnp.int32(s), ji).slide) for s, f in frames] == [2, -1]


def test_carried_index_matches_like_port_index(case):
    slides, frames, ji, _ = case
    built = tsm.build_slide_index_sift(slides, TCFG, "cpu")
    for index in (_carried(ji), built):
        got = [int(tsm.match_frame_sift(torch.from_numpy(f), s, index, HW, TCFG).slide)
               for s, f in frames]
        assert got == [2, -1]


def _stream(slides: np.ndarray):
    """Sampled frames (frame_idx, time_s, uint8 gray) of slides 1, 3, 0, 2
    in perspective, a noise frame, then slide 3 again."""
    rng = np.random.RandomState(7)
    h, w = slides.shape[1:]
    shown = [1, 3, 0, 2, None, 3]
    samples = []
    for i, s in enumerate(shown):
        f = rng.rand(h, w) * 255 if s is None else _perspective(rng, slides[s], (h, w))
        samples.append((i * 125, i * 5.0, np.clip(np.rint(f), 0, 255).astype(np.uint8)))
    return samples


def _engine_rows(pages_np: np.ndarray, samples, cfg, mesh_devices=None):
    """The engine's per-frame (frame_idx, page index or None) rows and its
    timeline as (ms, page number or None)."""
    pages = [PdfPage(Path("deck.pdf"), "h" * 64, Path(f"p-{i + 1}.png"), i + 1)
             for i in range(len(pages_np))]
    engine = MatchingEngine(cfg, pages, device="cpu", page_grays=pages_np,
                            mesh_devices=mesh_devices)
    rows = []
    timeline = engine.match_samples(
        samples, total_ms=len(samples) * 5000, total_frames=len(samples) * 125,
        checkpoint=lambda new, _last: rows.extend((f, p) for f, _ms, _h, p in new),
    )
    return rows, [(m.video_ms, m.page.page_nr if m.page else None) for m in timeline]


@pytest.fixture(scope="module")
def engine_run(case):
    slides = case[0].astype(np.uint8)
    assert np.array_equal(slides, case[0])   # integer pixels: the JAX index stands
    samples = _stream(slides)
    tcfg = port_cfg(FAST_CFG)
    cfg = dataclasses.replace(tcfg, video=dataclasses.replace(tcfg.video, batch_size=4))
    return slides, samples, cfg, _engine_rows(slides, samples, cfg)


def test_engine_match_samples_equals_jax(case, engine_run):
    slides, samples, _, (rows, timeline) = engine_run
    frames = np.stack([g for _, _, g in samples]).astype(np.float32)
    ji = case[2]
    want = jax.jit(lambda f, sd, ix: jsm.match_frames_sift(f, sd, ix, HW, FAST_CFG))(
        jnp.asarray(frames), jnp.asarray([i for i, _, _ in samples], jnp.int32), ji)
    want_rows = [(i, None if s < 0 else int(s)) for (i, _, _), s in zip(samples, np.asarray(want.slide))]
    assert rows == want_rows
    assert [p for _, p in rows] == [1, 3, 0, 2, None, 3]
    assert timeline == [(0, 2), (5000, 4), (10000, 1), (15000, 3), (20000, None), (25000, 4),
                        (30000, None)]


def test_frame_parallel_sift_engine_equals_one_device(engine_run):
    slides, samples, cfg, one = engine_run
    assert _engine_rows(slides, samples, cfg, mesh_devices=["cpu", "cpu"]) == one


def test_screened_sift_equals_exact_and_jax():
    """101 slides of 120 x 160 (above screen_above_slides = 96, so the bf16
    stage-1 vote picks each frame's 16 candidate slides), at 128 keypoints
    in one octave and 256 RANSAC draws to keep the CPU run short. Both
    packages match against the JAX index, carried across (test 2 holds the
    port's own build to it), which halves the run."""
    rng = np.random.RandomState(11)
    hw = (120, 160)
    slides = _slides(rng, 101, hw)
    frames = [_perspective(rng, slides[s], hw) for s in (12, 99)]
    frames.append((rng.rand(*hw) * 255).astype(np.float32))
    frames = np.stack(frames)
    cfg = dataclasses.replace(
        FAST_CFG, sift=dataclasses.replace(CFG.sift, max_keypoints=128, n_octaves=1),
        match=dataclasses.replace(FAST_CFG.match, ransac_iters=256),
    )
    tcfg = port_cfg(cfg)
    exact_cfg = dataclasses.replace(tcfg, match=dataclasses.replace(tcfg.match, screen_above_slides=999))
    assert len(slides) > tcfg.match.screen_above_slides
    ji = jsm.build_slide_index_sift_chunked(slides, cfg, chunk=32)
    index = _carried(ji)
    seeds = list(range(len(frames)))
    screened = tsm.match_frames_sift(torch.from_numpy(frames), seeds, index, hw, tcfg).slide.tolist()
    exact = tsm.match_frames_sift(torch.from_numpy(frames), seeds, index, hw, exact_cfg).slide.tolist()
    want = jax.jit(lambda f, sd, ix: jsm.match_frames_sift(f, sd, ix, hw, cfg))(
        jnp.asarray(frames), jnp.arange(len(frames), dtype=jnp.int32), ji)
    assert screened == exact == np.asarray(want.slide).tolist() == [12, 99, -1]


_NO_JAX_SCRIPT = r"""
import dataclasses
import sys

import numpy as np
import torch

from slideo_tpu_torch import DEFAULT_CONFIG
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage

torch.set_num_threads(1)
cfg = dataclasses.replace(
    DEFAULT_CONFIG, engine="sift",
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, max_keypoints=128, n_octaves=2, border=24),
    match=dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=256, max_matches_per_slide=64,
                              min_rating=15.0),
)
rng = np.random.RandomState(0)
pages_np = np.zeros((2, 160, 200), np.uint8)
for s in range(2):
    for _ in range(20):
        y, x = rng.randint(30, 120), rng.randint(30, 140)
        pages_np[s, y:y + rng.randint(4, 14), x:x + rng.randint(6, 40)] = rng.randint(80, 255)
def frame_of(page):
    f = np.roll(page.astype(np.float32), (2, 3), axis=(0, 1)) + rng.randn(160, 200) * 2
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)
pages = [PdfPage("deck.pdf", "h", f"p-{i + 1}.png", i + 1) for i in range(2)]
samples = [(0, 0.0, frame_of(pages_np[1])), (5, 5.0, frame_of(pages_np[0]))]
engine = MatchingEngine(cfg, pages, device="cpu", page_grays=pages_np)
out = engine.match_samples(samples, total_ms=10000, total_frames=10)
assert [m.page.page_nr if m.page else None for m in out] == [2, 1, None], out
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2", "slideo_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_sift_engine_runs_without_jax_or_cv2(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
