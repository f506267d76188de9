"""The port's ORB match slice against the JAX package, end to end on the CPU.

1. The JAX deck index and frame features carried across with
   ``slide_index_from_numpy``: the port's table + cascade, given JAX's own
   RANSAC draws, picks the same slide with the same rating.
2. Port ``match_frames`` and JAX ``match_frames`` assign the same slides.
3. Port ``sync`` and JAX ``pipeline.sync`` write the same videos_mapping
   rows (the fixture of test_pipeline.py).
4. The port imports and runs its slice, exact, screened and on a
   frame-parallel mesh, and imports its mesh, stage-profile, command-line,
   viewer-server, tracing and protocol modules, without importing jax, cv2
   or anything of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from slideo_tpu.app import pipeline as jpipeline
from slideo_tpu.models import orb_matcher as jom
from slideo_tpu.ops import features as jfeat
from slideo_tpu.ops import hamming as jham
from slideo_tpu_torch.app import pipeline as tpipeline
from slideo_tpu_torch.models import orb_matcher as tom
from slideo_tpu_torch.ops import features as tfeat
from slideo_tpu_torch.ops import hamming as tham
from slideo_tpu_torch.ops.image import to_small_image
from test_pipeline import fixture_dir, small_cfg  # noqa: F401  (shared fixtures)
from test_torch_config import port_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW = (240, 320)


@pytest.fixture(scope="module")
def deck():
    """4 synthetic slides and 4 frames showing them (rotated 0-9 degrees,
    scaled, shifted), plus a noise frame, with the JAX index built once."""
    cfg = graft._small_cfg()
    slides, frames = graft._synthetic_inputs(np.random.RandomState(0), 4, HW, HW, 4)
    noise = np.random.RandomState(1).rand(1, *HW).astype(np.float32) * 255
    frames = np.concatenate([frames, noise])
    index = jom.build_slide_index(jnp.asarray(slides), cfg)
    return cfg, slides, frames, index


@pytest.fixture(scope="module")
def tcfg(deck):
    return port_cfg(deck[0])


def test_cascade_from_jax_index_and_features(deck, tcfg):
    cfg, _, frames, ji = deck
    s, k = ji.pts.shape[0], ji.pts.shape[1]
    ti = tom.slide_index_from_numpy(
        np.asarray(ji.desc_index.desc), np.asarray(ji.desc_index.valid),
        np.asarray(ji.pts), np.asarray(ji.smalls), device="cpu",
    )
    meta = jfeat.pyramid_meta(*HW, cfg.orb)
    for seed in range(frames.shape[0]):
        atlas = jfeat.build_pyramid(jnp.asarray(frames[seed]), cfg.orb)
        kps = jfeat.detect_pyramid(atlas, meta, cfg.orb)
        feats = jfeat.describe(atlas, meta, kps, cfg.orb.max_keypoints, cfg.orb)
        table = jham.match_table_frame(feats.desc, feats.score, ji.desc_index, s, k, cfg.match)
        frame = atlas[:HW[0], :HW[1]].astype(jnp.float32)
        want = jom.cascade_from_table(frame, jnp.int32(seed), feats, table, ji.pts, ji.smalls, HW, cfg)

        key = jax.random.fold_in(jax.random.key(cfg.match.ransac_seed), jnp.int32(seed))
        u = np.array(jax.random.uniform(key, (min(cfg.match.top_slides, s), cfg.match.ransac_iters, 2)))
        tfeats = tfeat.Features(*(torch.from_numpy(np.array(f)) for f in feats))
        ttable = tham.match_table(tfeats.desc, ti.desc_index, s, k)
        assert np.array_equal(ttable.dist.numpy(), np.asarray(table.dist))
        assert np.array_equal(ttable.train.numpy(), np.asarray(table.train))
        got = tom.cascade_from_table(
            to_small_image(torch.from_numpy(np.array(frame))), HW, torch.from_numpy(u),
            tfeats, ttable, ti.pts, ti.smalls, HW, tcfg,
        )
        assert int(got.slide) == int(want.slide), seed
        assert float(got.rating) == float(want.rating), seed
        if np.isfinite(float(want.similarity)):
            assert abs(float(got.similarity) - float(want.similarity)) <= 1e-4, seed
        else:
            assert float(got.similarity) == float(want.similarity), seed


def test_match_frames_same_assignments(deck, tcfg):
    cfg, slides, frames, ji = deck
    n = frames.shape[0]
    want = jom.match_frames(jnp.asarray(frames), jnp.arange(n, dtype=jnp.int32), ji, HW, cfg)
    ti = tom.build_slide_index(slides, tcfg, "cpu")
    got = tom.match_frames(torch.from_numpy(frames), list(range(n)), ti, HW, tcfg)
    assert got.slide.tolist() == np.asarray(want.slide).tolist() == [0, 1, 2, 3, -1]


def _sync_rows(module, fixture, cfg, tmp: Path, **kw):
    """Rows that ``module``'s ``sync`` writes through its own package's Db."""
    db = module.Db(tmp / f"{module.__name__.replace('.', '_')}.db")
    db.set_pdf_extracted_pages_dir(
        module.PdfExtractedPagesDir(fixture["pdf_hash"], fixture["pages_dir"], True)
    )
    pages = module.pdfs_to_images([(fixture["pdf_path"], fixture["pdf_hash"])], db)
    db.create_or_reset_video(fixture["video_hash"], [fixture["pdf_hash"]])
    module.sync(pages, [(fixture["vid_path"], fixture["video_hash"])], db, cfg, **kw)
    rows = db.conn.execute(
        "SELECT video_ms, pdf_hash, page FROM videos_mapping ORDER BY video_ms"
    ).fetchall()
    finished = db.find_mapping_info(fixture["video_hash"]).finished
    db.close()
    return rows, finished


def test_sync_writes_same_rows_as_jax(fixture_dir, small_cfg, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # the JAX engine persists its index there
    tempfile.tempdir = None
    try:
        want, _ = _sync_rows(jpipeline, fixture_dir, small_cfg, tmp_path)
        got, finished = _sync_rows(
            tpipeline, fixture_dir, port_cfg(small_cfg), tmp_path, device="cpu"
        )
    finally:
        tempfile.tempdir = None
    assert finished
    assert got == want
    assert got[0][2] == 0 and got[-1][1] is None and any(r[2] == 2 for r in got)


_NO_JAX_SCRIPT = r"""
import dataclasses
import sys

import numpy as np
import torch

from slideo_tpu_torch import DEFAULT_CONFIG, matching  # noqa: F401
from slideo_tpu_torch.app import cli, web  # noqa: F401
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.ops import cuda_fast, cuda_orb, cuda_table, cuda_warp  # noqa: F401
from slideo_tpu_torch.utils import trace  # noqa: F401
from slideo_tpu_torch.parallel import mesh  # noqa: F401
from slideo_tpu_torch.tools import profile_stages  # noqa: F401

torch.set_num_threads(1)
cfg = dataclasses.replace(
    DEFAULT_CONFIG,
    orb=dataclasses.replace(DEFAULT_CONFIG.orb, n_features=256, max_keypoints=256,
                            n_levels=3, edge_threshold=32),
    match=dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=256,
                              max_matches_per_slide=128, min_rating=20.0),
)
rng = np.random.RandomState(0)
pages_np = np.zeros((2, 240, 320), np.uint8)
for s in range(2):
    for _ in range(25):
        y, x = rng.randint(20, 210), rng.randint(20, 270)
        pages_np[s, y:y + rng.randint(3, 12), x:x + rng.randint(6, 40)] = rng.randint(60, 255)
# Frames show a page shifted by 2 px with noise: an identical copy would
# match nothing (a best distance of 0 keeps no match, the reference quirk).
def frame_of(page):
    f = np.roll(page.astype(np.float32), (2, 3), axis=(0, 1)) + rng.randn(240, 320) * 3
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)
pages = [PdfPage("deck.pdf", "h", f"p-{i + 1}.png", i + 1) for i in range(2)]
f1, f0 = frame_of(pages_np[1]), frame_of(pages_np[0])
samples = [(0, 0.0, f1), (5, 5.0, f1), (10, 10.0, f0)]
# A 2-slide deck takes the exact table; with screen_above_slides=1 it takes
# the screened batch path (stage-1 screening, then the table over the
# candidates); the exact path also runs on a frame-parallel mesh of two.
screened = dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, screen_above_slides=1))
for c, mesh_devices in ((cfg, None), (screened, None), (cfg, ["cpu", "cpu"])):
    engine = MatchingEngine(c, pages, device="cpu", page_grays=pages_np, mesh_devices=mesh_devices)
    out = engine.match_samples(samples, total_ms=15000, total_frames=15)
    assert [m.page.page_nr if m.page else None for m in out] == [2, 1, None], out
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "cv2", "slideo_tpu")
)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_without_jax_or_cv2(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
