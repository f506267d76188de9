"""The port's screened path for decks above ``screen_above_slides`` slides.

Same numpy inputs through the JAX package and ``slideo_tpu_torch`` on the
CPU. The JAX package builds its screening tensor only on a TPU, so each JAX
index here gets it attached by hand, as ``test_screened_batch.py`` does, and
the Pallas screening kernel runs with ``interpret=True``.

(i)   K5 mode (b)'s plain version == the Pallas kernel, bit for bit, also
      over several of ``csrc/screen.cu``'s query tiles with a ragged last
      one and at a K that is not a multiple of its slot tile; the kernel
      library's name hashes the ``csrc`` headers too, and the package ships
      every file a build reads.
(ii)  ``screen_slides_batched`` gives JAX's candidate ids: random, tie-heavy
      and exact vote-boundary decks, and at ``screen_bits = 64``, which
      both packages' batched rule reads as 128; ``match_table_frame`` gives
      JAX's table, the per-frame rule's candidates above the limit.
(iii) ``match_frames`` and ``MatchingEngine`` on a 100-slide deck assign
      JAX's slides.
(iv)  On JAX's own features: the same candidates, a bit-equal stage-2 table
      over them and, with JAX's RANSAC draws, the same slide, rating and
      similarity as JAX's batched screened path.
(v)   At a K that is not a multiple of 128 (K = 200, 12 slides over a
      lowered limit of 8), where the JAX package screens frame by frame
      (``_screen_slides``, no screening tensor): the port's per-frame rule
      gives its candidates on its features, at full K (where the batched
      rule gives them too) and trimmed to ``screen_k_per_slide`` = 128
      slots, and ``match_frames`` its slides.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG, OrbConfig
from slideo_tpu.models import orb_matcher as jom
from slideo_tpu.ops import features as jfeat
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops.pallas_table import match_table_scores_pallas
from slideo_tpu_torch import _kernels
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.models import orb_matcher as tom
from slideo_tpu_torch.ops import cuda_screen
from slideo_tpu_torch.ops import features as tfeat
from slideo_tpu_torch.ops import hamming as tham
from slideo_tpu_torch.ops.image import to_small_image
from test_screened_batch import _deck
from test_torch_config import port_cfg

torch.set_num_threads(1)


def _pm1(rng, *shape) -> np.ndarray:
    return np.where(rng.rand(*shape) > 0.5, 1, -1).astype(np.int8)


def _jax_index(desc: np.ndarray, valid: np.ndarray):
    """JAX index of [S, K, D] descriptors with its screening tensor."""
    s, k, _ = desc.shape
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    return ji._replace(screen_desc=jham.build_screen_desc(ji.desc, ji.valid, s, k))


def _port_index(desc: np.ndarray, valid: np.ndarray):
    return tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))


@pytest.mark.parametrize("k, r", [(256, 70), (384, 70), (256, 600), (1000, 70)])
def test_screen_scores_plain_equals_pallas(k, r):
    """The plain version bit-equal to the interpret-mode Pallas kernel.
    (256, 600): R spans three of ``csrc/screen.cu``'s 256-query tiles, the
    last one ragged (88 rows). (1000, 70): K is not a multiple of its
    64-slot tile. The Pallas kernel takes only K a multiple of 128, so it
    runs at the nearest K it accepts, 1024, with slots 1000-1023 of every
    slide invalid (the same function: they score -254, below any valid
    slot and equal to a slide with none), against the plain version on the
    index at K = 1000."""
    rng = np.random.RandomState(k)
    s = 5
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.25
    valid[2] = False                        # a slide with no valid slot: -254
    query = _pm1(rng, r, 256)
    query[[3, 40, r - 1]] = 0               # invalid query rows are all zero
    desc[4, 7] = query[0]                   # an exact prefix hit (+128)
    valid[4, 7] = True
    desc[1, 9, :128] = -query[1, :128]      # the worst valid prefix (-128)
    valid[1] = False
    valid[1, 9] = True
    kp = -(-k // 128) * 128                 # the K the Pallas kernel accepts
    desc_p = np.concatenate([desc, _pm1(rng, s, kp - k, 256)], axis=1)
    valid_p = np.concatenate([valid, np.zeros((s, kp - k), bool)], axis=1)
    ji = _jax_index(desc_p, valid_p)
    qp = jnp.concatenate(
        [jnp.asarray(query[:, :128]), jnp.ones((r, 2), jnp.int8), jnp.zeros((r, 30), jnp.int8)],
        axis=1,
    )
    want, _ = match_table_scores_pallas(
        qp, ji.screen_desc, jnp.zeros((s * kp,), jnp.float32), s, kp, dtype=jnp.int8,
        with_arg=False, transposed=True, skip_bias=True, interpret=True,
    )
    want = np.asarray(want)
    ti = _port_index(desc, valid)
    got = cuda_screen.screen_scores(
        torch.from_numpy(query[:, :128]).contiguous(), ti.desc, ti.valid, s, k
    ).numpy()
    assert got.shape == (r, s)
    assert got.dtype == np.int32 and np.array_equal(got, want.astype(np.int32))
    assert np.array_equal(want, got.astype(np.float32))
    assert (got[:, 2] == -254).all() and got[0, 4] == 128 and got[1, 1] == -128
    assert (got[3, [0, 1, 3, 4]] == 0).all()   # zero row vs valid slots


def test_source_digest_covers_headers(tmp_path):
    """The kernel library's name hashes every file a build reads: editing a
    ``csrc/*.cuh`` header alone must change it, as editing a source does, so
    a stale library is never loaded."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    (tmp_path / "notes.txt").write_text("not read by a build\n")
    first = _kernels.source_digest(tmp_path)
    assert _kernels.source_digest(tmp_path) == first
    (tmp_path / "notes.txt").write_text("edited\n")
    assert _kernels.source_digest(tmp_path) == first
    (tmp_path / "h.cuh").write_text("#pragma once\n// edited\n")
    second = _kernels.source_digest(tmp_path)
    assert second != first
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    third = _kernels.source_digest(tmp_path)
    assert third not in (first, second)
    (tmp_path / "b.cuh").write_text("#pragma once\n")   # a new header
    assert _kernels.source_digest(tmp_path) not in (first, second, third)


def test_package_data_ships_every_build_input():
    """An installed port builds from the ``csrc`` files its package data
    lists: every source and every header a source includes must match one
    of ``slideo_tpu_torch``'s globs in ``pyproject.toml``."""
    root = Path(__file__).resolve().parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["slideo_tpu_torch"]
    pkg = root / "slideo_tpu_torch"
    shipped = {p for g in globs for p in pkg.glob(g)}
    csrc = pkg / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert sources and set(sources) <= shipped
    for src in sources:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            header = csrc / name
            assert header.is_file(), f"{src.name} includes {name}, not in csrc/"
            assert header in shipped, f"{name} (included by {src.name}) is not in package-data"


def _screen_both(qdesc: np.ndarray, desc: np.ndarray, valid: np.ndarray, cfg):
    s, k, _ = desc.shape
    want = jham.screen_slides_batched(
        jnp.asarray(qdesc), _jax_index(desc, valid), s, k, cfg, interpret=True
    )
    got = tham.screen_slides_batched(
        torch.from_numpy(qdesc), _port_index(desc, valid), s, k, port_cfg(cfg)
    )
    return np.asarray(want), got.numpy()


def _near(rng, rows: np.ndarray, flips: int) -> np.ndarray:
    """``rows`` with ``flips`` random bits of the 128-bit prefix flipped."""
    out = rows.copy()
    for row in out.reshape(-1, rows.shape[-1]):
        row[rng.choice(128, flips, replace=False)] *= -1
    return out


@pytest.mark.parametrize("ties", [False, True])
def test_screen_slides_batched_same_candidates(ties):
    """Frames whose queries lie near one slide's slots. With ``ties`` the
    deck is 10 slides repeated 4 times, so vote counts tie in groups and the
    order among them (lowest index first) decides the top 16."""
    rng = np.random.RandomState(11 + ties)
    s, k, b, qs = 40, 128, 3, 48
    desc = np.tile(_pm1(rng, 10, k, 256), (4, 1, 1)) if ties else _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.2
    if ties:
        valid = np.tile(valid[:10], (4, 1))
    valid[5] = False
    qdesc = np.stack([
        _near(rng, desc[t, rng.choice(k, qs)], int(rng.randint(6, 30))) for t in (3, 17, 28)
    ])
    qdesc[1, :5] = 0                        # invalid rows among the queries
    cfg = DEFAULT_CONFIG.match
    want, got = _screen_both(qdesc, desc, valid, cfg)
    assert want.shape == got.shape == (b, cfg.screen_slides)
    assert np.array_equal(got, want)
    if not ties:
        assert got[:, 0].tolist() == [3, 17, 28]


@pytest.mark.parametrize("bestd", [0, 19, 20, 40, 60, 80, 100, 120])
def test_screen_votes_at_the_boundary(bestd):
    """A query x and slides whose nearest slot lies exactly at prefix
    distance bestd, at the float32 threshold bestd*1.05 + 1 (kept) and one
    bit past it (dropped): the candidates' order shows which slides voted."""
    rng = np.random.RandomState(bestd)
    thr = int(np.floor(np.float32(bestd) * np.float32(1.05) + np.float32(1.0)))
    dists = [128, thr + 1, bestd, min(thr + 1, 128), thr, 128, bestd + 1]
    s, k = len(dists), 128
    x = _pm1(rng, 256)
    desc = np.tile(-x, (s, k, 1))                 # every other slot at distance 128
    for j, d in enumerate(dists):
        desc[j, 5] = x
        desc[j, 5, rng.choice(128, d, replace=False)] *= -1
    valid = np.ones((s, k), bool)
    qdesc = np.stack([x[None], -x[None]])         # and a frame whose query is -x
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, screen_slides=4)
    want, got = _screen_both(qdesc, desc, valid, cfg)
    assert np.array_equal(got, want)
    kept = [j for j, d in enumerate(dists) if d <= thr]
    assert got[0].tolist() == (kept + [j for j in range(s) if j not in kept])[:4]
    assert 4 in got[0] and 1 not in got[0]


@pytest.mark.parametrize("n_slides", [96, 97])
def test_match_table_frame_screens_decks_above_the_limit(n_slides):
    """A single frame's table equals the JAX package's ``match_table_frame``
    on its index without a screening tensor: all columns up to
    screen_above_slides = 96; above it, the columns of the frame's
    per-frame stage-1 candidates (``_screen_slides``: the raw scores pick
    the queries, invalid rows among them)."""
    rng = np.random.RandomState(n_slides)
    k, q = 128, 300
    desc = _pm1(rng, n_slides, k, 256)
    valid = rng.rand(n_slides, k) > 0.2
    query = _near(rng, desc[40, rng.choice(k, q)], 20)
    score = rng.rand(q).astype(np.float32)
    query[rng.rand(q) < 0.1] = 0
    ti, tq = _port_index(desc, valid), torch.from_numpy(query)
    cfg = DEFAULT_CONFIG.match
    got = tham.match_table_frame(tq, torch.from_numpy(score), ti, n_slides, k, port_cfg(cfg))
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    want = jham.match_table_frame(jnp.asarray(query), jnp.asarray(score), ji, n_slides, k, cfg)
    for name in ("dist", "train", "slide_ids", "valid"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    if n_slides <= cfg.screen_above_slides:
        assert got.slide_ids.tolist() == list(range(n_slides))
    else:
        assert got.slide_ids.shape == (cfg.screen_slides,) and int(got.slide_ids[0]) == 40


def test_screening_refuses_options_not_ported():
    """No screening option is refused any more (the name is the test's
    from when ``screen_bits = 64`` was): the batched rule at 64 bits votes
    with 128-bit prefixes, as the JAX package's does, so its candidates
    equal JAX's and its own at the default 128."""
    rng = np.random.RandomState(64)
    s, k = 24, 128
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.2
    qdesc = np.stack([_near(rng, desc[t, rng.choice(k, 40)], 24) for t in (3, 17)])
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, screen_bits=64)
    want, got = _screen_both(qdesc, desc, valid, cfg)
    assert np.array_equal(got, want)
    _, at128 = _screen_both(qdesc, desc, valid, DEFAULT_CONFIG.match)
    assert np.array_equal(got, at128) and got[:, 0].tolist() == [3, 17]


# --- the 100-slide deck of test_screened_batch.py --------------------------

HW = (180, 240)


@functools.lru_cache(maxsize=1)
def _deck100_deck():
    """The 100-slide deck, 3 warped frames of it, the small ORB config and
    the JAX package's index of the deck with its screening tensor (K = 384),
    built once a process: the index reads ``cfg.orb`` and ``cfg.video``
    only, so every ``match`` of ``deck100_inputs`` shares it."""
    rng = np.random.RandomState(3)
    n_slides = 100
    slides = _deck(rng, n_slides, HW)
    import cv2

    frames = []
    for _ in range(3):
        s = rng.randint(n_slides)
        m = cv2.getRotationMatrix2D((HW[1] / 2, HW[0] / 2), rng.uniform(-2, 2), rng.uniform(0.95, 1.0))
        fr = cv2.warpAffine(slides[s], m, (HW[1], HW[0]), borderValue=40)
        frames.append(np.clip(fr.astype(np.float32) + rng.randn(*HW), 0, 255).astype(np.uint8))
    frames = np.stack(frames)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        orb=OrbConfig(n_features=384, max_keypoints=384, n_levels=4, edge_threshold=32,
                      query_buckets=(256,)),
        match=dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=256),
    )
    index = jom.build_slide_index_chunked(slides, cfg, chunk=25)
    di = index.desc_index
    k = index.pts.shape[1]
    index = index._replace(
        desc_index=di._replace(screen_desc=jham.build_screen_desc(di.desc, di.valid, n_slides, k))
    )
    return cfg, slides, frames, index


def deck100_inputs(**match):
    """The 100-slide deck, 3 warped frames of it, the config (small ORB,
    ``match`` fields over the default MatchConfig) and the JAX package's
    index of the deck with its screening tensor (K = 384)."""
    cfg, slides, frames, index = _deck100_deck()
    return (dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, **match)),
            slides, frames, index)


@pytest.fixture(scope="module")
def deck100():
    cfg, slides, frames, index = deck100_inputs()
    seeds = jnp.arange(len(frames), dtype=jnp.int32)
    want = jom.match_frames(jnp.asarray(frames), seeds, index, HW, cfg)   # batched path
    return cfg, slides, frames, index, want


def test_match_frames_screened_same_slides(deck100):
    """``match_frames`` on the engine's 100-slide index, then the engine's
    timeline of the same frames (5 s apart), both with JAX's slides."""
    cfg, slides, frames, _, want = deck100
    tcfg = port_cfg(cfg)
    pages = [PdfPage(Path("deck.pdf"), "h", Path(f"p-{i + 1}.png"), i + 1) for i in range(len(slides))]
    engine = MatchingEngine(tcfg, pages, device="cpu", page_grays=slides)
    got = tom.match_frames(torch.from_numpy(frames), list(range(len(frames))), engine.index, HW, tcfg)
    want_slides = np.asarray(want.slide).tolist()
    assert got.slide.tolist() == want_slides
    assert min(want_slides) >= 0

    samples = [(i, 5.0 * i, f) for i, f in enumerate(frames)]
    timeline = engine.match_samples(samples, total_ms=15000, total_frames=len(frames))
    expected = [(5000 * i, s + 1) for i, s in enumerate(want_slides)
                if i == 0 or s != want_slides[i - 1]] + [(15000, None)]
    assert [(m.video_ms, m.page.page_nr if m.page else None) for m in timeline] == expected


def test_screened_stage2_and_cascade_with_jax_draws(deck100):
    cfg, _, frames, ji, want = deck100
    tcfg = port_cfg(cfg)
    s, k = ji.pts.shape[0], ji.pts.shape[1]
    di = ji.desc_index
    ti = tom.slide_index_from_numpy(
        np.asarray(di.desc), np.asarray(di.valid), np.asarray(ji.pts), np.asarray(ji.smalls),
        device="cpu",
    )
    meta = jfeat.pyramid_meta(*HW, cfg.orb)
    feats, qdescs = [], []
    for f in frames:
        atlas = jfeat.build_pyramid(jnp.asarray(f, jnp.float32), cfg.orb)
        kps = jfeat.detect_pyramid(atlas, meta, cfg.orb)
        q = next(b for b in jom._query_buckets(cfg) if b >= int(jnp.sum(kps.valid)))
        ft = jfeat.describe(atlas, meta, kps, q, cfg.orb)
        tft = tfeat.Features(*(torch.from_numpy(np.array(x)) for x in ft))
        feats.append((ft, tft))
        qdescs.append(tham.screen_queries(tft.desc, tft.score, tft.valid, tcfg.match))
    # JAX's own query choice (orb_matcher.py:395-397) over padded features.
    jq = []
    for ft, _ in feats:
        ftp = jom._pad_features(ft, cfg.orb.max_keypoints)
        _, topq = jax.lax.top_k(jnp.where(ftp.valid, ftp.score, -1.0), cfg.match.screen_queries)
        jq.append(np.asarray(ftp.desc)[np.asarray(topq)])
    assert np.array_equal(torch.stack(qdescs).numpy(), np.stack(jq))

    cand_j = np.asarray(jham.screen_slides_batched(
        jnp.asarray(np.stack(jq)), di, s, k, cfg.match, interpret=True
    ))
    cand_t = tham.screen_slides_batched(torch.stack(qdescs), ti.desc_index, s, k, tcfg.match)
    assert np.array_equal(cand_t.numpy(), cand_j)

    for i, ((ft, tft), cand) in enumerate(zip(feats, cand_t)):
        jc = jnp.asarray(cand_j[i])
        jt = jham.match_table(ft.desc, jham.sub_index_for_slides(di, jc, k), len(cand), k, slide_ids=jc)
        tt = tham.match_table(tft.desc, ti.desc_index, s, k, slide_ids=cand)
        for name in ("dist", "train", "slide_ids", "valid"):
            assert np.array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name))), name
        key = jax.random.fold_in(jax.random.key(cfg.match.ransac_seed), jnp.int32(i))
        n_cand = min(cfg.match.top_slides, len(cand))
        u = np.array(jax.random.uniform(key, (n_cand, cfg.match.ransac_iters, 2)))
        got = tom.cascade_from_table(
            to_small_image(torch.from_numpy(frames[i].astype(np.float32))), HW,
            torch.from_numpy(u), tft, tt, ti.pts, ti.smalls, HW, tcfg,
        )
        assert int(got.slide) == int(want.slide[i]), i
        assert float(got.rating) == float(want.rating[i]), i
        w_sim = float(want.similarity[i])
        if np.isfinite(w_sim):
            assert abs(float(got.similarity) - w_sim) <= 1e-4, i
        else:
            assert float(got.similarity) == w_sim, i


@functools.lru_cache(maxsize=1)
def k200_inputs():
    """12 slides (slide 3 blank: no valid slot), 6 warped frames of slides
    0, 1, 2, 4, 6, 9 and a noise frame, a small ORB config at K = 200 with
    the screening limit lowered to 8 slides (4 candidates, 128 queries),
    the JAX package's index (no screening tensor at that K) and the port's
    index from its arrays; built once a process."""
    rng = np.random.RandomState(5)
    n_slides = 12
    slides = _deck(rng, n_slides, HW)
    slides[3] = 0                     # a slide with no valid slot
    import cv2

    frames = []
    for s in (0, 1, 2, 4, 6, 9):
        m = cv2.getRotationMatrix2D((HW[1] / 2, HW[0] / 2), rng.uniform(-2, 2), rng.uniform(0.95, 1.0))
        fr = cv2.warpAffine(slides[s], m, (HW[1], HW[0]), borderValue=40)
        frames.append(np.clip(fr.astype(np.float32) + rng.randn(*HW), 0, 255).astype(np.uint8))
    frames.append(rng.randint(0, 256, HW).astype(np.uint8))
    frames = np.stack(frames)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        orb=OrbConfig(n_features=200, max_keypoints=200, n_levels=4, edge_threshold=32),
        match=dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=256, min_rating=20.0,
                                  screen_above_slides=8, screen_slides=4, screen_queries=128),
    )
    ji = jom.build_slide_index(jnp.asarray(slides), cfg)
    ti = tom.slide_index_from_numpy(
        np.asarray(ji.desc_index.desc), np.asarray(ji.desc_index.valid), np.asarray(ji.pts),
        np.asarray(ji.smalls), device="cpu",
    )
    return cfg, frames, ji, ti


def test_per_frame_rule_at_k_not_a_multiple_of_128():
    cfg, frames, ji, ti = k200_inputs()
    n_slides, k = ji.pts.shape[0], ji.pts.shape[1]
    tcfg = port_cfg(cfg)
    assert k == 200 and ji.desc_index.screen_desc is None  # JAX takes its per-frame rule
    meta = jfeat.pyramid_meta(*HW, cfg.orb)
    trim = dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, screen_k_per_slide=128))
    for frame in frames:
        atlas = jfeat.build_pyramid(jnp.asarray(frame).astype(jnp.float32), cfg.orb)
        feats = jfeat.describe(atlas, meta, jfeat.detect_pyramid(atlas, meta, cfg.orb), k, cfg.orb)
        want = jham._screen_slides(feats.desc, feats.score, ji.desc_index, n_slides, cfg.match)
        t = [torch.from_numpy(np.array(a)) for a in (feats.desc, feats.score, feats.valid)]
        qdesc = tham.screen_queries(*t, tcfg.match)
        got = tham.screen_slides_batched(qdesc[None], ti.desc_index, n_slides, k, tcfg.match)[0]
        assert got.tolist() == np.asarray(want).tolist()
        got = tham.screen_slides_frame(t[0], t[1], ti.desc_index, n_slides, k, tcfg.match)
        assert got.tolist() == np.asarray(want).tolist()
        want = jham._screen_slides(feats.desc, feats.score, ji.desc_index, n_slides, trim.match)
        got = tham.screen_slides_frame(t[0], t[1], ti.desc_index, n_slides, k, port_cfg(trim.match))
        assert got.tolist() == np.asarray(want).tolist()

    want = jom.match_frames(jnp.asarray(frames), jnp.arange(len(frames), dtype=jnp.int32), ji, HW, cfg)
    got = tom.match_frames(torch.from_numpy(frames), list(range(len(frames))), ti, HW, tcfg)
    assert got.slide.tolist() == np.asarray(want.slide).tolist() == [0, 1, 2, 4, 6, 9, -1]

    # Trimmed to 128 slots, both packages take the per-frame rule.
    want = jom.match_frames(jnp.asarray(frames[:1]), jnp.zeros((1,), jnp.int32), ji, HW, trim)
    got = tom.match_frames(torch.from_numpy(frames[:1]), [0], ti, HW, port_cfg(trim))
    assert got.slide.tolist() == np.asarray(want.slide).tolist()
