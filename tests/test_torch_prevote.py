"""The port's strided pre-vote of stage-1 screening (``screen_prevote``).

Same numpy inputs through the JAX package and ``slideo_tpu_torch`` on the
CPU. JAX's ``screen_slides_batched`` runs the Pallas screening kernel in
interpret mode, on a screening tensor attached by hand as in
``test_torch_screen.py``. Every comparison is exact: int32 scores and int32
slide ids, arrays in order, not sets.

(a) The two new plain forms of K5 (b) equal the Pallas kernel at its two
    new call sites: strided (``hamming.py:564``, the slot axis of the
    screening tensor sliced with a stride) and listed (``:584``, each
    frame's rows against its own gathered sub-tensor).
(b) ``screen_slides_batched`` with the pre-vote gives JAX's [B, C] array:
    on ``test_hamming.py``'s pre-vote inputs, on a deck of repeated slides,
    and on a deck where the re-vote ties two slides that the pre-vote
    ordered against their ids (the candidates follow the pre-vote's order).
(c) Where JAX's guard falls through (no more slides than the pre-vote
    keeps, or K not a multiple of 128 * stride), the single stage's
    candidates.
(d) The config refuses more ``screen_slides`` than ``screen_prevote_slides``.
(e) ``match_frames`` and ``MatchingEngine`` on the 100-slide deck (K = 384,
    stride 3) assign JAX's slides, and the port's path ran both forms.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.models import orb_matcher as jom
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops.pallas_table import match_table_scores_pallas
from slideo_tpu_torch import config as tconfig
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.models import orb_matcher as tom
from slideo_tpu_torch.ops import cuda_screen
from slideo_tpu_torch.ops import hamming as tham
from test_torch_config import port_cfg
from test_torch_screen import HW, _jax_index, _near, _pm1, _port_index, _screen_both, deck100_inputs

torch.set_num_threads(1)

_SD = 160   # rows of the TPU kernel's screening tensor (hamming.py _SCREEN_D)


def _pallas_best(query: np.ndarray, screen_desc, n_cols: int, n_slots: int) -> np.ndarray:
    """The TPU kernel's stage-1 call as ``screen_slides_batched`` makes it:
    query prefixes [R, 128] padded with two +1 columns against a screening
    tensor [n_cols, 160, n_slots]; interpret mode."""
    r = query.shape[0]
    qp = jnp.concatenate([jnp.asarray(query), jnp.ones((r, 2), jnp.int8),
                          jnp.zeros((r, _SD - 130), jnp.int8)], axis=1)
    best, _ = match_table_scores_pallas(
        qp, screen_desc, jnp.zeros((n_cols * n_slots,), jnp.float32), n_cols, n_slots,
        dtype=jnp.int8, with_arg=False, transposed=True, skip_bias=True, interpret=True,
    )
    return np.asarray(best).astype(np.int32)


def _index(rng, s: int, k: int):
    """A +-1 deck [S, K, 256] with 25% of slots invalid (zeroed), slide 1
    with no valid slot, slide 2 valid only at odd slots (so never at a
    stride-4 slot)."""
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.25
    valid[1] = False
    valid[2, ::2] = False
    desc[~valid] = 0
    return desc, valid


def test_strided_plain_equals_pallas_prevote():
    """Stage 1a's call: every 4th slot of every slide, S = 24, K = 512,
    through ``build_screen_desc``'s tensor sliced as ``hamming.py:559-562``
    slices it."""
    rng = np.random.RandomState(21)
    s, k, stride, r = 24, 512, 4, 70
    desc, valid = _index(rng, s, k)
    query = _pm1(rng, r, 128)
    query[[5, 33]] = 0                      # invalid query rows are all zero
    desc[6, 8, :128] = query[0]             # an exact hit at a strided slot ...
    valid[6, 8] = True
    desc[7, 9, :128] = query[1]             # ... and one between two of them
    valid[7, 9] = True
    sd = _jax_index(desc, valid).screen_desc[:, :, ::stride]
    want = _pallas_best(query, sd, s, k // stride)
    ti = _port_index(desc, valid)
    got = cuda_screen.screen_scores(torch.from_numpy(query), ti.desc, ti.valid, s, k,
                                    stride=stride).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got[:, [1, 2]] == -254).all() and got[0, 6] == 128 and got[1, 7] < 128


@pytest.mark.parametrize("rows", [40, 7])
def test_listed_plain_equals_pallas_revote(rows):
    """Stage 1b's call: each group of ``rows`` query rows against its own P
    slides, the Pallas kernel on the sub-tensor gathered as
    ``hamming.py:572-586`` gathers it. The lists repeat a slide, name the
    slide without a valid slot, and differ between groups."""
    rng = np.random.RandomState(22 + rows)
    s, k = 12, 256
    desc, valid = _index(rng, s, k)
    ids = np.array([[3, 1, 3, 0, 11], [5, 5, 5, 5, 5], [2, 10, 1, 4, 7]], np.int32)
    g, p = ids.shape
    query = _pm1(rng, g * rows, 128)
    query[::6] = 0
    desc[ids[1, 0], 17, :128] = query[rows]   # group 1's first row hits its slide
    valid[ids[1, 0], 17] = True
    sd = _jax_index(desc, valid).screen_desc
    want = np.concatenate([
        _pallas_best(query[i * rows:(i + 1) * rows], sd[jnp.asarray(ids[i])], p, k)
        for i in range(g)
    ])
    ti = _port_index(desc, valid)
    got = cuda_screen.screen_scores(torch.from_numpy(query), ti.desc, ti.valid, s, k,
                                    slide_ids=torch.from_numpy(ids)).numpy()
    assert got.shape == (g * rows, p) and np.array_equal(got, want)
    assert (got[:, [1]][:rows] == -254).all() and got[rows, 0] == 128


def _prevote_cfg(**fields):
    return dataclasses.replace(DEFAULT_CONFIG.match, screen_prevote=True, **fields)


def _hamming_prevote_inputs():
    """``test_hamming.py:test_screen_prevote_keeps_true_slide``'s inputs and
    config: 24 slides x 512 slots, 4 frames of 32 noisy copies of one
    slide's valid slots."""
    rng = np.random.RandomState(7)
    s, k = 24, 512
    cfg = _prevote_cfg(screen_slides=6, screen_queries=32, screen_prevote_slides=8,
                       screen_prevote_k_stride=4, screen_prevote_queries=16)
    d = rng.choice(np.array([-1, 1], np.int8), size=(s * k, 256)).reshape(s, k, 256)
    valid = rng.rand(s, k) > 0.15
    d = np.where(valid[..., None], d, 0).astype(np.int8)
    b, qs = 4, cfg.screen_queries
    true_slides = [rng.randint(s) for _ in range(b)]
    qdesc = np.stack([
        np.where(rng.rand(qs, 256) < 0.04, -1, 1).astype(np.int8)
        * d[t, rng.choice(np.where(valid[t])[0], qs, replace=False)]
        for t in true_slides
    ])
    return qdesc, d, valid, cfg, true_slides


def _repeated_inputs():
    """10 random slides repeated 4 times (40 slides, K = 512): votes tie in
    groups of 4 at both stages, and the lowest index wins each tie."""
    rng = np.random.RandomState(31)
    k = 512
    desc = np.tile(_pm1(rng, 10, k, 256), (4, 1, 1))
    valid = np.tile(rng.rand(10, k) > 0.2, (4, 1))
    desc[~valid] = 0
    qdesc = np.stack([_near(rng, desc[t, rng.choice(k, 48)], int(rng.randint(6, 24)))
                      for t in (3, 7, 0)])
    qdesc[1, :4] = 0
    cfg = _prevote_cfg(screen_slides=8, screen_queries=48, screen_prevote_slides=12,
                       screen_prevote_k_stride=4, screen_prevote_queries=16)
    return qdesc, desc, valid, cfg, None


def _order_inputs():
    """Two slides that the full-K re-vote ties but the pre-vote does not:
    slide 25 holds copies of frame 0's queries at both slot 4j and 4j + 1,
    slide 4 the same rows with slot 4j invalid, the rest of both slides the
    same. At full K the two have the same valid rows (25's duplicates add
    nothing), so every query scores them alike; at the stride-4 slots only
    25 holds the copies, so the pre-vote ranks 25 before 4. The re-vote's
    tie then keeps that order: 25 before 4, not slide id order."""
    rng = np.random.RandomState(41)
    s, k, qs = 30, 512, 64
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.1
    queries = _pm1(rng, 2, qs, 256)
    desc[25] = desc[4]
    valid[25] = valid[4]
    slots = 4 * np.arange(qs) + 64
    for sl in (4, 25):
        desc[sl, slots] = desc[sl, slots + 1] = queries[0]
        valid[sl, slots] = valid[sl, slots + 1] = True
    valid[4, slots] = False
    desc[~valid] = 0
    desc[11, 3:3 + qs] = queries[1]          # frame 1 finds slide 11 alone
    valid[11, 3:3 + qs] = True
    cfg = _prevote_cfg(screen_slides=6, screen_queries=qs, screen_prevote_slides=10,
                       screen_prevote_k_stride=4, screen_prevote_queries=32)
    return queries, desc, valid, cfg, [25, 11]


@pytest.mark.parametrize("inputs", [_hamming_prevote_inputs, _repeated_inputs, _order_inputs],
                         ids=["hamming", "repeated", "order"])
def test_prevote_same_candidates_as_jax(inputs):
    qdesc, desc, valid, cfg, true_slides = inputs()
    want, got = _screen_both(qdesc, desc, valid, cfg)
    assert want.shape == got.shape == (qdesc.shape[0], cfg.screen_slides)
    assert np.array_equal(got, want)
    if true_slides is not None:
        assert got[:, 0].tolist() == true_slides
    if inputs is _order_inputs:
        row = got[0].tolist()
        assert row[:2] == [25, 4]           # the tie keeps the pre-vote's order
    if inputs is _repeated_inputs:
        assert got[0, :4].tolist() == [3, 13, 23, 33]


@pytest.mark.parametrize("n_slides, k, stride", [(24, 512, 4), (40, 384, 4)],
                         ids=["n_slides<=P", "K%(128*stride)"])
def test_prevote_falls_through_to_single_stage(n_slides, k, stride):
    """JAX's guard: with no more slides than P = 24 or with K = 384 not a
    multiple of 128 * 4, the single stage runs: JAX's candidates, and the
    port's own single-stage candidates."""
    rng = np.random.RandomState(n_slides + k)
    desc, valid = _index(rng, n_slides, k)
    qdesc = np.stack([_near(rng, desc[t, rng.choice(np.where(valid[t])[0], 40)], 12)
                      for t in (5, 17)])
    cfg = _prevote_cfg(screen_queries=40, screen_prevote_slides=24,
                       screen_prevote_k_stride=stride, screen_prevote_queries=16)
    want, got = _screen_both(qdesc, desc, valid, cfg)
    assert np.array_equal(got, want)
    single = tham.screen_slides_batched(
        torch.from_numpy(qdesc), _port_index(desc, valid), n_slides, k,
        port_cfg(dataclasses.replace(cfg, screen_prevote=False)))
    assert np.array_equal(single.numpy(), got)
    assert got[:, 0].tolist() == [5, 17]


def test_config_refuses_more_candidates_than_the_prevote_keeps():
    with pytest.raises(ValueError, match="screen_slides=65 > screen_prevote_slides=64"):
        tconfig.MatchConfig(screen_prevote=True, screen_slides=65)
    tconfig.MatchConfig(screen_prevote=True, screen_slides=64)
    tconfig.MatchConfig(screen_prevote=False, screen_slides=65)


@pytest.fixture(scope="module")
def deck100_prevote():
    """``test_torch_screen``'s 100-slide deck with the pre-vote on: K = 384
    = 128 * 3, so stride 3 passes JAX's guard, and 100 > 32 slides."""
    cfg, slides, frames, index = deck100_inputs(
        screen_prevote=True, screen_prevote_k_stride=3, screen_prevote_slides=32)
    seeds = jnp.arange(len(frames), dtype=jnp.int32)
    want = jom.match_frames(jnp.asarray(frames), seeds, index, HW, cfg)   # batched path
    return cfg, slides, frames, np.asarray(want.slide).tolist()


def test_engine_with_prevote_same_slides(deck100_prevote, monkeypatch):
    cfg, slides, frames, want = deck100_prevote
    tcfg = port_cfg(cfg)
    calls = []
    screen = tham.screen_scores

    def spy(query, desc, valid, n_slides, k_per_slide, stride=1, slide_ids=None):
        calls.append((stride, None if slide_ids is None else tuple(slide_ids.shape)))
        return screen(query, desc, valid, n_slides, k_per_slide, stride, slide_ids)

    monkeypatch.setattr(tham, "screen_scores", spy)
    pages = [PdfPage(Path("deck.pdf"), "h", Path(f"p-{i + 1}.png"), i + 1)
             for i in range(len(slides))]
    engine = MatchingEngine(tcfg, pages, device="cpu", page_grays=slides)
    got = tom.match_frames(torch.from_numpy(frames), list(range(len(frames))), engine.index, HW,
                           tcfg)
    assert got.slide.tolist() == want and min(want) >= 0
    assert calls == [(3, None), (1, (len(frames), 32))]

    samples = [(i, 5.0 * i, f) for i, f in enumerate(frames)]
    timeline = engine.match_samples(samples, total_ms=15000, total_frames=len(frames))
    expected = [(5000 * i, s + 1) for i, s in enumerate(want)
                if i == 0 or s != want[i - 1]] + [(15000, None)]
    assert [(m.video_ms, m.page.page_nr if m.page else None) for m in timeline] == expected
