"""Parity of the port's table, candidate selection, RANSAC and verification.

Same numpy inputs through the JAX package and ``slideo_tpu_torch`` on the
CPU. The table's plain version (kernel K5's reference on the card) must be
bit-equal to ``hamming.match_table``; RANSAC gets JAX's own uniform draws
injected, since a ``torch.Generator`` cannot reproduce threefry.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops import ransac as jransac
from slideo_tpu.ops import select as jselect
from slideo_tpu.ops import verify as jverify
from slideo_tpu_torch.ops import hamming as tham
from slideo_tpu_torch.ops import ransac as transac
from slideo_tpu_torch.ops import select as tselect
from slideo_tpu_torch.ops import verify as tverify
from slideo_tpu_torch.ops.image import to_small_image
from test_torch_config import port_cfg

torch.set_num_threads(1)


def _pm1(rng, *shape) -> np.ndarray:
    return np.where(rng.rand(*shape) > 0.5, 1, -1).astype(np.int8)


def _index_case(seed: int, s: int = 6, k: int = 96, q: int = 50):
    rng = np.random.RandomState(seed)
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.3
    valid[3] = False                       # a slide with no valid slot
    query = _pm1(rng, q, 256)
    query[5] = 0                           # invalid query rows are all zero
    query[9] = 0
    desc[2, 17] = query[0]                 # an exact hit (distance 0)
    valid[2, 17] = True
    desc[4, 40] = desc[4, 10] = query[1]   # a tie: the first slot must win
    valid[4, 40] = valid[4, 10] = True
    return query, desc, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_match_table_bit_equal(seed):
    query, desc, valid = _index_case(seed)
    s, k, _ = desc.shape
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    want = jham.match_table(jnp.asarray(query), ji, s, k)
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    got = tham.match_table(torch.from_numpy(query), ti, s, k)
    for name in ("dist", "train", "slide_ids", "valid"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert int(got.train[1, 4]) == 10 and float(got.dist[0, 2]) == 0.0
    for name in ("desc", "slide_ids", "train_ids", "valid"):
        assert np.array_equal(np.asarray(getattr(ji, name)), getattr(ti, name).numpy()), name


@pytest.mark.parametrize("cand", [[4, 2, 3, 0], [5, 5, 1]])
def test_match_table_over_slide_list_bit_equal(cand):
    """Stage 2 of screened decks: the table over a frame's candidate slides
    (a slide list read in place) equals JAX's table over the sub-index
    copied for them, including a slide with no valid slot (3) and a slide
    listed twice."""
    query, desc, valid = _index_case(0)
    s, k, _ = desc.shape
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    jc = jnp.asarray(cand, jnp.int32)
    want = jham.match_table(
        jnp.asarray(query), jham.sub_index_for_slides(ji, jc, k), len(cand), k, slide_ids=jc
    )
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    got = tham.match_table(
        torch.from_numpy(query), ti, s, k, slide_ids=torch.tensor(cand, dtype=torch.int32)
    )
    for name in ("dist", "train", "slide_ids", "valid"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), name


def _tie_table(seed: int, q: int = 120, s: int = 40):
    """Integer distances from a narrow range: ties everywhere, some zeros
    (the dist-0 quirk keeps nothing), more columns than knn_k."""
    rng = np.random.RandomState(seed)
    dist = rng.randint(0, 7, (q, s)).astype(np.float32) * 2.0
    dist[rng.rand(q, s) < 0.8] += 40.0
    train = rng.randint(0, 64, (q, s)).astype(np.int32)
    svalid = np.ones(s, bool)
    svalid[7] = False
    qvalid = rng.rand(q) > 0.1
    return dist, train, svalid, qvalid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_and_compact_identical_on_ties(seed):
    dist, train, svalid, qvalid = _tie_table(seed)
    q, s = dist.shape
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, max_matches_per_slide=64)
    jt = jham.MatchTable(
        dist=jnp.asarray(dist), train=jnp.asarray(train),
        slide_ids=jnp.arange(s, dtype=jnp.int32),
        valid=jnp.broadcast_to(jnp.asarray(svalid)[None], (q, s)),
    )
    tt = tham.MatchTable(
        dist=torch.from_numpy(dist), train=torch.from_numpy(train),
        slide_ids=torch.arange(s, dtype=torch.int32),
        valid=torch.from_numpy(svalid)[None].expand(q, s),
    )
    keep_j, counts_j, cols_j = jselect.rank_candidates_table(jt, jnp.asarray(qvalid), cfg)
    keep_t, counts_t, cols_t = tselect.rank_candidates_table(tt, torch.from_numpy(qvalid), port_cfg(cfg))
    assert np.array_equal(np.asarray(keep_j), keep_t.numpy())
    assert np.array_equal(np.asarray(counts_j), counts_t.numpy())
    assert np.array_equal(np.asarray(cols_j), cols_t.numpy())
    want = jselect.compact_from_rank(jt, keep_j, counts_j, cols_j, cfg)
    got = tselect.compact_from_rank(tt, keep_t, counts_t, cols_t, port_cfg(cfg))
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def _ransac_case(seed: int, c: int = 4, m: int = 128):
    rng = np.random.RandomState(seed)
    src = (rng.rand(c, m, 2) * 400).astype(np.float32)
    dst = np.empty_like(src)
    for i in range(c):
        th = np.deg2rad(rng.uniform(-10, 10))
        sc = rng.uniform(0.85, 1.1)
        a, b = sc * np.cos(th), sc * np.sin(th)
        dst[i, :, 0] = a * src[i, :, 0] - b * src[i, :, 1] + rng.uniform(-30, 30)
        dst[i, :, 1] = b * src[i, :, 0] + a * src[i, :, 1] + rng.uniform(-30, 30)
    dst += rng.randn(c, m, 2).astype(np.float32) * 0.7
    n_out = [20, 60, 100, 0]
    for i, n in enumerate(n_out[:c]):
        dst[i, m - n:] = rng.rand(n, 2) * 400
    n_valid = [m, 90, 110, 1]                 # candidate 3 has too few points
    valid = np.arange(m)[None, :] < np.asarray(n_valid[:c])[:, None]
    return src, dst, valid


@pytest.mark.parametrize("iters", [256, 512])
def test_ransac_with_injected_draws(iters):
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=iters)
    src, dst, valid = _ransac_case(iters)
    key = jax.random.fold_in(jax.random.key(cfg.ransac_seed), 3)
    want = jransac.ransac_similarity(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key, cfg
    )
    u = np.array(jax.random.uniform(key, (src.shape[0], iters, 2)))
    got = transac.ransac_similarity(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        torch.from_numpy(u), port_cfg(cfg),
    )
    assert np.array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert np.array_equal(got.rating.numpy(), np.asarray(want.rating))
    for name, w, g in zip(want.transform._fields, want.transform, got.transform):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, err_msg=name)
    assert got.ok.numpy()[:3].all() and not got.ok.numpy()[3]


def test_uniform_draws_are_per_frame_deterministic():
    cfg = port_cfg(dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=64))
    a = transac.uniform_draws(5, cfg, 17, torch.device("cpu"))
    b = transac.uniform_draws(5, cfg, 17, torch.device("cpu"))
    c = transac.uniform_draws(5, cfg, 18, torch.device("cpu"))
    assert a.shape == (5, 64, 2) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_bilinear_plain_matches_jax():
    rng = np.random.RandomState(0)
    h, w = 57, 83
    img = (rng.rand(h, w) * 255).astype(np.float32)
    xs = rng.uniform(-5, w + 5, 3000).astype(np.float32)
    ys = rng.uniform(-5, h + 5, 3000).astype(np.float32)
    xs[:4] = [0, w - 1, 0, w - 1]
    ys[:4] = [0, 0, h - 1, h - 1]
    want = np.asarray(jverify._bilinear_image(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys)))
    got = tverify._bilinear_image(torch.from_numpy(img), torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_warp_similarity_matches_jax():
    rng = np.random.RandomState(1)
    fh, fw = 240, 320
    frame = (rng.rand(fh, fw) * 255).astype(np.float32)
    slide_hw = (240, 320)
    smalls = (rng.rand(5, 103, 137) * 255).astype(np.float32)
    t = 6
    th = np.deg2rad(rng.uniform(-5, 5, t))
    sc = rng.uniform(0.9, 1.05, t)
    a = (sc * np.cos(th)).astype(np.float32)
    b = (sc * np.sin(th)).astype(np.float32)
    tx = rng.uniform(-20, 20, t).astype(np.float32)
    ty = rng.uniform(-20, 20, t).astype(np.float32)
    cand = np.array([0, 3, 1, 4, 2, 3], np.int32)
    for stride in (1, 2):
        want = np.asarray(jverify.warp_similarity(
            jnp.asarray(frame), jransac.Similarity(*map(jnp.asarray, (a, b, tx, ty))),
            jnp.asarray(smalls), jnp.asarray(cand), slide_hw, stride=stride,
        ))
        got = tverify.warp_similarity(
            to_small_image(torch.from_numpy(frame)), (fh, fw),
            transac.Similarity(*map(torch.from_numpy, (a, b, tx, ty))),
            torch.from_numpy(smalls), torch.from_numpy(cand), slide_hw, stride=stride,
        )
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
