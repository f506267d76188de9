"""Parity of the port's table, candidate selection, RANSAC and verification.

Same numpy inputs through the JAX package and ``slideo_tpu_torch`` on the
CPU. The table's plain version (kernel K5's reference on the card) must be
bit-equal to ``hamming.match_table``, also on ``chip_smoke.py``'s
adversarial index, on which the smoke run holds the kernel bit-equal to
the plain version: together they hold the kernel's tie rule to JAX's.
RANSAC gets JAX's own uniform draws injected, since a ``torch.Generator``
cannot reproduce threefry. K6's plain version samples JAX's points.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import adversarial_table, ransac_synthetic
from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops import image as jimage
from slideo_tpu.ops import ransac as jransac
from slideo_tpu.ops import select as jselect
from slideo_tpu.ops import verify as jverify
from slideo_tpu_torch.ops import cuda_table
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


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_table_tie_rule_on_adversarial_index(seed, listed):
    """The plain table on the adversarial index (all-zero query rows tying
    every valid slot, rows duplicated across lanes, quads, slot halves and
    tiles, a slide with no valid slot, Q = 100 not a multiple of the
    kernel's 64-query tile; with ``listed`` a slide list repeating ids) is
    bit-equal to JAX's table: the first slot attaining the best wins."""
    query, desc, valid, cand = adversarial_table(seed, q=100, s=6, k=256)
    s, k, _ = desc.shape
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    if listed:
        jc = jnp.asarray(cand)
        want = jham.match_table(
            jnp.asarray(query), jham.sub_index_for_slides(ji, jc, k), len(cand), k, slide_ids=jc
        )
        ids = torch.from_numpy(cand)
    else:
        want = jham.match_table(jnp.asarray(query), ji, s, k)
        ids = None
    best, arg = cuda_table.match_table_scores_plain(torch.from_numpy(query), ti.desc, ti.valid, s, k, ids)
    assert np.array_equal(arg.numpy(), np.asarray(want.train))
    assert np.array_equal(((256.0 - best) * 0.5).numpy(), np.asarray(want.dist))
    if not listed:
        # Row 3 is copied into slots 0 and 1 of slide 3; row 0 is all zero,
        # so slide 0's first valid slot wins.
        assert int(arg[3, 3]) == 0 and float(best[3, 3]) == 256.0
        assert int(arg[0, 0]) == int(np.argmax(valid[0])) and float(best[0, 0]) == 0.0


@pytest.mark.parametrize("bad", [-1, 6])
def test_table_slide_id_out_of_range_raises(bad):
    """The plain table refuses a slide id outside [0, S) (the kernel traps)."""
    query, desc, valid, _ = adversarial_table(0, q=20, s=6, k=256)
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    with pytest.raises(ValueError, match="outside"):
        cuda_table.match_table_scores_plain(
            torch.from_numpy(query), ti.desc, ti.valid, 6, 256, torch.tensor([0, bad], dtype=torch.int32)
        )


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


# (C, M, H): the first two keep their ids from when the test took H alone;
# then every C of the cascade (one, screened 16, top 40) at a short and a
# full match list, at H under, at and over two scan chunks of 500.
RANSAC_SHAPES = [pytest.param(4, 128, h, id=str(h)) for h in (256, 512)] + [
    pytest.param(c, m, h, id=f"C{c}-M{m}-H{h}")
    for c in (1, 16, 40) for m in (90, 512) for h in (256, 512, 1200)
]


@pytest.mark.parametrize("c, m, iters", RANSAC_SHAPES)
def test_ransac_with_injected_draws(c, m, iters):
    cfg = dataclasses.replace(DEFAULT_CONFIG.match, ransac_iters=iters)
    if (c, m) == (4, 128):
        src, dst, valid = _ransac_case(iters)
    else:
        src, dst, valid = ransac_synthetic(c * m + iters, c, m)
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
    if (c, m) == (4, 128):
        assert got.ok.numpy()[:3].all() and not got.ok.numpy()[3]
    else:
        assert got.ok.numpy()[0] and got.rating.numpy()[0] >= 0.25 * valid[0].sum()


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


@pytest.mark.parametrize("stride", [1, 2])
def test_warp_sample_plain_matches_jax(stride):
    """K6's plain version (``verify.warp_sample_plain``: ``warp_coords``
    then ``_bilinear_image``) forms the points JAX's ``warp_similarity``
    forms, bit for bit, and samples JAX's thumbnail there as JAX's
    ``_bilinear_image`` does; the last candidate maps partly outside."""
    rng = np.random.RandomState(2)
    fh, fw = 240, 320
    frame = (rng.rand(fh, fw) * 255).astype(np.float32)
    slide_hw, (hs, ws) = (240, 320), (103, 137)
    t = 5
    th = np.deg2rad(rng.uniform(-3, 3, t))
    sc = rng.uniform(0.9, 1.0, t)
    a = (sc * np.cos(th)).astype(np.float32)
    b = (sc * np.sin(th)).astype(np.float32)
    tx = rng.uniform(-10, 10, t).astype(np.float32)
    ty = rng.uniform(-10, 10, t).astype(np.float32)
    tx[-1] = 150.0
    # The points, as jverify.warp_similarity forms them.
    fsh, fsw = jimage.small_size(fh, fw)
    jj = (jnp.arange(0, ws, stride, dtype=jnp.float32) + 0.5) * (slide_hw[1] / ws) - 0.5
    ii = (jnp.arange(0, hs, stride, dtype=jnp.float32) + 0.5) * (slide_hw[0] / hs) - 0.5
    gx = jnp.broadcast_to(jj[None, None, :], (1, ii.shape[0], jj.shape[0]))
    gy = jnp.broadcast_to(ii[None, :, None], (1, ii.shape[0], jj.shape[0]))
    ja, jb, jtx, jty = (jnp.asarray(f)[:, None, None] for f in (a, b, tx, ty))
    sxp = ((ja * gx - jb * gy + jtx) + 0.5) * (fsw / fw) - 0.5
    syp = ((jb * gx + ja * gy + jty) + 0.5) * (fsh / fh) - 0.5
    small = jimage.to_small_image(jnp.asarray(frame))
    want = np.asarray(jverify._bilinear_image(small, sxp.reshape(-1), syp.reshape(-1))).reshape(sxp.shape)

    grid = tverify.sample_grid((hs, ws), slide_hw, (fh, fw), stride=stride)
    tf = transac.Similarity(*map(torch.from_numpy, (a, b, tx, ty)))
    x, y = tverify.warp_coords(tf, grid, torch.device("cpu"))
    assert np.array_equal(x.numpy(), np.asarray(sxp)) and np.array_equal(y.numpy(), np.asarray(syp))
    got = tverify.warp_sample_plain(torch.from_numpy(np.array(small)), tf, grid)
    assert got.shape == want.shape == (t, len(range(0, hs, stride)), len(range(0, ws, stride)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert (want[-1] == 0).mean() > 0.3 and (want[-1] != 0).any()
