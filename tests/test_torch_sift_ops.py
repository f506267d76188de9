"""Parity of the port's SIFT-engine ops with the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
counterpart in ``slideo_tpu_torch``: the Gaussian blur, ``extract_sift``,
the homography and its RANSAC (with JAX's threefry draws injected), the
float table and its bf16 screening, the per-slide Lowe selection, and the
homography verification, whose sampling is kernel K6h's plain version on a
CPU tensor. Also here: the per-frame screened table trims stage 1 to a
``screen_k_per_slide`` below K as JAX's does, and a decode error in the
prefetch thread reaches the consumer.
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
from slideo_tpu.ops import homography as jhg
from slideo_tpu.ops import image as jimage
from slideo_tpu.ops import select as jselect
from slideo_tpu.ops import verify as jverify
from slideo_tpu.ops.sift import extract_sift as jextract
from slideo_tpu_torch.io import video as tvideo
from slideo_tpu_torch.ops import hamming as tham
from slideo_tpu_torch.ops import homography as thg
from slideo_tpu_torch.ops import image as timage
from slideo_tpu_torch.ops import select as tselect
from slideo_tpu_torch.ops import verify as tverify
from slideo_tpu_torch.ops.sift import _octave_quotas
from slideo_tpu_torch.ops.sift import extract_sift as textract
from test_torch_config import port_cfg

torch.set_num_threads(1)

# The cfg of tests/test_sift.py:17-26.
SIFT = dataclasses.replace(DEFAULT_CONFIG.sift, max_keypoints=256, n_octaves=3, border=24)
MATCH = dataclasses.replace(
    DEFAULT_CONFIG.match, ransac_iters=512, max_matches_per_slide=128, min_rating=15.0
)


def _textured(seed: int = 0) -> np.ndarray:
    """The textured image of tests/test_sift.py:29-37: flat rectangles of
    random brightness on black, 240 x 320 float32."""
    rng = np.random.RandomState(seed)
    img = np.zeros((240, 320), np.float32)
    for _ in range(25):
        y, x = rng.randint(40, 200), rng.randint(40, 280)
        img[y:y + rng.randint(4, 14), x:x + rng.randint(6, 30)] = rng.randint(80, 255)
    return img


@pytest.mark.parametrize("ksize,sigma,shape", [(9, 1.6, (240, 320)), (9, 3.2, (2, 61, 97)), (7, 2.0, (45, 60))])
def test_gaussian_blur_matches_jax(ksize, sigma, shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32) * 255
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(x), ksize, sigma))
    got = timage.gaussian_blur(torch.from_numpy(x), ksize, sigma).numpy()
    # The two libraries sum the 9 taps of each pass in different orders
    # (an f32 rounding of ~1e-5 relative on a 0-255 scale).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _features(img: np.ndarray):
    want = jax.jit(lambda im: jextract(im, SIFT))(jnp.asarray(img))
    got = textract(torch.from_numpy(img), port_cfg(SIFT))
    return [np.asarray(f) for f in want], [f.numpy() for f in got]


def test_extract_sift_matches_jax_on_noisy_texture():
    """The textured image with camera noise (sigma 2, the frames' regime):
    no exact ties between neighbours, so the same valid slots at the same
    integer positions, pts within 1e-3 px, desc within 1e-4, score within
    1e-4 relative (blur sums in another order, see above)."""
    img = _textured() + np.random.RandomState(5).randn(240, 320).astype(np.float32) * 2
    (jp, jd, js, jsc, jv), (tp, td, ts, tsc, tv) = _features(img)
    assert jv.sum() > 200
    assert np.array_equal(tv, jv)
    assert np.array_equal(np.rint(tp / tsc[:, None]), np.rint(jp / jsc[:, None]))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=0)
    assert np.array_equal(tsc, jsc)


def _keypoints(pts, scale, valid, lo, hi) -> dict:
    """Integer octave position -> slot of the valid keypoints in [lo, hi)."""
    return {
        tuple(np.rint(pts[i] / scale[i]).astype(int)): i for i in range(lo, hi) if valid[i]
    }


def test_extract_sift_clean_texture_flips_apart():
    """The clean textured image is made of flat rectangles, so DoG values of
    neighbours, subpixel Hessians and 36-bin orientation histograms tie
    EXACTLY, and the blurs' last-bit differences (above) break those ties
    differently: a few keypoints appear in one package only, and on some
    shared keypoints the winning DoG level (the score), the subpixel offset
    or the dominant orientation (the descriptor) flips. Shown here: each
    octave's sets agree on at least 80% of their keypoints, at the same
    octave scale; shared keypoints that differ (score beyond 1e-4 relative,
    pts beyond 1e-3 px or desc beyond 1e-4) are counted apart and stay a
    minority; the rest agree at those tolerances by construction of the
    count."""
    (jp, jd, js, jsc, jv), (tp, td, ts, tsc, tv) = _features(_textured())
    lo = 0
    flips = 0
    shared_total = 0
    for kq in _octave_quotas(port_cfg(SIFT)):
        jk = _keypoints(jp, jsc, jv, lo, lo + kq)
        tk = _keypoints(tp, tsc, tv, lo, lo + kq)
        shared = set(jk) & set(tk)
        only = (set(jk) - set(tk)) | (set(tk) - set(jk))
        print(f"octave slots [{lo}, {lo + kq}): {len(jk)} JAX, {len(tk)} port, "
              f"{len(shared)} shared, in one package only: {sorted(only)}")
        assert len(shared) >= 0.8 * max(len(jk), len(tk))
        for key in shared:
            i, j = jk[key], tk[key]
            assert jsc[i] == tsc[j]
            flips += int(
                abs(ts[j] - js[i]) > 1e-4 * js[i]
                or np.abs(tp[j] - jp[i]).max() > 1e-3
                or np.abs(td[j] - jd[i]).max() > 1e-4
            )
        shared_total += len(shared)
        lo += kq
    print(f"shared keypoints that differ: {flips} of {shared_total}")
    assert shared_total > 100 and flips < shared_total // 2


def test_apply_homography_matches_jax():
    rng = np.random.RandomState(2)
    h = np.array([[0.9, 0.05, 30, -0.03, 0.95, 20, 1e-4, -5e-5],
                  [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1 / 64, 0.0]], np.float32)
    pts = (rng.rand(2, 50, 2) * [1600, 900]).astype(np.float32)
    pts[1, :3] = [[64, 0], [64, 7], [0, 0]]        # w = 0 exactly: the 1e-8 clamp
    want = np.asarray(jhg.apply_homography(jhg.Homography(jnp.asarray(h[:, None])), jnp.asarray(pts)))
    got = thg.apply_homography(thg.Homography(torch.from_numpy(h)[:, None]), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.abs(got[1, 0]).max() > 1e9   # divided by +1e-8


def _ransac_case(n_valid: int):
    """The data of tests/test_sift.py::test_ransac_homography_vs_cv2 (100
    matches, 30 outliers) as two candidates, the second with only its first
    ``n_valid`` matches valid."""
    rng = np.random.RandomState(0)
    h_true = np.array([[0.9, 0.05, 30], [-0.03, 0.95, 20], [1e-4, -5e-5, 1.0]], np.float64)
    n = 100
    src = rng.rand(n, 2).astype(np.float32) * np.array([1600, 900])
    ones = np.ones((n, 1), np.float32)
    proj = np.hstack([src, ones]) @ h_true.T
    dst = (proj[:, :2] / proj[:, 2:]).astype(np.float32)
    dst += rng.randn(n, 2).astype(np.float32) * 0.5
    dst[:30] = rng.rand(30, 2) * np.array([1600, 900])
    src2, dst2 = np.stack([src, src[::-1]]), np.stack([dst, dst[::-1]])
    valid = np.ones((2, n), bool)
    valid[1, n_valid:] = False
    tol = np.where(rng.rand(2, n) < 0.3, 2.0, 1.0).astype(np.float32)
    return src2.astype(np.float32), dst2.astype(np.float32), valid, tol


@pytest.mark.parametrize("n_valid,with_tol", [(100, False), (60, True), (3, False)])
def test_ransac_homography_with_injected_draws(n_valid, with_tol):
    src, dst, valid, tol = _ransac_case(n_valid)
    u = jax.random.uniform(jax.random.key(0), (2, MATCH.ransac_iters, 4))
    jtol = jnp.asarray(tol) if with_tol else None
    want = jhg.ransac_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                                 jax.random.key(0), MATCH, tol=jtol)
    got = thg.ransac_homography(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        torch.from_numpy(np.array(u)), port_cfg(MATCH),
        tol=torch.from_numpy(tol) if with_tol else None,
    )
    assert np.array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert np.array_equal(got.rating.numpy(), np.asarray(want.rating))
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert bool(got.ok[0]) and got.rating[0] >= 65
    assert bool(got.ok[1]) == (n_valid >= 4)
    # Two LAPACK solves of the same 8x8 systems round apart; the refined
    # homographies agree to 1e-3 relative, each parameter against its
    # largest magnitude over the candidates.
    wh, gh = np.asarray(want.transform.h), got.transform.h.numpy()
    assert (np.abs(gh - wh) <= 1e-3 * np.abs(wh).max(axis=0)).all(), (gh, wh)


def _unit_rows(rng, n: int, d: int = 128) -> np.ndarray:
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _float_index(rng, s: int, k: int):
    desc = _unit_rows(rng, s * k)
    valid = rng.rand(s * k) > 0.2
    valid[k:2 * k] = False              # slide 1: no valid slot
    valid[2 * k:3 * k] = False
    valid[2 * k + 5] = True             # slide 2: one valid slot (dist2 from _NEG)
    desc[~valid] = 0
    return desc, valid


@pytest.mark.parametrize("n_slides,listed", [(11, None), (20, [4, 2, 2, 19, 0, 1])])
def test_match_table_float_matches_jax(n_slides, listed):
    rng = np.random.RandomState(3)
    k, q = 40, 70
    desc, valid = _float_index(rng, n_slides, k)
    query = _unit_rows(rng, q)
    query[:10] = desc[3 * k:3 * k + 10] + 0.01 * _unit_rows(rng, 10)   # near neighbours
    if listed is None:
        want = jham.match_table_float(jnp.asarray(query), jnp.asarray(desc), jnp.asarray(valid), n_slides, k)
        got = tham.match_table_float(torch.from_numpy(query), torch.from_numpy(desc),
                                     torch.from_numpy(valid), n_slides, k)
    else:
        cand = jnp.asarray(listed, jnp.int32)
        dsub, vsub = jham.sub_desc_for_slides(jnp.asarray(desc), jnp.asarray(valid), cand, k)
        want = jham.match_table_float(jnp.asarray(query), dsub, vsub, len(listed), k, slide_ids=cand)
        got = tham.match_table_float(torch.from_numpy(query), torch.from_numpy(desc),
                                     torch.from_numpy(valid), n_slides, k,
                                     slide_ids=torch.tensor(listed, dtype=torch.int32))
    assert np.array_equal(got.train.numpy(), np.asarray(want.train))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert np.array_equal(got.slide_ids.numpy(), np.asarray(want.slide_ids))
    # The f32 dot products are summed in another order (1e-7 relative);
    # sqrt(2 - 2 dot) magnifies that near dot = 1 to ~1e-6.
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.dist2.numpy(), np.asarray(want.dist2), rtol=0, atol=1e-5)
    if listed is None:
        assert (got.dist2[:, 2] > 1e4).all()   # one valid slot: no second neighbour


def test_screen_slides_float_matches_jax():
    rng = np.random.RandomState(4)
    n_slides, k, q = 100, 24, 300
    desc, valid = _float_index(rng, n_slides, k)
    query = _unit_rows(rng, q)
    # 60 queries near slide 37's descriptors, 30 near slide 80's.
    query[:60] = desc[37 * k + np.arange(60) % k] + 0.2 * _unit_rows(rng, 60)
    query[60:90] = desc[80 * k + np.arange(30) % k] + 0.2 * _unit_rows(rng, 30)
    query /= np.linalg.norm(query, axis=1, keepdims=True)
    score = rng.rand(q).astype(np.float32)
    score[::7] = -1.0
    assert n_slides > MATCH.screen_above_slides
    want = jham.screen_slides_float(jnp.asarray(query), jnp.asarray(score), jnp.asarray(desc),
                                    jnp.asarray(valid), n_slides, k, MATCH)
    got = tham.screen_slides_float(torch.from_numpy(query), torch.from_numpy(score),
                                   torch.from_numpy(desc), torch.from_numpy(valid), n_slides, k,
                                   port_cfg(MATCH))
    assert got.tolist() == np.asarray(want).tolist()
    assert set(got[:2].tolist()) == {37, 80}


def test_select_candidates_lowe_matches_jax():
    rng = np.random.RandomState(6)
    n_slides, k, q = 50, 32, 200
    desc, valid = _float_index(rng, n_slides, k)
    query = _unit_rows(rng, q)
    for s, rows in ((7, slice(0, 80)), (21, slice(80, 110)), (33, slice(110, 120))):
        n = rows.stop - rows.start
        query[rows] = desc[s * k + np.arange(n) % k] + 0.3 * _unit_rows(rng, n)
    query /= np.linalg.norm(query, axis=1, keepdims=True)
    qvalid = rng.rand(q) > 0.1
    want_table = jham.match_table_float(jnp.asarray(query), jnp.asarray(desc), jnp.asarray(valid),
                                        n_slides, k)
    table = tham.MatchTable(*(None if f is None else torch.from_numpy(np.array(f)) for f in want_table))
    cfg = dataclasses.replace(MATCH, top_slides=12, max_matches_per_slide=64)
    want = jselect.select_candidates_lowe(want_table, jnp.asarray(qvalid), cfg, SIFT.lowe_ratio)
    got = tselect.select_candidates_lowe(table, torch.from_numpy(qvalid), port_cfg(cfg), SIFT.lowe_ratio)
    for name in want._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    # Slide 2's one valid slot has no second neighbour, so Lowe keeps it
    # for every query: it ranks first, then the three planted slides.
    assert got.slide_ids[:4].tolist() == [2, 7, 21, 33]


def _warp_case():
    """A 360 x 480 noise frame, 5 slide thumbnails of 150 x 200 and 4
    candidate homographies: one mapped partly outside the frame, one with a
    perspective whose denominator is exactly 0 on a grid column."""
    rng = np.random.RandomState(8)
    frame = (rng.rand(360, 480) * 255).astype(np.float32)
    smalls = (rng.rand(5, 150, 200) * 255).astype(np.float32)
    h = np.array([
        [1.1, 0.02, 10, -0.01, 1.05, 12, 2e-4, 1e-4],
        [1.0, 0.0, 300, 0.0, 1.0, 40, 0.0, 0.0],          # shifted partly outside
        [1.2, 0.1, 5, 0.05, 1.1, 3, -1 / 64, 3e-3],       # w = 0 at x = 64, y = 0
        [0.9, -0.05, 30, 0.04, 0.95, 20, -5e-4, 8e-4],
    ], np.float32)
    return frame, smalls, h, np.array([0, 3, 1, 4], np.int32)


def test_warp_similarity_homography_matches_jax():
    """Homography verification, K6h's plain path: 4 candidates, one mapped
    partly outside the frame, one with a perspective whose denominator is
    exactly 0 on a grid column (the |w| <= 1e-8 clamp)."""
    frame, smalls, h, ids = _warp_case()
    slide_hw = (150, 200)   # thumbnail = page: grid x = column * stride
    want = np.asarray(jverify.warp_similarity_homography(
        jnp.asarray(frame), jhg.Homography(jnp.asarray(h)), jnp.asarray(smalls), jnp.asarray(ids),
        slide_hw, stride=2))
    tframe = torch.from_numpy(frame)
    got = tverify.warp_similarity_homography(
        timage.to_small_image(tframe), tuple(frame.shape), torch.from_numpy(h),
        torch.from_numpy(smalls), torch.from_numpy(ids), slide_hw, stride=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    grid = tverify.sample_grid((150, 200), slide_hw, frame.shape, stride=2)
    xs = np.arange(0, 200, 2, dtype=np.float32)
    ys = np.arange(0, 150, 2, dtype=np.float32)
    w_raw = h[2, 6] * xs[None, :] + h[2, 7] * ys[:, None] + np.float32(1.0)
    assert (np.abs(w_raw) <= 1e-8).sum() >= 1          # the clamp is engaged
    small = timage.to_small_image(tframe)
    warped = tverify.warp_sample_homography_plain(small, torch.from_numpy(h), grid)
    sx, sy = tverify.warp_coords_homography(torch.from_numpy(h), grid, torch.device("cpu"))
    inb = (sx >= 0) & (sx <= small.shape[1] - 1) & (sy >= 0) & (sy <= small.shape[0] - 1)
    assert (~inb[1]).any() and inb[1].any() and (~inb[2]).any()
    assert (warped[~inb] == 0).all()
    jpts = np.asarray(jhg.apply_homography(
        jhg.Homography(jnp.asarray(h)[:, None, None]),
        jnp.stack(jnp.meshgrid(jnp.asarray(xs + 0.5) * grid.sx - 0.5,
                               jnp.asarray(ys + 0.5) * grid.sy - 0.5), -1)))
    np.testing.assert_allclose(sx.numpy(), (jpts[..., 0] + 0.5) * grid.inv_fx - 0.5, rtol=1e-6)


def test_sift_verification_frame_thumbnail_keeps_default_area():
    """At a small_image_area other than the default, the slides' thumbnails
    take it and the frame's keeps the default 300 * 400, as in the JAX
    package: the winner's similarity equals JAX's best within 1e-4."""
    from slideo_tpu_torch.models import sift_matcher as tsm

    frame, smalls, h, ids = _warp_case()
    area = 150 * 200                     # the slides' thumbnails are 150 x 200
    slide_hw = (300, 400)
    cfg = dataclasses.replace(DEFAULT_CONFIG, sift=SIFT, engine="sift")
    cfg = port_cfg(dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, small_image_area=area)))
    assert timage.small_size(*slide_hw, area) == smalls.shape[1:]
    want = np.asarray(jverify.warp_similarity_homography(
        jnp.asarray(frame), jhg.Homography(jnp.asarray(h)), jnp.asarray(smalls), jnp.asarray(ids),
        slide_hw, stride=cfg.match.verify_stride))
    _, frame_small = tsm.frame_features(torch.from_numpy(frame), cfg)
    assert tuple(frame_small.shape) == timage.small_size(360, 480)
    index = tsm.SiftSlideIndex(desc=None, valid=None, pts=None, scale=None,
                               smalls=torch.from_numpy(smalls))
    rated = tsm.RatedCandidates(h=torch.from_numpy(h), slides=torch.from_numpy(ids),
                                rating=torch.full((4,), 50.0), retain=torch.ones(4, dtype=torch.bool))
    got = tsm.verify_winner(frame_small, tuple(frame.shape), rated, index, slide_hw, cfg)
    assert abs(float(got.similarity) - float(want.max())) <= 1e-4
    assert int(got.slide) == (int(ids[want.argmax()]) if want.max() > cfg.match.min_similarity else -1)


def test_match_table_frame_refuses_screen_k_per_slide_below_k():
    """No longer refused (the name is the test's from when it was):
    ``screen_k_per_slide`` below K trims the per-frame stage 1 to each
    slide's first slots, as the JAX package's ``match_table_frame`` does;
    at K the vote covers every slot. The table over the candidates equals
    JAX's."""
    rng = np.random.RandomState(356)
    s, k, q = 100, 64, 8
    desc = np.where(rng.rand(s, k, 256) > 0.5, 1, -1).astype(np.int8)
    valid = rng.rand(s, k) > 0.2
    valid[61, 40:40 + q] = True
    query = desc[61, 40:40 + q].copy()    # the frame lies in slide 61's slots 40..47
    for row in query:
        row[rng.choice(256, 10, replace=False)] *= -1
    score = rng.rand(q).astype(np.float32)
    ji = jham.build_index(jnp.asarray(desc), jnp.asarray(valid))
    ti = tham.build_index(torch.from_numpy(desc), torch.from_numpy(valid))
    cands = []
    for ksk in (32, k):
        cfg = dataclasses.replace(DEFAULT_CONFIG.match, screen_k_per_slide=ksk, screen_queries=q)
        want = jham.match_table_frame(jnp.asarray(query), jnp.asarray(score), ji, s, k, cfg)
        got = tham.match_table_frame(torch.from_numpy(query), torch.from_numpy(score), ti, s, k,
                                     port_cfg(cfg))
        assert got.dist.shape == (q, cfg.screen_slides)
        for name in ("dist", "train", "slide_ids", "valid"):
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
        cands.append(got.slide_ids.tolist())
    assert 61 not in cands[0] and cands[1][0] == 61   # the trim hides the frame's slots


def test_prefetched_reraises_decode_error():
    def frames():
        yield 1
        yield 2
        raise OSError("corrupt packet at frame 250")

    got = []
    with pytest.raises(OSError, match="corrupt packet"):
        for item in tvideo._prefetched(frames(), depth=1):
            got.append(item)
    assert got == [1, 2]
    assert list(tvideo._prefetched(iter([3, 4]))) == [3, 4]
