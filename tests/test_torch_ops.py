"""Parity of the PyTorch port's image, pyramid and FAST ops with the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and its
counterpart in ``slideo_tpu_torch``. On a CPU tensor the port's FAST wrapper
takes its plain version, which kernel K1 (csrc/fast.cu) is held to on the
card; here that plain version is held to both the XLA FAST of the JAX
package and its Pallas kernel in interpret mode.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.ops import fast as jfast
from slideo_tpu.ops import features as jfeat
from slideo_tpu.ops import image as jimage
from slideo_tpu.ops.pallas_fast import fast_scores_pallas
from slideo_tpu_torch.ops import cuda_fast
from slideo_tpu_torch.ops import features as tfeat
from slideo_tpu_torch.ops import image as timage
from test_torch_config import port_cfg

torch.set_num_threads(1)

ORB = dataclasses.replace(
    DEFAULT_CONFIG.orb, n_features=256, max_keypoints=256, n_levels=4, edge_threshold=32,
)
TORB = port_cfg(ORB)


def _scene(seed: int, h: int = 240, w: int = 320) -> np.ndarray:
    """Slide-like uint8 page: white background, dark text-like boxes."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 255, np.uint8)
    for _ in range(40):
        y, x = rng.randint(8, h - 20), rng.randint(8, w - 40)
        img[y:y + rng.randint(3, 12), x:x + rng.randint(6, 40)] = rng.randint(0, 200)
    return img


@pytest.fixture(scope="module")
def atlas_pair():
    """One scene's pyramid atlas from both packages (bf16 stored)."""
    img = _scene(0)
    aj = np.asarray(jfeat.build_pyramid(jnp.asarray(img, jnp.float32), ORB).astype(jnp.float32))
    at = tfeat.build_pyramid(torch.from_numpy(img).to(torch.float32), TORB)
    return img, aj, at


@pytest.mark.parametrize("area", [True, False])
@pytest.mark.parametrize("shape,out_hw", [((240, 320), (103, 137)), ((2, 97, 131), (61, 80))])
def test_resize_matches_jax(area, shape, out_hw):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32) * 255
    want = np.asarray(jimage.resize(jnp.asarray(x), out_hw, area=area))
    got = timage.resize(torch.from_numpy(x), out_hw, area=area).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_small_image_and_similarity_match_jax():
    a = _scene(1, 240, 320).astype(np.float32)
    b = _scene(2, 240, 320).astype(np.float32)
    assert timage.small_size(1080, 1920) == jimage.small_size(1080, 1920)
    sa_j = np.asarray(jimage.to_small_image(jnp.asarray(a)))
    sa_t = timage.to_small_image(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(sa_t, sa_j, rtol=1e-5, atol=1e-3)
    sb_j = np.array(jimage.to_small_image(jnp.asarray(b)))
    sa_j = np.array(sa_j)
    pairs = {1: (sa_j, sb_j), 3: (np.stack([sa_j, sb_j, sa_j], -1), np.stack([sb_j] * 3, -1))}
    for ch, (x, y) in pairs.items():
        want = float(jimage.compute_similarity(jnp.asarray(x), jnp.asarray(y), channels=ch))
        got = float(timage.compute_similarity(torch.from_numpy(x), torch.from_numpy(y), channels=ch))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n_out,n_in", [(200, 240), (267, 320), (900, 1080), (1600, 1920)])
def test_resize_65_weights_bit_equal(n_out, n_in):
    want = np.asarray(jfeat._resize_65_weights(n_out, n_in))
    assert np.array_equal(tfeat._resize_65_weights(n_out, n_in), want)


@pytest.mark.parametrize("hw", [(240, 320), (1080, 1920), (720, 1280), (173, 131)])
def test_pyramid_meta_equal(hw):
    for cfg in (ORB, DEFAULT_CONFIG.orb):
        assert tuple(tfeat.pyramid_meta(*hw, port_cfg(cfg))) == tuple(jfeat.pyramid_meta(*hw, cfg))


def test_build_pyramid_matches_jax(atlas_pair):
    """Level 0 (integer pixels) is bit-equal. Upper levels come from f32
    matmuls whose summation order may differ from XLA's by an f32 ulp before
    the bf16 store, so they may differ by at most one bf16 ulp."""
    img, aj, at = atlas_pair
    got = at.to(torch.float32).numpy()
    assert at.dtype == torch.bfloat16 and got.shape == aj.shape
    h = img.shape[0]
    assert np.array_equal(got[:h], aj[:h])
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(aj), 1e-30))) - 7)
    assert (np.abs(got - aj) <= ulp).all()


def test_fast_plain_bit_equal_to_xla_and_pallas(atlas_pair):
    _, aj, at = atlas_pair
    bf = jnp.asarray(aj).astype(jnp.bfloat16)
    xla = np.asarray(jfast.nms3x3(jfast.fast_scores(bf, 20)))
    pallas = np.asarray(fast_scores_pallas(bf, 20, interpret=True))
    got = cuda_fast.fast_score_map(at, 20).numpy()
    assert (got > 0).sum() > 100  # the scene has corners
    assert np.array_equal(got, xla)
    assert np.array_equal(got, pallas)


def test_fast_plain_structured_shapes():
    """Odd shapes and a flat-topped structure (ring and NMS ties)."""
    img = np.zeros((131, 173), np.float32)
    img[30:90, 40:150] = 200
    img[50:60, 80:90] = 30
    img[100:103, 10:13] = 90
    bf = jnp.asarray(img).astype(jnp.bfloat16)
    want = np.asarray(jfast.nms3x3(jfast.fast_scores(bf, 20)))
    got = cuda_fast.fast_score_map(torch.from_numpy(img).to(torch.bfloat16), 20).numpy()
    assert (want > 0).sum() > 0
    assert np.array_equal(got, want)


def test_detect_from_scores_identical(atlas_pair):
    _, aj, at = atlas_pair
    meta_j = jfeat.pyramid_meta(240, 320, ORB)
    meta_t = tfeat.pyramid_meta(240, 320, TORB)
    scores = cuda_fast.fast_score_map(at, 20).numpy()
    want = jfeat.detect_from_scores(jnp.asarray(scores), meta_j, ORB)
    got = tfeat.detect_from_scores(torch.from_numpy(scores), meta_t, TORB)
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def test_detect_from_scores_tie_order():
    """Integer scores tie constantly: equal scores must come out in
    ascending flat index, as jax.lax.top_k / approx_max_k on the CPU."""
    meta = tfeat.pyramid_meta(240, 320, TORB)
    rng = np.random.RandomState(5)
    scores = np.zeros(meta.atlas_hw, np.float32)
    mask = rng.rand(*meta.atlas_hw) < 0.05
    scores[mask] = rng.randint(21, 25, mask.sum()).astype(np.float32)
    want = jfeat.detect_from_scores(jnp.asarray(scores), jfeat.pyramid_meta(240, 320, ORB), ORB)
    got = tfeat.detect_from_scores(torch.from_numpy(scores), meta, TORB)
    for name, w, g in zip(want._fields, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def test_wrapper_refuses_other_devices():
    """A wrapper takes the plain version only for a CPU tensor."""
    img = torch.zeros((16, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fast.fast_score_map(img, 20)
