"""K1's exact compass pretest, and the FAST wrappers against the production
Pallas kernel.

(a) ``fast.compass_candidates``, the plain per-pixel form of the pretest
    that K1 (csrc/fast.cu) runs in every pixel, holds every pixel with a
    nonzero ``fast.fast_scores`` (before NMS) on four inputs: dense noise, a
    flat image with corner islands, the pyramid atlas of
    ``test_torch_ops``'s scene, and an image whose differences sit at
    +-threshold and at bf16 rounding edges. The kernel's arithmetic (the
    9-arc chains on the raw taps, the two differences taken after them) is
    checked against ``fast_scores`` on the same inputs.
(b) The port's ``cuda_fast.fast_score_map`` and ``fast_score_map_batch``
    on CPU tensors (their plain version) are bit-equal to the JAX Pallas
    kernel in its production form (band 64, chunk 640, polarity fused,
    sparse skip), in interpret mode, at a width that crosses a chunk.

The kernel itself runs only on the card (``chip_smoke.py`` phases 3 and 7).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.ops.pallas_fast import fast_scores_pallas, fast_scores_pallas_batch
from slideo_tpu_torch.ops import cuda_fast
from slideo_tpu_torch.ops import fast as tfast
from slideo_tpu_torch.ops import features as tfeat
from test_torch_ops import TORB, _scene

torch.set_num_threads(1)

THR = 20


def _bf16_exact(img: np.ndarray) -> np.ndarray:
    return torch.from_numpy(img.astype(np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def _dense(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    """Uniform noise 0-255: most pixels pass the pretest."""
    return np.random.RandomState(seed).randint(0, 256, (h, w)).astype(np.float32)


def _sparse(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    """A flat grey image with islands of corners every 200 columns (bright
    and dark blocks, a notch, a noise patch), a fractional band below."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 128.0, np.float32)
    for x in range(12, w - 90, 200):
        img[10:20, x:x + 18] = 220.0
        img[14:17, x + 8:x + 12] = 40.0
        img[h // 2 - 6:h // 2 + 2, x + 78:x + 85] = 10.0
        img[h // 2 + 4:h // 2 + 14, x + 8:x + 24] = rng.randint(0, 256, (10, 16))
    img[h // 2:] += 0.37
    return _bf16_exact(img)


def _adversarial(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    """Blocky patches of a palette whose differences land at +-threshold
    and on bf16 rounding ties: 20.125 - 0.0625 = 20.0625 rounds to 20 (not a
    corner), 20.125 - 0.05 rounds to 20.125 (a corner), and the same around
    a bright centre; a +0.37 band makes fractional pixels."""
    rng = np.random.RandomState(seed)
    palette = np.array([0.0, 0.0625, 0.05, 0.1875, 0.37, 19.875, 20.0, 20.125, 20.25,
                        40.0, 40.125, 20.0625 + 20.0, 60.0, 59.875], np.float32)
    img = palette[rng.randint(0, len(palette), (h // 2, w // 2))]
    img = np.kron(img, np.ones((2, 2), np.float32))
    img[::7] = 20.0
    img[:, ::5] = 0.0625
    img[h // 3:h // 2] += 0.37
    return _bf16_exact(img)


def _atlas() -> np.ndarray:
    return tfeat.build_pyramid(torch.from_numpy(_scene(0)).to(torch.float32), TORB).float().numpy()


INPUTS = {"dense": lambda: _dense(0), "sparse": lambda: _sparse(1),
          "atlas": _atlas, "adversarial": lambda: _adversarial(2)}


def _kernel_form_scores(img: torch.Tensor, thr: int) -> torch.Tensor:
    """K1's arithmetic in torch: the 9-arc min/max chains over the raw bf16
    taps, then one rounded difference per polarity (exact because
    ``bf16_rne(t - c)`` is monotone in t)."""
    x = img.to(torch.float32)
    taps = torch.stack([torch.roll(x, (-dy, -dx), dims=(0, 1)) for dy, dx in tfast.CIRCLE_OFFSETS])
    idx = torch.arange(16)[:, None] + torch.arange(9)[None, :]
    win = taps[idx % 16]                                      # [16, 9, H, W]
    b = win.amin(dim=1).amax(dim=0)
    d = win.amax(dim=1).amin(dim=0)
    f = lambda t: (t - x).to(torch.bfloat16).to(torch.float32)  # noqa: E731
    score = torch.maximum(f(b), -f(d))
    score = torch.where(score > float(thr), score, 0.0)
    return torch.where(tfast._interior(*x.shape, x.device), score, 0.0)


@pytest.mark.parametrize("name", list(INPUTS))
def test_every_scoring_pixel_is_a_candidate(name):
    img = torch.from_numpy(INPUTS[name]()).to(torch.bfloat16)
    scores = tfast.fast_scores(img, THR)
    cand = tfast.compass_candidates(img, THR)
    assert cand.dtype == torch.bool and cand.shape == img.shape
    assert (scores > 0).sum() > 0, "the input has no corner"
    assert not bool(((scores > 0) & ~cand).any()), "a scoring pixel failed the pretest"
    assert not bool(cand[:3].any() or cand[-3:].any() or cand[:, :3].any() or cand[:, -3:].any())
    share = float(cand.float().mean())
    if name == "dense":
        assert share > 0.5
    if name == "sparse":
        assert share < 0.2


@pytest.mark.parametrize("name", list(INPUTS))
def test_kernel_arithmetic_equals_plain_score(name):
    img = torch.from_numpy(INPUTS[name]()).to(torch.bfloat16)
    assert torch.equal(_kernel_form_scores(img, THR), tfast.fast_scores(img, THR))


def test_pretest_at_rounding_edges():
    """A centre 0.0625 (or 0.05) under two adjacent compass taps at 20.125:
    the difference 20.0625 rounds to 20, not above the threshold; 20.075
    rounds to 20.125, above it. The dark case mirrors it."""
    img = np.zeros((9, 9), np.float32)
    for c, want in ((0.0625, False), (0.05, True)):
        img[:] = c
        img[1, 4] = img[4, 7] = 20.125           # taps N and E of the centre (4, 4)
        t = torch.from_numpy(img).to(torch.bfloat16)
        assert bool(tfast.compass_candidates(t, THR)[4, 4]) == want, c
        assert bool(tfast.compass_candidates(-t, THR)[4, 4]) == want, c


@pytest.mark.parametrize("name", ["sparse", "dense"])
def test_wrappers_bit_equal_to_production_pallas(name):
    """Width 700 crosses the 640-column chunk of the production kernel."""
    gen = _sparse if name == "sparse" else _dense
    imgs = np.stack([gen(s, 72, 700) for s in (3, 4)])
    bf = jnp.asarray(imgs).astype(jnp.bfloat16)
    prod = dict(band=64, chunk_w=640, polarity_fused=True, sparse_skip=True, interpret=True)
    one = np.asarray(fast_scores_pallas(bf[0], THR, **prod))
    batch = np.asarray(fast_scores_pallas_batch(bf, THR, **prod))
    timgs = torch.from_numpy(imgs).to(torch.bfloat16)
    got_one = cuda_fast.fast_score_map(timgs[0], THR)
    got_batch = cuda_fast.fast_score_map_batch(timgs, THR)
    assert got_one.dtype == torch.float32 and got_batch.shape == imgs.shape
    assert (got_one > 0).sum() > 0
    assert np.array_equal(got_one.numpy(), one)
    assert np.array_equal(got_batch.numpy(), batch)
