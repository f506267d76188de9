"""K2, the batched FAST + NMS kernel, through its plain version on the CPU.

The port's ``cuda_fast.fast_score_map_batch`` (on a CPU tensor: the plain
K1 frame by frame) against the JAX package's ``fast.score_map_batch`` (the
CPU ``lax.map``) and the batched Pallas kernel in interpret mode, as
``tests/test_pallas_fast.py`` runs it: bit-equal per frame. The batched and
the per-frame wrappers agree frame by frame. The kernel itself runs only on
the card (``chip_smoke.py`` phase 7).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slideo_tpu.ops import fast as jfast
from slideo_tpu.ops.pallas_fast import fast_scores_pallas_batch
from slideo_tpu_torch.ops import cuda_fast
from slideo_tpu_torch.ops import fast as tfast

torch.set_num_threads(1)


def _batch(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """A bf16-exact float batch: integer pixels, a fractional band (like the
    atlas's resized levels) and a flat block with a dark notch (ties)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, h, w)).astype(np.float32)
    imgs[:, h // 2:] += 0.37
    imgs[0, 20:60, 30:90] = 200.0
    imgs[0, 35:42, 50:58] = 30.0
    return np.asarray(jnp.asarray(imgs).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("b,h,w", [(3, 150, 200), (2, 131, 173)])
def test_batch_plain_bit_equal_to_jax_and_pallas(b, h, w):
    imgs = _batch(b, b, h, w)
    bf = jnp.asarray(imgs).astype(jnp.bfloat16)
    xla = np.asarray(jfast.score_map_batch(bf, 20))
    pallas = np.asarray(fast_scores_pallas_batch(bf, 20, band=64, interpret=True))
    got = cuda_fast.fast_score_map_batch(torch.from_numpy(imgs).to(torch.bfloat16), 20)
    assert got.dtype == torch.float32 and got.shape == (b, h, w)
    assert (got > 0).sum() > 100
    assert np.array_equal(got.numpy(), xla)
    assert np.array_equal(got.numpy(), pallas)


def test_dispatchers_batch_equals_per_frame():
    imgs = torch.from_numpy(_batch(5, 4, 96, 128)).to(torch.bfloat16)
    batch = cuda_fast.fast_score_map_batch(imgs, 20)
    for i, img in enumerate(imgs):
        assert torch.equal(batch[i], cuda_fast.fast_score_map(img, 20)), i
        assert torch.equal(batch[i], tfast.nms3x3(tfast.fast_scores(img, 20))), i


def test_batch_wrapper_refuses_other_devices():
    imgs = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fast.fast_score_map_batch(imgs, 20)
