"""The tables and bank schedule of kernel K3+K4 (csrc/orb.cu), on the CPU.

``cuda_orb._packed_tables`` packs each bin's 512 samples (head word with
both starts and the sample index, 16 bf16 weights) in the order of a bank
schedule for the kernel's shared-memory tile. These hold that the packing
is lossless against ``_patch_tables`` and a permutation per bin, that the
schedule's shared-memory wavefronts per warp read, counted here, meet the
figure the module states, and that ``orb.cu`` uses the tile the schedule
was made for.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from chip_smoke import orb_tile
from slideo_tpu_torch.ops import cuda_orb

KEY = (256, 0x51DE0, 7, 2.0)
ORB_CU = Path(cuda_orb.__file__).resolve().parent.parent / "csrc" / "orb.cu"


def _decode(heads, weights):
    """(a_start, d_start, sample, a_w, d_w) of every position."""
    bits = lambda w: (w.view(np.uint16).astype(np.uint32) << 16).view(np.float32)  # noqa: E731
    return (heads & 63, (heads >> 6) & 63, heads >> 12,
            bits(np.ascontiguousarray(weights[..., :8])), bits(np.ascontiguousarray(weights[..., 8:])))


def _dense(start, w):
    rows = np.zeros((*start.shape, 63), np.float32)
    np.put_along_axis(rows, start[..., None] + np.arange(8), w, axis=-1)
    return rows


@pytest.mark.parametrize("tile", [cuda_orb.TILE, ("f32", 69, 0)], ids=["tile", "f32"])
def test_packed_tables_decode_to_patch_tables(tile):
    """All 32 bins: each bin's positions hold every sample once, and the
    head word's starts with the 16 bf16 weights rebuild the dense A and D
    rows of ``_patch_tables`` exactly."""
    heads, weights = cuda_orb._packed_tables(*KEY, tile)
    a, d, *_ = cuda_orb._patch_tables(*KEY)
    assert heads.shape == (32, 512) and weights.shape == (32, 512, 16)
    a_s, d_s, sample, a_w, d_w = _decode(heads, weights)
    for b in range(32):
        assert np.array_equal(np.sort(sample[b]), np.arange(512))
        assert np.array_equal(_dense(a_s[b], a_w[b]), a[b][sample[b]])
        assert np.array_equal(_dense(d_s[b], d_w[b]), d[b][sample[b]])


def test_schedule_wavefronts():
    """A warp read of the sweep (8 warps x 2 slots: positions [32 g, 32 g +
    32)) takes, in wavefronts, the most distinct shared-memory words in one
    of the 32 banks among its lanes' first words. Counted over the 32 bins,
    the mean meets ``SCHEDULE_WAVEFRONTS`` and beats the 4.09 of the f32
    tile of pitch 64 with the samples in bit order."""
    _, pitch, copy1 = cuda_orb.TILE
    heads, _ = cuda_orb._packed_tables(*KEY, cuda_orb.TILE)
    a_s, d_s = heads & 63, (heads >> 6) & 63
    words = (d_s & 1) * copy1 + a_s * pitch + d_s // 2

    def waves(w):
        return np.mean([[np.bincount(np.unique(g) % 32, minlength=32).max()
                         for g in b.reshape(16, 32)] for b in w])

    got = waves(words)
    assert got <= cuda_orb.SCHEDULE_WAVEFRONTS < 4.09
    _, _, a_start, _, d_start, _ = cuda_orb._patch_tables(*KEY)
    assert waves(a_start * 64 + d_start) == pytest.approx(4.09, abs=0.005)
    # the 4 words of each tap row of every sample lie inside its copy's row
    assert (d_s // 2 + 3 < pitch).all() and (a_s + 7 < 63).all()
    assert 63 * pitch <= copy1


def test_orb_cu_uses_the_scheduled_tile():
    """orb.cu's tile constants (read as ``chip_smoke.py --compare-orb``
    reads a version's) and note are those of ``cuda_orb.TILE`` and
    ``SCHEDULE_WAVEFRONTS``."""
    src = ORB_CU.read_text()
    assert orb_tile(src) == cuda_orb.TILE
    assert f"takes {cuda_orb.SCHEDULE_WAVEFRONTS:.2f} wavefronts" in src
