"""The RANSAC kernel's contract, checked on the CPU (csrc/ransac.cu runs
only on the card).

``chip_smoke.ransac_replay`` replays the kernel's arithmetic in numpy: its
hypotheses, their packed per-block keys and the decode of their max, and
its refinements with each block sum in the kernel's fixed order, with the
block shapes read from the source. Held here to the plain version
(``ransac.ransac_similarity_plain``), it catches indexing and ordering
faults before the card; ``chip_smoke.py`` holds the kernel to it bit for
bit on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import RANSAC_SOURCE, ransac_constants, ransac_replay, ransac_synthetic
from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
from slideo_tpu_torch.ops import cuda_ransac, ransac

torch.set_num_threads(1)

MATCH = DEFAULT_CONFIG.match
CONSTS = ransac_constants(RANSAC_SOURCE.read_text())


def _inputs(c: int, m: int, h: int, seed: int):
    src, dst, valid = ransac_synthetic(seed, c, m)
    u = np.random.RandomState(seed + 1).rand(c, h, 2).astype(np.float32)
    return src, dst, valid, u


def _plain(src, dst, valid, u, cfg=MATCH):
    args = tuple(torch.from_numpy(x) for x in (src, dst, valid, u))
    best_n, best_h, _ = ransac.score_hypotheses(*args, cfg)
    return ransac.ransac_similarity_plain(*args, cfg), best_n.numpy(), best_h.numpy()


def test_wrapper_limits_follow_the_source():
    assert CONSTS["MAX_POINTS"] == cuda_ransac.MAX_POINTS
    assert CONSTS["MAX_HYPOTHESES"] == cuda_ransac.MAX_HYPOTHESES
    assert CONSTS["HYP_WARPS"] * CONSTS["HYP_PER_WARP"] == cuda_ransac.HYP_PER_BLOCK


def test_cpu_tensors_take_the_plain_version():
    src, dst, valid, u = (torch.from_numpy(x) for x in _inputs(4, 128, 512, 5))
    _kernels.reset_launches()
    got = ransac.ransac_similarity(src, dst, valid, u, MATCH)
    want = ransac.ransac_similarity_plain(src, dst, valid, u, MATCH)
    assert _kernels.launches["ransac"] == 0
    for g, w in zip((*got.transform, got.inliers, got.rating, got.ok),
                    (*want.transform, want.inliers, want.rating, want.ok)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ransac.ransac_with_winner(src, dst, valid, u, MATCH)


@pytest.mark.parametrize("c, m, h", [(4, 128, 512), (16, 512, 512), (40, 90, 1200), (3, 2048, 256)])
def test_replay_matches_plain(c, m, h):
    src, dst, valid, u = _inputs(c, m, h, seed=c * m + h)
    rep = ransac_replay(src, dst, valid, u, MATCH.ransac_threshold, MATCH.ransac_refine_iters,
                        CONSTS)
    want, best_n, best_h = _plain(src, dst, valid, u)
    assert np.array_equal(rep["count"], best_n.astype(np.int64))
    assert np.array_equal(rep["winner"], np.where(best_n >= 0, best_h, -1))
    assert np.array_equal(rep["ok"], want.ok.numpy())
    assert np.array_equal(rep["rating"], want.rating.numpy())
    assert np.array_equal(rep["inliers"], want.inliers.numpy())
    for name, w in zip(("a", "b", "tx", "ty"), want.transform):
        np.testing.assert_allclose(rep[name], w.numpy(), atol=1e-3, err_msg=name)
    assert rep["ok"].sum() >= c - 1


def test_duplicated_draws_keep_the_lowest_index():
    """Each best count tied with later copies of its draws, in its own block
    and in later blocks: the plain version and the kernel's packed keys
    both keep the lowest hypothesis index."""
    src, dst, valid, u = _inputs(6, 256, 512, seed=11)
    u[:, 250:500] = u[:, :250]
    u[:, 7] = u[:, 3]
    u[:, 40] = u[:, 3]
    rep = ransac_replay(src, dst, valid, u, MATCH.ransac_threshold, MATCH.ransac_refine_iters,
                        CONSTS)
    _, best_n, best_h = _plain(src, dst, valid, u)
    for c in range(6):
        counts = rep["counts"][c]
        if counts.max() < 0:
            assert best_h[c] == -1 and rep["winner"][c] == -1
            continue
        first = int(np.argmax(counts))
        assert (counts == counts.max()).sum() >= 2 and first < 250
        assert best_h[c] == rep["winner"][c] == first
        assert best_n[c] == rep["count"][c] == counts.max()
