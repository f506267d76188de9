"""FAST-9/16 corner scores + 3x3 NMS: the plain PyTorch version.

Port of ``slideo_tpu/ops/fast.py``. ``nms3x3(fast_scores(...))`` is the plain
version of kernels K1 and K2 (csrc/fast.cu, launched by ``cuda_fast``).
The score is OpenCV's FAST_SCORE:
``max(max_s min_{9-arc}(tap - c), -min_s max_{9-arc}(tap - c))`` with each
``tap - c`` rounded to bfloat16 (config.OrbConfig.atlas_bf16), zero unless
``> threshold``, and zero on the 3 px image ring. ``compass_candidates`` is
the plain form of K1's exact pretest; nothing on the match path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CIRCLE_OFFSETS", "COMPASS", "compass_candidates", "fast_scores", "nms3x3"]

# Bresenham circle of radius 3, 16 points, clockwise from (dy=-3, dx=0).
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
# Positions of the compass taps (N, E, S, W) in CIRCLE_OFFSETS.
COMPASS: tuple[int, ...] = (0, 4, 8, 12)


def _interior(h: int, w: int, device) -> torch.Tensor:
    """True off the 3 px image ring, where the circle would wrap."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def _rounded_diff(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """bf16_rne(tap - centre) of every pixel, for the tap at (dy, dx)."""
    return (torch.roll(x, (-dy, -dx), dims=(0, 1)) - x).to(torch.bfloat16)


def _window9_reduce(d: torch.Tensor, op) -> torch.Tensor:
    """out[s] = op(d[s], ..., d[s+8]) along dim 0 (length 16, circular)."""
    w2 = op(d, torch.roll(d, -1, dims=0))
    w4 = op(w2, torch.roll(w2, -2, dims=0))
    w8 = op(w4, torch.roll(w4, -4, dims=0))
    return op(w8, torch.roll(d, -8, dims=0))


def fast_scores(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """FAST-9/16 score map of a [H, W] image -> float32 [H, W]."""
    x = img.to(torch.float32)
    d = torch.stack([_rounded_diff(x, dy, dx) for (dy, dx) in CIRCLE_OFFSETS])  # [16, H, W]
    bright = _window9_reduce(d, torch.minimum).amax(dim=0)
    dark = -_window9_reduce(d, torch.maximum).amin(dim=0)
    score = torch.maximum(bright, dark).to(torch.float32)
    score = torch.where(score > float(threshold), score, 0.0)
    return torch.where(_interior(*img.shape, img.device), score, 0.0)


def compass_candidates(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """Pixels of a [H, W] image that may score above ``threshold`` -> bool [H, W].

    The per-pixel form of the TPU kernel's compass pretest
    (``slideo_tpu/ops/pallas_fast.py`` ``sparse_skip``), which K1 runs in
    every pixel: a 9-contiguous arc of the circle holds two adjacent compass
    taps, so a nonzero score needs an adjacent pair whose rounded
    differences are both ``> threshold`` or both ``< -threshold``. Taken on
    the same bf16-rounded differences as ``fast_scores``, the test is exact:
    every pixel with a nonzero score is a candidate. False on the 3 px ring.
    """
    x = img.to(torch.float32)
    d = [_rounded_diff(x, *CIRCLE_OFFSETS[i]).to(torch.float32) for i in COMPASS]
    t = float(threshold)
    cand = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for a, b in zip(d, d[1:] + d[:1]):
        cand |= (torch.minimum(a, b) > t) | (torch.maximum(a, b) < -t)
    return cand & _interior(*img.shape, img.device)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep a score iff it is the maximum of its 3x3 neighbourhood."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)
