"""FAST-9/16 corner scores + 3x3 NMS: the plain PyTorch version.

Port of ``slideo_tpu/ops/fast.py``. ``nms3x3(fast_scores(...))`` is the plain
version of kernels K1 and K2 (csrc/fast.cu, launched by ``cuda_fast``).
The score is OpenCV's FAST_SCORE:
``max(max_s min_{9-arc}(tap - c), -min_s max_{9-arc}(tap - c))`` with each
``tap - c`` rounded to bfloat16 (config.OrbConfig.atlas_bf16), zero unless
``> threshold``, and zero on the 3 px image ring.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CIRCLE_OFFSETS", "fast_scores", "nms3x3"]

# Bresenham circle of radius 3, 16 points, clockwise from (dy=-3, dx=0).
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _window9_reduce(d: torch.Tensor, op) -> torch.Tensor:
    """out[s] = op(d[s], ..., d[s+8]) along dim 0 (length 16, circular)."""
    w2 = op(d, torch.roll(d, -1, dims=0))
    w4 = op(w2, torch.roll(w2, -2, dims=0))
    w8 = op(w4, torch.roll(w4, -4, dims=0))
    return op(w8, torch.roll(d, -8, dims=0))


def fast_scores(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """FAST-9/16 score map of a [H, W] image -> float32 [H, W]."""
    x = img.to(torch.float32)
    shifted = torch.stack(
        [torch.roll(x, (-dy, -dx), dims=(0, 1)) for (dy, dx) in CIRCLE_OFFSETS]
    )
    d = (shifted - x[None]).to(torch.bfloat16)                    # [16, H, W]
    bright = _window9_reduce(d, torch.minimum).amax(dim=0)
    dark = -_window9_reduce(d, torch.maximum).amin(dim=0)
    score = torch.maximum(bright, dark).to(torch.float32)
    score = torch.where(score > float(threshold), score, 0.0)
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(inb, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep a score iff it is the maximum of its 3x3 neighbourhood."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)
