"""Wrappers of kernels K1 and K2 (csrc/fast.cu): FAST-9/16 score + 3x3 NMS.

K1 replaces ``slideo_tpu/ops/pallas_fast.py:fast_scores_pallas`` (one
image), K2 ``fast_scores_pallas_batch`` (a batch in one launch). A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
``fast.nms3x3(fast.fast_scores(...))``, frame by frame for a batch, to
which both kernels are bit-equal.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fast import fast_scores, nms3x3

__all__ = [
    "fast_score_map", "fast_score_map_plain",
    "fast_score_map_batch", "fast_score_map_batch_plain",
]

_MAX_BATCH = 65535  # the kernel's grid z dimension


def fast_score_map_plain(img: torch.Tensor, threshold: int) -> torch.Tensor:
    return nms3x3(fast_scores(img, threshold))


def fast_score_map_batch_plain(imgs: torch.Tensor, threshold: int) -> torch.Tensor:
    return torch.stack([fast_score_map_plain(img, threshold) for img in imgs])


def fast_score_map(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """NMS'd FAST score map of a [H, W] image -> float32 [H, W].

    On CUDA the image must be bfloat16 (the pyramid atlas of
    ``OrbConfig.atlas_bf16``): the kernel reads bf16 taps, as the TPU kernel
    does.
    """
    if _kernels.plain_or_raise(img):
        return fast_score_map_plain(img, threshold)
    _kernels.require_cuda(img, "fast_score_map img", torch.bfloat16, 2)
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    _kernels.launch(
        "fast", "slideo_fast_nms", img, img.data_ptr(), out.data_ptr(), h, w, float(threshold),
    )
    return out


def fast_score_map_batch(imgs: torch.Tensor, threshold: int) -> torch.Tensor:
    """NMS'd FAST score maps of a [B, H, W] batch -> float32 [B, H, W], each
    frame bit-equal to ``fast_score_map``; on CUDA one launch of K2 for the
    whole batch (bfloat16, as K1)."""
    if _kernels.plain_or_raise(imgs):
        return fast_score_map_batch_plain(imgs, threshold)
    _kernels.require_cuda(imgs, "fast_score_map_batch imgs", torch.bfloat16, 3)
    b, h, w = imgs.shape
    if b > _MAX_BATCH:
        raise ValueError(f"fast_score_map_batch: batch {b} exceeds {_MAX_BATCH} frames")
    out = torch.empty((b, h, w), dtype=torch.float32, device=imgs.device)
    _kernels.launch(
        "fast_batch", "slideo_fast_nms_batch", imgs,
        imgs.data_ptr(), out.data_ptr(), b, h, w, float(threshold),
    )
    return out
