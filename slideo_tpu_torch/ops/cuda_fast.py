"""Wrapper of kernel K1 (csrc/fast.cu): FAST-9/16 score + 3x3 NMS.

Replaces ``slideo_tpu/ops/pallas_fast.py:fast_scores_pallas``. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version
``fast.nms3x3(fast.fast_scores(...))``, to which the kernel is bit-equal.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fast import fast_scores, nms3x3

__all__ = ["fast_score_map", "fast_score_map_plain"]


def fast_score_map_plain(img: torch.Tensor, threshold: int) -> torch.Tensor:
    return nms3x3(fast_scores(img, threshold))


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
    rc = _kernels.library().slideo_fast_nms(
        img.data_ptr(), out.data_ptr(), h, w, float(threshold),
        _kernels.stream_of(img),
    )
    _kernels.check_launch(rc, "fast")
    return out
