"""Wrapper of kernel K6 (csrc/warp.cu): bilinear sampling for verification.

Replaces ``slideo_tpu/ops/pallas_warp.py:bilinear_sample_pallas``. A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
``verify._bilinear_image``. Both return 0 at out-of-bounds points.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["bilinear_sample", "bilinear_sample_plain"]


def bilinear_sample_plain(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    from .verify import _bilinear_image

    return _bilinear_image(img, xs.reshape(-1), ys.reshape(-1)).reshape(xs.shape)


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a [H, W] float32 image at [T, P] float32 coords
    -> [T, P] float32; points outside the image give 0."""
    if _kernels.plain_or_raise(img):
        return bilinear_sample_plain(img, xs, ys)
    _kernels.require_cuda(img, "bilinear_sample img", torch.float32, 2)
    _kernels.require_cuda(xs, "bilinear_sample xs", torch.float32, 2)
    _kernels.require_cuda(ys, "bilinear_sample ys", torch.float32, 2)
    if xs.shape != ys.shape:
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)} differ")
    h, w = img.shape
    out = torch.empty(xs.shape, dtype=torch.float32, device=img.device)
    n = xs.numel()
    if n == 0:
        return out
    _kernels.launch(
        "warp", "slideo_bilinear_sample", img,
        img.data_ptr(), h, w, xs.data_ptr(), ys.data_ptr(), n, out.data_ptr(),
    )
    return out
