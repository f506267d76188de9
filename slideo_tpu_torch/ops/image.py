"""Image primitives: dense resize, thumbnails, L2 similarity.

Port of ``slideo_tpu/ops/image.py``. Resampling stays two dense matrix
products per image (``out = Wy @ img @ Wx^T``) with the same host-built
weight matrices; PyTorch runs them as plain f32 matmuls, and the SIFT
engine's Gaussian blur as two f32 convolutions (the engine turns TF32 off
for both, so they are full f32 on the card too).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "small_size",
    "resize",
    "to_small_image",
    "compute_similarity",
    "gaussian_blur",
]


def small_size(h: int, w: int, max_area: int = 300 * 400) -> tuple[int, int]:
    """Thumbnail size with area <= max_area, aspect preserved, truncating
    like the reference's ``as i32`` casts."""
    factor = math.sqrt(max_area / float(h * w))
    return int(h * factor), int(w * factor)


@lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, area: bool) -> np.ndarray:
    """Dense [out_size, in_size] resampling matrix (area or bilinear with
    OpenCV's half-pixel convention) — the JAX package's matrix, in numpy."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    if area and scale >= 1.0:
        for o in range(out_size):
            lo = o * scale
            hi = (o + 1) * scale
            i0 = int(math.floor(lo))
            i1 = min(int(math.ceil(hi)), in_size)
            for i in range(i0, i1):
                overlap = min(hi, i + 1) - max(lo, i)
                if overlap > 0:
                    w[o, i] = overlap / scale
    else:
        for o in range(out_size):
            src = (o + 0.5) * scale - 0.5
            i0 = int(math.floor(src))
            frac = src - i0
            ia = min(max(i0, 0), in_size - 1)
            ib = min(max(i0 + 1, 0), in_size - 1)
            w[o, ia] += 1.0 - frac
            w[o, ib] += frac
    return w


@lru_cache(maxsize=64)
def _resize_matrix_on(
    in_size: int, out_size: int, area: bool, device: torch.device
) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(in_size, out_size, area)).to(device)


def resize(img: torch.Tensor, out_hw: tuple[int, int], *, area: bool = False) -> torch.Tensor:
    """Resize [..., H, W] to [..., h, w] float32 by two dense matmuls."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    wy = _resize_matrix_on(h_in, h_out, area, img.device)
    wx = _resize_matrix_on(w_in, w_out, area, img.device)
    x = img.to(torch.float32)
    x1 = torch.matmul(x, wx.T)        # [..., h_in, w_out]
    return torch.matmul(wy, x1)       # [..., h_out, w_out]


def to_small_image(img: torch.Tensor, max_area: int = 300 * 400) -> torch.Tensor:
    """Downscale [..., H, W] to area <= max_area (INTER_AREA)."""
    h, w = img.shape[-2], img.shape[-1]
    return resize(img, small_size(h, w, max_area), area=True)


def compute_similarity(
    img1: torch.Tensor, img2: torch.Tensor, channels: int = 3
) -> torch.Tensor:
    """1 - ||img1-img2||_2 / sqrt(255^2 * channels * pixels), reduced over the
    trailing image dims (``channels`` == 1: [..., H, W]; 3: [..., H, W, 3])."""
    ndim_img = 2 if channels == 1 else 3
    dims = tuple(range(-ndim_img, 0))
    diff = img1.to(torch.float32) - img2.to(torch.float32)
    err = torch.sqrt(torch.sum(diff * diff, dim=dims))
    rows, cols = img1.shape[-ndim_img], img1.shape[-ndim_img + 1]
    max_err = math.sqrt(255.0 * 255.0 * channels * rows * cols)
    return 1.0 - err / max_err


@lru_cache(maxsize=16)
def _gauss_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=16)
def _gauss_kernels_on(ksize: int, sigma: float, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.from_numpy(_gauss_kernel_1d(ksize, sigma)).to(device)
    return k.reshape(1, 1, 1, ksize), k.reshape(1, 1, ksize, 1)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] in f32 with reflect-101 edges
    (OpenCV's default, ``image.py:142-156``): a row pass, then a column
    pass, each a VALID convolution of the padded image."""
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    x = img.to(torch.float32).reshape(-1, 1, h, w)
    x = torch.nn.functional.pad(x, (pad, pad, pad, pad), mode="reflect")
    kx, ky = _gauss_kernels_on(ksize, float(sigma), x.device)
    x = torch.nn.functional.conv2d(x, kx)
    x = torch.nn.functional.conv2d(x, ky)
    return x.reshape(img.shape)
