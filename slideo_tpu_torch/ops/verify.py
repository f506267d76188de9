"""Warped-image similarity verification.

Port of ``slideo_tpu/ops/verify.py:27-153`` (reference lib.rs:335-368): each
slide-thumbnail pixel (on a ``stride`` grid) is mapped through the RANSAC
transform into the frame and sampled bilinearly from the frame's
area-downscaled thumbnail (kernel K6 on CUDA); the warped thumbnail is
compared with the slide's by the L2 similarity.
"""

from __future__ import annotations

import torch

from .cuda_warp import bilinear_sample
from .image import compute_similarity, small_size
from .ransac import Similarity

__all__ = ["warp_similarity"]

_CHUNK = 2048   # sample points per tent-weight matmul of _bilinear_image


def _bilinear_image(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a [H, W] image at [N] float coords; out-of-bounds
    points give 0. Tent-weight form (``value = rowsum((Ry @ img) * Cx)``) in
    chunks of points: the plain version of kernel K6."""
    h, w = img.shape
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    grid_y = torch.arange(h, dtype=torch.float32, device=img.device)
    grid_x = torch.arange(w, dtype=torch.float32, device=img.device)
    vals = []
    for i in range(0, x.shape[0], _CHUNK):
        yc = torch.clamp(y[i:i + _CHUNK], 0.0, h - 1.0)
        xc = torch.clamp(x[i:i + _CHUNK], 0.0, w - 1.0)
        ry = torch.clamp(1.0 - torch.abs(yc[:, None] - grid_y), min=0.0)
        cx = torch.clamp(1.0 - torch.abs(xc[:, None] - grid_x), min=0.0)
        vals.append(((ry @ img) * cx).sum(dim=-1))
    val = torch.cat(vals) if vals else x.new_zeros((0,))
    return torch.where(inb, val, 0.0)


def warp_similarity(
    frame_small: torch.Tensor,
    frame_hw: tuple[int, int],
    transforms: Similarity,
    slide_smalls: torch.Tensor,
    cand_slide_ids: torch.Tensor,
    slide_hw: tuple[int, int],
    max_area: int = 300 * 400,
    stride: int = 1,
) -> torch.Tensor:
    """Similarity [T] of the warped frame against each candidate slide.

    frame_small: the frame's area thumbnail; frame_hw its full size.
    transforms: [T]-field Similarity mapping full-res slide coords to
    full-res frame coords. slide_smalls [S, hs, ws]; slide_hw the full page
    size behind them.
    """
    hs, ws = slide_smalls.shape[-2], slide_smalls.shape[-1]
    full_h, full_w = slide_hw
    fh, fw = frame_hw
    fsh, fsw = small_size(fh, fw, max_area)
    inv_fx = fsw / fw
    inv_fy = fsh / fh
    sy = full_h / hs
    sx = full_w / ws
    dev = frame_small.device
    jj = (torch.arange(0, ws, stride, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    ii = (torch.arange(0, hs, stride, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    out_h, out_w = ii.shape[0], jj.shape[0]
    gx = jj[None, None, :]
    gy = ii[None, :, None]
    t = Similarity(*(f[:, None, None] for f in transforms))
    fx = t.a * gx - t.b * gy + t.tx
    fy = t.b * gx + t.a * gy + t.ty
    sxp = (fx + 0.5) * inv_fx - 0.5                     # [T, oh, ow]
    syp = (fy + 0.5) * inv_fy - 0.5
    n_t = sxp.shape[0]
    warped = bilinear_sample(
        frame_small.contiguous(), sxp.reshape(n_t, -1).contiguous(),
        syp.reshape(n_t, -1).contiguous(),
    ).reshape(n_t, out_h, out_w)
    smalls = slide_smalls[cand_slide_ids.long()][:, ::stride, ::stride]
    return compute_similarity(warped, smalls, channels=1)
