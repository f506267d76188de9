"""Warped-image similarity verification.

Port of ``slideo_tpu/ops/verify.py`` (reference lib.rs:335-368): each
slide-thumbnail pixel (on a ``stride`` grid) is mapped through the RANSAC
transform into the frame and sampled bilinearly from the frame's
area-downscaled thumbnail; the warped thumbnail is compared with the
slide's by the L2 similarity. On CUDA kernel K6 forms the points itself:
from a similarity (the ORB engine, ``warp_similarity``) or, with the
perspective divide, from a homography (K6h, the SIFT engine,
``warp_similarity_homography``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_warp import warp_sample, warp_sample_homography
from .image import compute_similarity, small_size
from .ransac import Similarity

__all__ = [
    "SampleGrid",
    "sample_grid",
    "warp_coords",
    "warp_coords_homography",
    "warp_sample_plain",
    "warp_sample_homography_plain",
    "warp_similarity",
    "warp_similarity_homography",
]

_CHUNK = 2048   # sample points per tent-weight matmul of _bilinear_image


class SampleGrid(NamedTuple):
    """The slide-thumbnail grid that verification samples: output (i, j) is
    thumbnail pixel (i * stride, j * stride), (sx, sy) scale thumbnail
    pixels to full slide pixels and (inv_fx, inv_fy) full frame pixels to
    frame-thumbnail pixels."""

    sx: float
    sy: float
    inv_fx: float
    inv_fy: float
    out_h: int
    out_w: int
    stride: int


def sample_grid(
    small_hw: tuple[int, int], slide_hw: tuple[int, int], frame_hw: tuple[int, int],
    max_area: int = 300 * 400, stride: int = 1,
) -> SampleGrid:
    """The grid of slide thumbnails [hs, ws] = ``small_hw`` of pages
    ``slide_hw``, sampled from the thumbnail of a ``frame_hw`` frame."""
    hs, ws = small_hw
    fsh, fsw = small_size(*frame_hw, max_area)
    return SampleGrid(
        sx=slide_hw[1] / ws, sy=slide_hw[0] / hs,
        inv_fx=fsw / frame_hw[1], inv_fy=fsh / frame_hw[0],
        out_h=len(range(0, hs, stride)), out_w=len(range(0, ws, stride)), stride=stride,
    )


def _grid_points(grid: SampleGrid, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-res slide coordinates gx [1, 1, out_w], gy [1, out_h, 1] of the
    grid's thumbnail pixel centres."""
    step = grid.stride
    jj = (torch.arange(0, grid.out_w * step, step, dtype=torch.float32, device=device) + 0.5) * grid.sx - 0.5
    ii = (torch.arange(0, grid.out_h * step, step, dtype=torch.float32, device=device) + 0.5) * grid.sy - 0.5
    return jj[None, None, :], ii[None, :, None]


def warp_coords(
    transforms: Similarity, grid: SampleGrid, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-thumbnail coordinates (x, y), each [T, out_h, out_w] float32, of
    the grid's points mapped by each transform (full-res slide coords ->
    full-res frame coords). Kernel K6 repeats these operations in order."""
    gx, gy = _grid_points(grid, device)
    t = Similarity(*(f[:, None, None] for f in transforms))
    fx = t.a * gx - t.b * gy + t.tx
    fy = t.b * gx + t.a * gy + t.ty
    return (fx + 0.5) * grid.inv_fx - 0.5, (fy + 0.5) * grid.inv_fy - 0.5


def warp_coords_homography(
    hparams: torch.Tensor, grid: SampleGrid, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """``warp_coords`` for homographies hparams [T, 8] (``apply_homography``,
    ``verify.py:189-191``): w = (h6 x + h7 y) + 1, a w within 1e-8 of 0
    made +1e-8, u = ((h0 x + h1 y) + h2) / w, v likewise. Kernel K6h
    repeats these operations in order."""
    gx, gy = _grid_points(grid, device)
    h = [hparams[:, i, None, None] for i in range(8)]
    w = h[6] * gx + h[7] * gy + 1.0
    w = torch.where(torch.abs(w) > 1e-8, w, 1e-8)
    fx = (h[0] * gx + h[1] * gy + h[2]) / w
    fy = (h[3] * gx + h[4] * gy + h[5]) / w
    return (fx + 0.5) * grid.inv_fx - 0.5, (fy + 0.5) * grid.inv_fy - 0.5


def warp_sample_plain(img: torch.Tensor, transforms: Similarity, grid: SampleGrid) -> torch.Tensor:
    """The plain version of kernel K6: ``warp_coords`` then
    ``_bilinear_image`` -> [T, out_h, out_w]."""
    sxp, syp = warp_coords(transforms, grid, img.device)
    return _bilinear_image(img, sxp.reshape(-1), syp.reshape(-1)).reshape(sxp.shape)


def warp_sample_homography_plain(
    img: torch.Tensor, hparams: torch.Tensor, grid: SampleGrid
) -> torch.Tensor:
    """The plain version of kernel K6h: ``warp_coords_homography`` then
    ``_bilinear_image`` -> [T, out_h, out_w]."""
    sxp, syp = warp_coords_homography(hparams, grid, img.device)
    return _bilinear_image(img, sxp.reshape(-1), syp.reshape(-1)).reshape(sxp.shape)


def _bilinear_image(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a [H, W] image at [N] float coords; out-of-bounds
    points give 0. Tent-weight form (``value = rowsum((Ry @ img) * Cx)``) in
    chunks of points: the sampling half of kernel K6's plain version."""
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
    grid = sample_grid(slide_smalls.shape[-2:], slide_hw, frame_hw, max_area, stride)
    warped = warp_sample(frame_small.contiguous(), transforms, grid)
    smalls = slide_smalls[cand_slide_ids.long()][:, ::stride, ::stride]
    return compute_similarity(warped, smalls, channels=1)


def warp_similarity_homography(
    frame_small: torch.Tensor,
    frame_hw: tuple[int, int],
    hparams: torch.Tensor,
    slide_smalls: torch.Tensor,
    cand_slide_ids: torch.Tensor,
    slide_hw: tuple[int, int],
    max_area: int = 300 * 400,
    stride: int = 1,
) -> torch.Tensor:
    """``warp_similarity`` for homographies (``verify.py:156-212``):
    hparams [T, 8] map full-res slide coords to full-res frame coords."""
    grid = sample_grid(slide_smalls.shape[-2:], slide_hw, frame_hw, max_area, stride)
    warped = warp_sample_homography(frame_small.contiguous(), hparams.contiguous(), grid)
    smalls = slide_smalls[cand_slide_ids.long()][:, ::stride, ::stride]
    return compute_similarity(warped, smalls, channels=1)
