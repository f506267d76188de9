"""Wrappers of kernel K6 (csrc/warp.cu): bilinear sampling for verification.

Replace ``slideo_tpu/ops/pallas_warp.py:bilinear_sample_pallas`` together
with the coordinate code before it, at both of its call sites: the kernel
forms the warped points of the verification grid itself, from similarities
(``warp_sample``, the ORB engine, ``verify.py:138``) or from homographies
with the perspective divide (``warp_sample_homography``, K6h, the SIFT
engine, ``verify.py:199``). A CUDA tensor launches the kernel; a CPU tensor
takes the plain version ``verify.warp_sample_plain`` /
``verify.warp_sample_homography_plain`` (the coordinates, then
``verify._bilinear_image``). All return 0 at out-of-bounds points.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["warp_sample", "warp_sample_homography"]


def warp_sample(img: torch.Tensor, transforms, grid) -> torch.Tensor:
    """Bilinear samples of the [H, W] float32 frame thumbnail ``img`` at the
    points of ``grid`` (a ``verify.SampleGrid``) mapped by each of the T
    similarity ``transforms`` (fields [T] float32) -> [T, out_h, out_w]
    float32; points outside the image give 0."""
    if _kernels.plain_or_raise(img):
        from .verify import warp_sample_plain

        return warp_sample_plain(img, transforms, grid)
    _kernels.require_cuda(img, "warp_sample img", torch.float32, 2)
    fields = [f.contiguous() for f in transforms]
    for name, f in zip(("a", "b", "tx", "ty"), fields):
        _kernels.require_cuda(f, f"warp_sample transform {name}", torch.float32, 1)
    n_t = fields[0].shape[0]
    if any(f.shape[0] != n_t for f in fields):
        raise ValueError(f"warp_sample: transform fields {[tuple(f.shape) for f in fields]} differ")
    h, w = img.shape
    out = torch.empty((n_t, grid.out_h, grid.out_w), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    _kernels.launch(
        "warp", "slideo_warp_sample", img,
        img.data_ptr(), h, w, *(f.data_ptr() for f in fields), n_t,
        grid.sx, grid.sy, grid.inv_fx, grid.inv_fy, grid.out_h, grid.out_w, grid.stride,
        out.data_ptr(),
    )
    return out


def warp_sample_homography(img: torch.Tensor, hparams: torch.Tensor, grid) -> torch.Tensor:
    """``warp_sample`` for T homographies ``hparams`` [T, 8] float32 (h8 = 1)
    -> [T, out_h, out_w] float32; points outside the image give 0."""
    if _kernels.plain_or_raise(img):
        from .verify import warp_sample_homography_plain

        return warp_sample_homography_plain(img, hparams, grid)
    _kernels.require_cuda(img, "warp_sample_homography img", torch.float32, 2)
    _kernels.require_cuda(hparams, "warp_sample_homography hparams", torch.float32, 2)
    if hparams.shape[1] != 8:
        raise ValueError(f"warp_sample_homography: hparams {tuple(hparams.shape)} is not [T, 8]")
    n_t = hparams.shape[0]
    h, w = img.shape
    out = torch.empty((n_t, grid.out_h, grid.out_w), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    _kernels.launch(
        "warp_homography", "slideo_warp_sample_homography", img,
        img.data_ptr(), h, w, hparams.data_ptr(), n_t,
        grid.sx, grid.sy, grid.inv_fx, grid.inv_fy, grid.out_h, grid.out_w, grid.stride,
        out.data_ptr(),
    )
    return out
