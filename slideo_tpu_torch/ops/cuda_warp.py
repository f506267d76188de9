"""Wrapper of kernel K6 (csrc/warp.cu): bilinear sampling for verification.

Replaces ``slideo_tpu/ops/pallas_warp.py:bilinear_sample_pallas`` together
with the coordinate code before it in ``verify.warp_similarity``: the kernel
forms the warped points of the verification grid itself. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version
``verify.warp_sample_plain`` (``verify.warp_coords`` followed by
``verify._bilinear_image``). Both return 0 at out-of-bounds points.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["warp_sample"]


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
