"""Wrapper of kernel K5 mode (b) (csrc/screen.cu): stage-1 screening scores.

Replaces ``slideo_tpu/ops/pallas_table.py:match_table_scores_pallas`` in the
int8 / max-only / ``skip_bias`` mode that
``slideo_tpu/ops/hamming.py:screen_slides_batched`` runs on the screening
tensor. A CUDA tensor launches the kernel; a CPU tensor takes the plain
version, a float32 matmul per chunk of slides (exact for +-1 prefixes),
masked to -254, then a max. Both are bit-equal to the TPU kernel.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["SCREEN_BITS", "screen_scores", "screen_scores_plain"]

SCREEN_BITS = 128       # descriptor prefix bits of the stage-1 vote
_INVALID = -254         # an invalid slot: two -127 validity rows x two +1 columns
_D_BITS = 256           # row length of the index desc the kernel reads
_CHUNK_ELEMS = 1 << 28  # float32 scores per matmul of the plain version (1 GiB)


def screen_scores_plain(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int,
) -> torch.Tensor:
    """best [R, S] int32: per (query, slide) the max over the slide's slots
    of the 128-bit prefix dot product, an invalid slot scoring -254."""
    r = query.shape[0]
    qf = query.to(torch.float32)
    chunk = max(1, _CHUNK_ELEMS // max(1, r * k_per_slide))
    best = []
    for s0 in range(0, n_slides, chunk):
        s1 = min(s0 + chunk, n_slides)
        rows = slice(s0 * k_per_slide, s1 * k_per_slide)
        scores = qf @ desc[rows, :SCREEN_BITS].to(torch.float32).T
        scores = torch.where(valid[rows][None, :], scores, float(_INVALID))
        best.append(scores.reshape(r, s1 - s0, k_per_slide).amax(dim=-1))
    if not best:
        return torch.empty((r, 0), dtype=torch.int32, device=query.device)
    return torch.cat(best, dim=1).to(torch.int32)


def screen_scores(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int,
) -> torch.Tensor:
    """Stage-1 screening scores.

    query [R, 128] int8 (+-1 prefixes, invalid rows 0); desc [S*K, 256] int8
    (+-1, invalid slots 0), of which the kernel reads each row's first 128
    bytes; valid [S*K] bool. Returns best [R, S] int32.
    """
    if _kernels.plain_or_raise(query):
        return screen_scores_plain(query, desc, valid, n_slides, k_per_slide)
    _kernels.require_cuda(query, "screen query", torch.int8, 2)
    _kernels.require_cuda(desc, "screen desc", torch.int8, 2)
    _kernels.require_cuda(valid, "screen valid", torch.bool, 1)
    r = query.shape[0]
    n = n_slides * k_per_slide
    if query.shape[1] != SCREEN_BITS or desc.shape != (n, _D_BITS) or valid.shape != (n,):
        raise ValueError(
            f"screen: query {tuple(query.shape)}, desc {tuple(desc.shape)}, valid "
            f"{tuple(valid.shape)} do not fit {n_slides} x {k_per_slide} x {_D_BITS}"
        )
    if query.data_ptr() % 16 or desc.data_ptr() % 16:
        raise ValueError("screen: query and desc must be 16-byte aligned (cp.async)")
    best = torch.empty((r, n_slides), dtype=torch.int32, device=query.device)
    if r == 0 or n_slides == 0:
        return best
    _kernels.launch(
        "screen", "slideo_screen", query,
        query.data_ptr(), r, desc.data_ptr(), valid.data_ptr(), n_slides,
        k_per_slide, best.data_ptr(),
    )
    return best
