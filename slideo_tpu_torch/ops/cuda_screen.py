"""Wrapper of kernel K5 mode (b) (csrc/screen.cu): stage-1 screening scores.

Replaces ``slideo_tpu/ops/pallas_table.py:match_table_scores_pallas`` in the
int8 / max-only mode of stage 1. ``slideo_tpu/ops/hamming.py:screen_slides_batched``
runs it on the screening tensor (``skip_bias``) in three forms: the
single-stage sweep over every slot of every slide (``hamming.py:595``), the
strided pre-vote over every ``stride``-th slot (``:564``) and the re-vote of
each frame's rows over its own listed slides (``:584``). The per-frame rule
``_screen_slides`` runs it at ``:288`` on a prefix index of its own: the
first ``screen_bits`` bits of the first ``screen_k_per_slide`` slots of every
slide (the prefix form, ``n_slots`` and the query's width here). A CUDA
tensor launches a kernel: the single stage ``screen_kernel`` (``mma.sync``),
every other form ``screen_tma_kernel`` (``wgmma`` over a TMA ring, its tensor
maps encoded per call; one the encoder refuses raises, as a failed launch
does). A CPU tensor takes the plain version, a float32
matmul per chunk of slides (exact for +-1 prefixes), masked to -254, then a
max. Both are bit-equal to the TPU kernel, whose per-frame call scores an
invalid slot otherwise (a -1e6 bias): that changes the best of a slide with
no valid slot among its first ``n_slots`` only, a slide the vote masks.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["SCREEN_BITS", "screen_scores", "screen_scores_plain"]

SCREEN_BITS = 128       # descriptor prefix bits of the batched stage-1 vote
_WIDTHS = (64, 128)     # prefix bytes the kernel takes; a narrower prefix is zero-padded
_INVALID = -254         # an invalid slot: two -127 validity rows x two +1 columns
_D_BITS = 256           # row length of the index desc the kernel reads
_CHUNK_ELEMS = 1 << 28  # float32 scores per matmul of the plain version (1 GiB)


def _best_of(qf: torch.Tensor, desc3: torch.Tensor, valid2: torch.Tensor) -> torch.Tensor:
    """[R, C] float32 best of the float32 queries [R, P] over the slots of
    each of the C slides desc3 [C, n, P] / valid2 [C, n], in chunks of
    slides."""
    r, p = qf.shape
    n_cols, n = valid2.shape
    chunk = max(1, _CHUNK_ELEMS // max(1, r * n))
    best = [qf.new_empty((r, 0))]
    for c0 in range(0, n_cols, chunk):
        d = desc3[c0:c0 + chunk]
        scores = qf @ d.to(torch.float32).reshape(-1, p).T
        scores = torch.where(valid2[c0:c0 + chunk].reshape(1, -1), scores, float(_INVALID))
        best.append(scores.reshape(r, d.shape[0], n).amax(dim=-1))
    return torch.cat(best, dim=1)


def screen_scores_plain(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int, stride: int = 1,
    slide_ids: torch.Tensor | None = None, n_slots: int | None = None,
) -> torch.Tensor:
    """best [R, C] int32: per (query, column) the max over the column's
    slide's slots j * ``stride`` (j < ``n_slots``, by default K / stride) of
    the dot product of the query [R, P] with the slot's P-bit prefix, an
    invalid slot scoring -254. Without ``slide_ids`` the columns are the S
    slides; with slide_ids [G, P'] the query rows form G groups of R / G and
    group g's column c is slide ``slide_ids[g, c]``."""
    bits = query.shape[1]
    d3 = desc.reshape(n_slides, k_per_slide, -1)[:, ::stride][:, :n_slots, :bits]
    v2 = valid.reshape(n_slides, k_per_slide)[:, ::stride][:, :n_slots]
    qf = query.to(torch.float32)
    if slide_ids is None:
        return _best_of(qf, d3, v2).to(torch.int32)
    groups = qf.reshape(slide_ids.shape[0], -1, bits)
    best = [_best_of(q, d3[ids], v2[ids]) for q, ids in zip(groups, slide_ids.long())]
    return torch.cat(best).to(torch.int32)


def screen_scores(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int, stride: int = 1,
    slide_ids: torch.Tensor | None = None, n_slots: int | None = None,
) -> torch.Tensor:
    """Stage-1 screening scores (``screen_scores_plain``'s function).

    query [R, P] int8, P <= 128 the prefix width (+-1 prefixes, invalid rows
    0); desc [S*K, 256] int8 (+-1, invalid slots 0), of which the kernel
    reads each row's first P bytes (64 or 128: a query of another width is
    padded with zero columns to the next, which adds nothing to a dot), at
    slots j * ``stride`` (K a multiple of stride), j < ``n_slots`` (by
    default and at most K / stride); valid [S*K] bool; ``slide_ids`` None
    (columns: the S slides) or [G, P'] int32 (R a multiple of G; group g of
    R / G rows against its P' slides). Returns best [R, S] or [R, P'] int32.
    Counted as ``screen_prefix`` below K / stride slots or at a prefix
    other than 128 bits (the per-frame rule), else ``screen_listed`` with a
    slide list, else ``screen_strided`` at a stride above 1, else
    ``screen``.
    """
    bits = query.shape[1]
    full = k_per_slide // stride
    n = full if n_slots is None else n_slots
    if k_per_slide % stride:
        raise ValueError(f"screen: K = {k_per_slide} is not a multiple of the stride {stride}")
    if not 0 < n <= full:
        raise ValueError(f"screen: n_slots = {n} is outside [1, K / stride = {full}]")
    if not 0 < bits <= _WIDTHS[-1]:
        raise ValueError(f"screen: a {bits}-bit prefix is outside (0, {_WIDTHS[-1]}]")
    if slide_ids is not None and (
        slide_ids.dim() != 2 or slide_ids.shape[0] == 0 or query.shape[0] % slide_ids.shape[0]
    ):
        raise ValueError(
            f"screen: slide_ids {tuple(slide_ids.shape)} is not [G, P] with G dividing the "
            f"{query.shape[0]} query rows"
        )
    if _kernels.plain_or_raise(query):
        return screen_scores_plain(query, desc, valid, n_slides, k_per_slide, stride, slide_ids, n)
    _kernels.require_cuda(query, "screen query", torch.int8, 2)
    _kernels.require_cuda(desc, "screen desc", torch.int8, 2)
    _kernels.require_cuda(valid, "screen valid", torch.bool, 1)
    r = query.shape[0]
    rows = n_slides * k_per_slide
    if desc.shape != (rows, _D_BITS) or valid.shape != (rows,):
        raise ValueError(
            f"screen: desc {tuple(desc.shape)}, valid {tuple(valid.shape)} do not fit "
            f"{n_slides} x {k_per_slide} x {_D_BITS}"
        )
    width = next(w for w in _WIDTHS if bits <= w)
    if bits < width:
        query = torch.nn.functional.pad(query, (0, width - bits))
    if query.data_ptr() % 16 or desc.data_ptr() % 16:
        raise ValueError("screen: query and desc must be 16-byte aligned (cp.async, TMA)")
    if slide_ids is None:
        name, ids_ptr, n_cols, rows_per_group = (
            "screen" if stride == 1 else "screen_strided", None, n_slides, r)
    else:
        _kernels.require_cuda(slide_ids, "screen slide_ids", torch.int32, 2)
        name, ids_ptr, n_cols = "screen_listed", slide_ids.data_ptr(), slide_ids.shape[1]
        rows_per_group = r // slide_ids.shape[0]
    if n < full or bits != SCREEN_BITS:
        name = "screen_prefix"
    best = torch.empty((r, n_cols), dtype=torch.int32, device=query.device)
    if r == 0 or n_cols == 0:
        return best
    _kernels.launch(
        name, "slideo_screen", query,
        query.data_ptr(), r, desc.data_ptr(), valid.data_ptr(), k_per_slide, stride, n, width,
        ids_ptr, n_cols, rows_per_group, best.data_ptr(),
    )
    return best
