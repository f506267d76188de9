"""Wrapper of kernel K5 (csrc/table.cu): exact per-slide best dot + argmax.

Replaces ``slideo_tpu/ops/pallas_table.py:match_table_scores_pallas`` in the
int8 / with-argmax mode of the exact table (and, on an index shard, its
non-transposed mode; over the first ``n_slots`` slots of each slide, the
per-frame stage-1 rule's max-only table at a prefix above 128 bits). A CUDA
tensor launches the kernel (int8 tensor cores);
a CPU tensor takes the plain version, the chunked matmul + max / argmax of
``hamming.py:307-358``. Both are bit-equal to the JAX table. A slide id
outside the index raises ``ValueError`` in the plain version and traps in
the kernel, which checks it on the card instead of syncing the host.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["match_table_scores", "match_table_scores_plain"]

_NEG = -(2**30)      # score of an invalid slot (hamming._NEG)
_D_BITS = 256        # descriptor length: one int8 a bit, 256 bytes a row
_CHUNK_SLIDES = 8    # slides per matmul of the plain version
_MAX_SLOTS = 65536 - 63  # slots a call may score a slide: the kernel packs a slot into 16 bits


def match_table_scores_plain(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int, slide_ids: torch.Tensor | None = None,
    n_slots: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(best [Q, C] float32, arg [Q, C] int32) by chunks of slides over the
    first ``n_slots`` slots of each (all K when None): f32 matmul (exact for
    +-1), invalid slots scored -2^30, first argmax."""
    d3 = desc.reshape(n_slides, k_per_slide, -1)
    v2 = valid.reshape(n_slides, k_per_slide)
    if slide_ids is not None:
        if not bool(((slide_ids >= 0) & (slide_ids < n_slides)).all()):
            raise ValueError(f"match_table: slide_ids outside [0, {n_slides})")
        d3, v2 = d3[slide_ids.long()], v2[slide_ids.long()]
    d3, v2 = d3[:, :n_slots], v2[:, :n_slots]
    n_cols, n = v2.shape
    q = query.shape[0]
    qf = query.to(torch.float32)
    best, arg = [], []
    for s0 in range(0, n_cols, _CHUNK_SLIDES):
        s1 = min(s0 + _CHUNK_SLIDES, n_cols)
        d = d3[s0:s1].reshape(-1, d3.shape[-1]).to(torch.float32)
        scores = (qf @ d.T).reshape(q, s1 - s0, n)
        scores = torch.where(v2[None, s0:s1], scores, float(_NEG))
        best.append(scores.amax(dim=-1))
        arg.append(scores.argmax(dim=-1).to(torch.int32))
    return torch.cat(best, dim=1), torch.cat(arg, dim=1)


def match_table_scores(
    query: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
    n_slides: int, k_per_slide: int, slide_ids: torch.Tensor | None = None,
    n_slots: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best score and first arg-best slot of every (query, table column).

    query [Q, 256] int8 (+-1, invalid rows 0); desc [S*K, 256] int8 (+-1,
    invalid slots 0); valid [S*K] bool. The table's columns are the slides
    ``slide_ids`` ([C] int32) of the index, or all S slides when it is None;
    on the card an id outside [0, S) traps (a CUDA error at the next sync).
    Each column scores the first ``n_slots`` slots of its slide (1 <=
    n_slots <= K; all K when None). Returns (best [Q, C] float32, arg [Q, C]
    int32).
    """
    n = k_per_slide if n_slots is None else n_slots
    if not 0 < n <= k_per_slide:
        raise ValueError(f"match_table: n_slots = {n} is outside [1, K = {k_per_slide}]")
    if _kernels.plain_or_raise(query):
        return match_table_scores_plain(query, desc, valid, n_slides, k_per_slide, slide_ids, n)
    _kernels.require_cuda(query, "match_table query", torch.int8, 2)
    _kernels.require_cuda(desc, "match_table desc", torch.int8, 2)
    _kernels.require_cuda(valid, "match_table valid", torch.bool, 1)
    q = query.shape[0]
    rows = n_slides * k_per_slide
    if query.shape[1] != _D_BITS or desc.shape != (rows, _D_BITS) or valid.shape != (rows,):
        raise ValueError(
            f"match_table: query {tuple(query.shape)}, desc {tuple(desc.shape)}, "
            f"valid {tuple(valid.shape)} do not fit {n_slides} x {k_per_slide} x {_D_BITS}"
        )
    if n > _MAX_SLOTS:
        raise ValueError(f"match_table: {n} slots a slide exceed the kernel's {_MAX_SLOTS}")
    if query.data_ptr() % 16 or desc.data_ptr() % 16:
        raise ValueError("match_table: query and desc must be 16-byte aligned (cp.async)")
    n_cols, list_ptr = n_slides, None
    if slide_ids is not None:
        _kernels.require_cuda(slide_ids, "match_table slide_ids", torch.int32, 1)
        n_cols, list_ptr = slide_ids.shape[0], slide_ids.data_ptr()
    best = torch.empty((q, n_cols), dtype=torch.float32, device=query.device)
    arg = torch.empty((q, n_cols), dtype=torch.int32, device=query.device)
    if q == 0 or n_cols == 0:
        return best, arg
    _kernels.launch(
        "table", "slideo_match_table", query,
        query.data_ptr(), q, desc.data_ptr(), valid.data_ptr(), n_slides, n_cols,
        k_per_slide, n, list_ptr, best.data_ptr(), arg.data_ptr(),
    )
    return best, arg
