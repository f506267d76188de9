"""Exact Hamming matching of +-1 descriptors: index and [Q, S] best table.

Port of ``slideo_tpu/ops/hamming.py`` (exact path). For +-1 vectors
hamming = (256 - <q, d>) / 2, so the table is a max/argmax of dot products
per (query, slide): kernel K5 (csrc/table.cu) on CUDA, the chunked matmul of
``hamming.py:307-358`` on the CPU. Both are bit-equal to the JAX table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slideo_tpu.config import MatchConfig

from .cuda_table import match_table_scores

__all__ = [
    "DescriptorIndex",
    "MatchTable",
    "build_index",
    "match_table",
    "match_table_frame",
]


class DescriptorIndex(NamedTuple):
    """Flattened multi-slide descriptor index.

    desc [N, D] int8 (+-1; zeros on invalid slots), N = n_slides * K;
    slide_ids / train_ids [N] int32; valid [N] bool. ``desc_t`` and
    ``screen_desc`` are the TPU kernels' layouts; the CUDA table kernel
    reads ``desc`` row-major, so the port leaves both None.
    """

    desc: torch.Tensor
    slide_ids: torch.Tensor
    train_ids: torch.Tensor
    valid: torch.Tensor
    desc_t: torch.Tensor | None = None
    screen_desc: torch.Tensor | None = None


class MatchTable(NamedTuple):
    """Per-(query, slide) best match: dist [Q, S] float32 best hamming
    distance, train [Q, S] int32 arg-best slot (first on ties), slide_ids
    [S] int32, valid [Q, S] bool (slide has a valid descriptor)."""

    dist: torch.Tensor
    train: torch.Tensor | None
    slide_ids: torch.Tensor
    valid: torch.Tensor
    dist2: torch.Tensor | None = None


def build_index(slide_desc: torch.Tensor, slide_valid: torch.Tensor) -> DescriptorIndex:
    """Index of per-slide descriptors [S, K, D] and validity [S, K]."""
    s, k, d = slide_desc.shape
    dev = slide_desc.device
    valid = slide_valid.reshape(s * k)
    desc = torch.where(valid[:, None], slide_desc.reshape(s * k, d), 0).to(torch.int8)
    slide_ids = torch.arange(s, dtype=torch.int32, device=dev).repeat_interleave(k)
    train_ids = torch.arange(k, dtype=torch.int32, device=dev).repeat(s)
    return DescriptorIndex(desc.contiguous(), slide_ids, train_ids, valid.contiguous())


def match_table(
    query: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
) -> MatchTable:
    """The exact [Q, S] best-match table (with arg-best train slots)."""
    q, d_bits = query.shape
    best, arg = match_table_scores(query, index.desc, index.valid, n_slides, k_per_slide)
    svalid = index.valid.reshape(n_slides, k_per_slide).any(dim=1)
    return MatchTable(
        dist=(d_bits - best) * 0.5,
        train=arg,
        slide_ids=torch.arange(n_slides, dtype=torch.int32, device=query.device),
        valid=svalid[None, :].expand(q, n_slides),
    )


def match_table_frame(
    query: torch.Tensor,
    index: DescriptorIndex,
    n_slides: int,
    k_per_slide: int,
    cfg: MatchConfig,
) -> MatchTable:
    """Frame-level table: the exact table over every slide, for decks of at
    most ``cfg.screen_above_slides`` slides. Stage-1 screening of larger
    decks is not ported yet, and such a deck is refused, never matched some
    other way."""
    if n_slides > cfg.screen_above_slides:
        raise NotImplementedError(
            f"{n_slides} slides > screen_above_slides={cfg.screen_above_slides}: "
            "the screened path is not ported to slideo_tpu_torch yet"
        )
    return match_table(query, index, n_slides, k_per_slide)
