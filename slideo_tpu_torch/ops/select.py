"""Ratio filter, per-slide grouping and candidate compaction.

Port of ``slideo_tpu/ops/select.py:29-145`` (reference lib.rs:268-295): the
5%-of-best distance filter with its quirk that a best distance of 0 keeps
nothing, the per-query fan-out cap of knn_k slides, ranking slides by
kept-match count, and compacting each of the top candidates' matches by
ascending distance. Every top-k is ``ops.top_k`` (ties: lowest index
first), as ``jax.lax.top_k`` orders them. The SIFT engine's rule,
``select_candidates_lowe`` (``select.py:147-195``), keeps a (query, slide)
match by Lowe's ratio within that slide and compacts the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig

from . import top_k
from .hamming import MatchTable

__all__ = [
    "CandidateMatches",
    "rank_candidates_table",
    "compact_from_rank",
    "select_candidates_table",
    "select_candidates_lowe",
]

_BIG = 1e6


class CandidateMatches(NamedTuple):
    """Per-candidate compacted matches: slide_ids [C] int32, cand_valid [C]
    bool, query_ids / train_ids [C, M] int32, match_valid [C, M] bool (valid
    entries first, by ascending distance), counts [C] float32."""

    slide_ids: torch.Tensor
    cand_valid: torch.Tensor
    query_ids: torch.Tensor
    train_ids: torch.Tensor
    match_valid: torch.Tensor
    counts: torch.Tensor


def rank_candidates_table(
    table: MatchTable, query_valid: torch.Tensor, cfg: MatchConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ratio filter + fan-out cap, slides ranked by kept-match count.
    Returns (keep [Q, S] bool, top_counts [C] descending, cand_cols [C])."""
    s = table.dist.shape[1]
    valid = table.valid & query_valid[:, None]
    dist = torch.where(valid, table.dist, _BIG)
    best = dist.amin(dim=1, keepdim=True)
    keep = valid & (table.dist < best * cfg.ratio)
    if s > cfg.knn_k:
        key = torch.where(keep, _BIG - table.dist, -_BIG)
        kth = top_k(key, cfg.knn_k)[0][:, -1:]
        keep &= key >= torch.clamp(kth, min=0.0)
    counts = keep.sum(dim=0).to(torch.float32)
    top_counts, cand_cols = top_k(counts, min(cfg.top_slides, s))
    return keep, top_counts, cand_cols


def compact_from_rank(
    table: MatchTable,
    keep: torch.Tensor,
    top_counts: torch.Tensor,
    cand_cols: torch.Tensor,
    cfg: MatchConfig,
) -> CandidateMatches:
    """Each candidate's kept matches, strongest (smallest distance) first."""
    q = keep.shape[0]
    m = min(cfg.max_matches_per_slide, q)
    key = torch.where(keep, _BIG - table.dist, -_BIG).T[cand_cols]   # [C, Q]
    topv, qidx = top_k(key, m)
    train_cq = table.train.T[cand_cols]                                # [C, Q]
    return CandidateMatches(
        slide_ids=table.slide_ids[cand_cols],
        cand_valid=top_counts > 0,
        query_ids=qidx.to(torch.int32),
        train_ids=torch.gather(train_cq, 1, qidx),
        match_valid=topv > 0,
        counts=top_counts,
    )


def select_candidates_table(
    table: MatchTable, query_valid: torch.Tensor, cfg: MatchConfig
) -> CandidateMatches:
    """Candidate selection from a best-match table (lib.rs:268-295)."""
    keep, top_counts, cand_cols = rank_candidates_table(table, query_valid, cfg)
    return compact_from_rank(table, keep, top_counts, cand_cols, cfg)


def select_candidates_lowe(
    table: MatchTable, query_valid: torch.Tensor, cfg: MatchConfig, lowe_ratio: float = 0.75
) -> CandidateMatches:
    """Candidate selection by Lowe's ratio PER SLIDE: a (query, slide)
    pair's best match is kept iff dist < lowe_ratio * dist2 within that
    slide (``table.dist2`` from ``hamming.match_table_float``), so a kept
    match does not depend on which other slides the table holds; slides
    are ranked by kept-match count and each candidate's matches compacted
    by ascending distance, as in ``select_candidates_table``."""
    if table.dist2 is None:
        raise ValueError("select_candidates_lowe needs a table from match_table_float (dist2)")
    q, s = table.dist.shape
    keep = table.valid & query_valid[:, None] & (table.dist < lowe_ratio * table.dist2)
    counts = keep.sum(dim=0).to(torch.float32)
    top_counts, cand_cols = top_k(counts, min(cfg.top_slides, s))
    return compact_from_rank(table, keep, top_counts, cand_cols, cfg)
