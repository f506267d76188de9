"""The SIFT frame-vs-slides matcher: DoG features -> float table -> Lowe
per slide -> RANSAC homography -> rating cascade -> projective warp.

Port of ``slideo_tpu/models/sift_matcher.py``, the engine users choose for
camera-recorded talks where the slide is seen in perspective. It reuses
the ORB matcher's acceptance thresholds (``MatchConfig``: top-10 rating
cascade, rating ratio, similarity) with SIFT's own rating floor
(``SiftConfig.min_rating``), so both engines plug into one pipeline.

A ``StageTracer`` (the engine's, in ``match_samples``) times each frame's
stages: "sift.features" (the features, with each octave's "sift.detect"
and "sift.describe" inside, and the thumbnail), "sift.table" (the float
table, stage 1 above the screening limit), "sift.lowe" (Lowe's ratio and
the gathers of the matches), "sift.draws", "sift.homography" (RANSAC and
the rating cascade) and "sift.verify" (K6h's similarities and the winner,
whose three reads by the 0-dim argmax are "sync.pick" stages).

Decks above ``MatchConfig.screen_above_slides`` slides first vote each
frame's candidate slides with the bf16 stage-1 sweep
(``hamming.screen_slides_float``); the exact f32 table then covers those
slides only, read in place. Verification samples the frame's thumbnail at
the homography-mapped grid: kernel K6h on CUDA.

A frame that matches nothing gets slide -1.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..config import SlideoConfig
from ..ops import hamming, homography, image, ransac, select, top_k, verify
from ..ops.sift import SiftFeatures, extract_sift
from ..utils.trace import DISABLED, StageTracer
from .orb_matcher import FrameMatch

__all__ = [
    "SiftSlideIndex",
    "RatedCandidates",
    "build_slide_index_sift_from_chunks",
    "build_slide_index_sift",
    "sift_index_from_numpy",
    "frame_features",
    "sift_table",
    "rate_candidates",
    "verify_winner",
    "match_frame_sift",
    "match_frames_sift",
]


class SiftSlideIndex(NamedTuple):
    """Per-deck state on the device: desc [S*K, 128] float32 unit
    descriptors, valid [S*K] bool, pts [S, K, 2] float32 (page coords),
    scale [S, K] float32 octave scale of each keypoint, smalls [S, hs, ws]
    float32 verification thumbnails."""

    desc: torch.Tensor
    valid: torch.Tensor
    pts: torch.Tensor
    scale: torch.Tensor
    smalls: torch.Tensor


class RatedCandidates(NamedTuple):
    """The top-rated candidates of a frame after RANSAC: h [T, 8]
    homographies (slide -> frame pixels), slides [T] int32, rating [T]
    float32 (descending) and retain [T] bool (passed the rating cascade)."""

    h: torch.Tensor
    slides: torch.Tensor
    rating: torch.Tensor
    retain: torch.Tensor


def build_slide_index_sift_from_chunks(
    chunks: Iterable[np.ndarray], cfg: SlideoConfig, device: torch.device | str
) -> SiftSlideIndex:
    """Deck index from an iterator of [c, H, W] uint8 numpy page batches
    (the engine hands 32 pages a chunk, as ``build_slide_index_sift_chunked``
    does); one batch at a time is on the device."""
    feats, smalls = [], []
    for batch in chunks:
        pages = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        feats.extend(extract_sift(page.to(torch.float32), cfg.sift) for page in pages)
        smalls.append(image.to_small_image(pages, cfg.video.small_image_area))
    desc, valid, pts, scale = (
        torch.stack([getattr(f, name) for f in feats]) for name in ("desc", "valid", "pts", "scale")
    )
    s, k, d = desc.shape
    return SiftSlideIndex(
        desc=desc.reshape(s * k, d), valid=valid.reshape(s * k), pts=pts, scale=scale,
        smalls=torch.cat(smalls),
    )


def build_slide_index_sift(
    slide_grays: np.ndarray, cfg: SlideoConfig, device: torch.device | str
) -> SiftSlideIndex:
    """Deck index of [S, H, W] page images in one batch."""
    return build_slide_index_sift_from_chunks([slide_grays], cfg, device)


def sift_index_from_numpy(
    desc: np.ndarray, valid: np.ndarray, pts: np.ndarray, scale: np.ndarray,
    smalls: np.ndarray, device: torch.device | str = "cuda",
) -> SiftSlideIndex:
    """The port's SiftSlideIndex on ``device`` from the JAX package's
    SiftSlideIndex arrays as numpy (desc [S*K, 128], valid [S*K], pts
    [S, K, 2], scale [S, K], smalls [S, hs, ws])."""
    t = lambda a, dtype: torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)  # noqa: E731
    return SiftSlideIndex(
        desc=t(desc, torch.float32), valid=t(valid, torch.bool), pts=t(pts, torch.float32),
        scale=t(scale, torch.float32), smalls=t(smalls, torch.float32),
    )


def frame_features(
    frame: torch.Tensor, cfg: SlideoConfig, tracer: StageTracer = DISABLED
) -> tuple[SiftFeatures, torch.Tensor]:
    """A [H, W] frame's SIFT features and its verification thumbnail. The
    frame's thumbnail keeps the default area whatever
    ``cfg.video.small_image_area`` is (only the slides' thumbnails take it),
    as the JAX package's ``warp_similarity_homography`` makes it
    (``verify.py:162,175-176``)."""
    with tracer.stage("sift.features"):
        frame = frame.to(torch.float32)
        return extract_sift(frame, cfg.sift, tracer), image.to_small_image(frame)


def sift_table(feats: SiftFeatures, index: SiftSlideIndex, cfg: SlideoConfig) -> hamming.MatchTable:
    """The frame's float table: over every slide for decks of at most
    ``screen_above_slides`` slides, else over its stage-1 candidates
    (``sift_matcher.py:130-149``)."""
    n_slides, k_per_slide = index.pts.shape[0], index.pts.shape[1]
    mcfg = cfg.match
    cand = None
    if n_slides > mcfg.screen_above_slides:
        score = torch.where(feats.valid, feats.score, -1.0)
        cand = hamming.screen_slides_float(
            feats.desc, score, index.desc, index.valid, n_slides, k_per_slide, mcfg
        )
    return hamming.match_table_float(
        feats.desc, index.desc, index.valid, n_slides, k_per_slide, slide_ids=cand
    )


def rate_candidates(
    feats: SiftFeatures,
    table: hamming.MatchTable,
    index: SiftSlideIndex,
    u: torch.Tensor,
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> RatedCandidates:
    """Lowe per slide -> RANSAC homography with a scale-aware tolerance ->
    the top-10 rating cascade (``sift_matcher.py:150-178``).

    u [C, ransac_iters, 4]: RANSAC's uniform draws (C = min(top_slides,
    table columns); ``ransac.uniform_draws`` with 4 points in the engine).
    """
    mcfg = cfg.match
    with tracer.stage("sift.lowe"):
        cs = select.select_candidates_lowe(table, feats.valid, mcfg, cfg.sift.lowe_ratio)
        slides, train, query = cs.slide_ids.long(), cs.train_ids.long(), cs.query_ids.long()
        src = torch.gather(index.pts[slides], 1, train[..., None].expand(-1, -1, 2))
        dst = feats.pts[query]
        valid = cs.match_valid & cs.cand_valid[:, None]
        # Localisation error grows with the detection octave on both sides.
        tol = torch.maximum(torch.gather(index.scale[slides], 1, train), feats.scale[query])
    with tracer.stage("sift.homography"):
        rr = homography.ransac_homography(src, dst, valid, u, mcfg, tol=tol)

        top_rating, top_idx = top_k(rr.rating, min(mcfg.top_rated, rr.rating.shape[0]))
        best_rating = top_rating[0]
        retain = (top_rating > cfg.sift.min_rating) & (
            top_rating / torch.clamp(best_rating, min=1e-9) > mcfg.min_rating_ratio
        )
        retain &= (rr.ok & cs.cand_valid)[top_idx]
    return RatedCandidates(
        h=rr.transform.h[top_idx], slides=cs.slide_ids[top_idx], rating=top_rating, retain=retain
    )


def verify_winner(
    frame_small: torch.Tensor,
    frame_hw: tuple[int, int],
    rated: RatedCandidates,
    index: SiftSlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Projective warp similarity of the rated candidates (K6h on CUDA) and
    the winner: the largest similarity, which must exceed min_similarity."""
    mcfg = cfg.match
    with tracer.stage("sift.verify"):
        sims = verify.warp_similarity_homography(
            frame_small, frame_hw, rated.h, index.smalls, rated.slides, slide_hw,
            stride=mcfg.verify_stride,
        )
        sims = torch.where(rated.retain, sims, -torch.inf)
        # Each index by the 0-dim ``win`` reads it on the host.
        win = torch.argmax(sims)
        with tracer.stage("sync.pick"):
            win_sim = sims[win]
        accept = win_sim > mcfg.min_similarity
        with tracer.stage("sync.pick"):
            win_slide = rated.slides[win]
        with tracer.stage("sync.pick"):
            win_rating = rated.rating[win]
        return FrameMatch(
            slide=torch.where(accept, win_slide, -1).to(torch.int32),
            similarity=win_sim,
            rating=win_rating,
        )


def match_frame_sift(
    frame: torch.Tensor,
    frame_seed: int,
    index: SiftSlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    u: torch.Tensor | None = None,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Match one [H, W] grayscale frame against the deck. ``frame_seed``
    (the frame index) seeds the frame's RANSAC draws, unless ``u``
    [C, ransac_iters, 4] hands them in (the tests hand in JAX's);
    ``tracer`` times the stages (see the module's docstring)."""
    feats, frame_small = frame_features(frame, cfg, tracer)
    with tracer.stage("sift.table"):
        table = sift_table(feats, index, cfg)
    if u is None:
        with tracer.stage("sift.draws"):
            n_cand = min(cfg.match.top_slides, table.dist.shape[1])
            u = ransac.uniform_draws(n_cand, cfg.match, frame_seed, feats.desc.device, n_points=4)
    rated = rate_candidates(feats, table, index, u, cfg, tracer)
    return verify_winner(frame_small, tuple(frame.shape), rated, index, slide_hw, cfg, tracer)


def match_frames_sift(
    frames: torch.Tensor,
    frame_seeds: list[int],
    index: SiftSlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Match a [B, H, W] batch frame by frame; fields come back [B]."""
    results = [
        match_frame_sift(f, int(s), index, slide_hw, cfg, tracer=tracer)
        for f, s in zip(frames, frame_seeds)
    ]
    return FrameMatch(*(torch.stack(field) for field in zip(*results)))
