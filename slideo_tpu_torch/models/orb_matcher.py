"""The ORB frame-vs-slides matcher: features -> exact table -> cascade.

Port of ``slideo_tpu/models/orb_matcher.py`` (reference lib.rs:249-414):

    features -> exact Hamming table -> 5% ratio filter -> group by slide
    -> top-40 by count -> RANSAC -> top-10 by inliers, rating > 50 and
    rating / best > 0.2 -> warp + L2 similarity > 0.5 -> winner.

Decks above ``MatchConfig.screen_above_slides`` slides first screen the
slides, and the exact table then covers each frame's 16 candidate slides:
in one stage-1 sweep per batch (``_match_frames_screened_batch``) where the
JAX package takes it, else frame by frame (``match_frame``).

A frame that matches nothing gets slide -1. The JAX package picks the
frame's query bucket with ``lax.switch`` on device; here the host reads the
valid keypoint count and picks it.

Given a ``StageTracer``, the matcher times its steps as stages: per frame
``match.detect``, ``sync.count`` (the read of the valid count),
``match.describe``, ``match.table``, ``match.draws``, ``match.select``,
``match.ransac`` and ``match.verify`` (with three ``sync.pick`` inside it,
the host's reads of the winner's index), and per screened batch
``match.screen``. They wrap the code and change nothing it computes.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..config import SlideoConfig

from ..ops import features as features_ops
from ..ops import hamming, image, ransac, select, top_k, verify
from ..ops.features import Features, extract_features
from ..utils.trace import DISABLED, StageTracer

__all__ = [
    "SlideIndex",
    "FrameMatch",
    "build_slide_index",
    "build_slide_index_from_chunks",
    "slide_index_from_numpy",
    "match_frame",
    "match_frames",
    "cascade_from_table",
]


class SlideIndex(NamedTuple):
    """Per-deck state on the device: the descriptor index, keypoint
    positions pts [S, K, 2] float32 (page coords) and the verification
    thumbnails smalls [S, hs, ws] float32."""

    desc_index: hamming.DescriptorIndex
    pts: torch.Tensor
    smalls: torch.Tensor


class FrameMatch(NamedTuple):
    """slide int32 (-1: no slide visible), similarity float32 of the winner
    (-inf if none survived), rating float32 RANSAC inliers of the winner."""

    slide: torch.Tensor
    similarity: torch.Tensor
    rating: torch.Tensor


def build_slide_index_from_chunks(
    chunks: Iterable[np.ndarray], cfg: SlideoConfig, device: torch.device | str
) -> SlideIndex:
    """Deck index from an iterator of [c, H, W] uint8 numpy page batches;
    one batch at a time is on the device."""
    descs, valids, pts, smalls = [], [], [], []
    for batch in chunks:
        pages = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        for page in pages:
            f = extract_features(page.to(torch.float32), cfg.orb)
            descs.append(f.desc)
            valids.append(f.valid)
            pts.append(f.pts)
        smalls.append(image.to_small_image(pages, cfg.video.small_image_area))
    index = hamming.build_index(torch.stack(descs), torch.stack(valids))
    return SlideIndex(desc_index=index, pts=torch.stack(pts), smalls=torch.cat(smalls))


def build_slide_index(slide_grays: np.ndarray, cfg: SlideoConfig, device) -> SlideIndex:
    """Deck index of [S, H, W] page images in one batch."""
    return build_slide_index_from_chunks([slide_grays], cfg, device)


def slide_index_from_numpy(
    desc: np.ndarray, valid: np.ndarray, pts: np.ndarray, smalls: np.ndarray,
    device: torch.device | str = "cuda",
) -> SlideIndex:
    """The port's SlideIndex on ``device`` from the JAX package's SlideIndex
    arrays as numpy: desc_index.desc [S*K, D] int8, desc_index.valid [S*K]
    bool, pts [S, K, 2], smalls [S, hs, ws]."""
    s, k = pts.shape[0], pts.shape[1]
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    index = hamming.build_index(
        t(desc).to(torch.int8).reshape(s, k, -1), t(valid).to(torch.bool).reshape(s, k)
    )
    return SlideIndex(
        desc_index=index, pts=t(pts).to(torch.float32), smalls=t(smalls).to(torch.float32)
    )


def _query_buckets(cfg: SlideoConfig) -> tuple[int, ...]:
    """Ascending query-size buckets; max_keypoints is always last."""
    mk = cfg.orb.max_keypoints
    return tuple(sorted({q for q in cfg.orb.query_buckets if 0 < q < mk})) + (mk,)


def cascade_from_table(
    frame_small: torch.Tensor,
    frame_hw: tuple[int, int],
    u: torch.Tensor,
    feats: Features,
    table: hamming.MatchTable,
    slide_pts: torch.Tensor,
    slide_smalls: torch.Tensor,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """The verification cascade after the table (ratio filter -> winner).

    u [C, ransac_iters, 2]: RANSAC's uniform draws (``ransac.uniform_draws``
    in the engine; C = min(top_slides, table columns)).
    """
    mcfg = cfg.match
    with tracer.stage("match.select"):
        cs = select.select_candidates_table(table, feats.valid, mcfg)
        cand_pts = slide_pts[cs.slide_ids.long()]                      # [C, K, 2]
        src = torch.gather(cand_pts, 1, cs.train_ids.long()[..., None].expand(-1, -1, 2))
        dst = feats.pts[cs.query_ids.long()]                           # [C, M, 2]
        valid = cs.match_valid & cs.cand_valid[:, None]
    with tracer.stage("match.ransac"):
        rr = ransac.ransac_similarity(src, dst, valid, u, mcfg)

        # Rating cascade (lib.rs:329-333): top-10 by inliers, floor 50,
        # competitiveness 0.2 of the best rating.
        top_rating, top_idx = top_k(rr.rating, min(mcfg.top_rated, rr.rating.shape[0]))
        best_rating = top_rating[0]
        retain = (top_rating > mcfg.min_rating) & (
            top_rating / torch.clamp(best_rating, min=1e-9) > mcfg.min_rating_ratio
        )
        retain &= (rr.ok & cs.cand_valid)[top_idx]
    with tracer.stage("match.verify"):
        top_t = ransac.Similarity(*(f[top_idx] for f in rr.transform))
        top_slides = cs.slide_ids[top_idx]
        sims = verify.warp_similarity(
            frame_small, frame_hw, top_t, slide_smalls, top_slides, slide_hw,
            cfg.video.small_image_area, stride=mcfg.verify_stride,
        )
        sims = torch.where(retain, sims, -torch.inf)

        # Final pick (lib.rs:370-383): max similarity, must exceed 0.5.
        # Each index by the 0-dim ``win`` reads it on the host.
        win = torch.argmax(sims)
        with tracer.stage("sync.pick"):
            win_sim = sims[win]
        accept = win_sim > mcfg.min_similarity
        with tracer.stage("sync.pick"):
            win_slide = top_slides[win]
        with tracer.stage("sync.pick"):
            win_rating = top_rating[win]
        return FrameMatch(
            slide=torch.where(accept, win_slide, -1).to(torch.int32),
            similarity=win_sim,
            rating=win_rating,
        )


def _frame_features(
    frame: torch.Tensor, cfg: SlideoConfig, tracer: StageTracer = DISABLED
) -> tuple[Features, torch.Tensor]:
    """The frame's features at its query bucket and its verification
    thumbnail: pyramid, detect, describe, thumbnail of atlas level 0 (the
    frame's pixels)."""
    h, w = frame.shape
    with tracer.stage("match.detect"):
        meta = features_ops.pyramid_meta(h, w, cfg.orb)
        atlas = features_ops.build_pyramid(frame.to(torch.float32), cfg.orb)
        kps = features_ops.detect_pyramid(atlas, meta, cfg.orb)
    with tracer.stage("sync.count"):
        count = int(kps.valid.sum())
    with tracer.stage("match.describe"):
        q = next(b for b in _query_buckets(cfg) if b >= count or b == cfg.orb.max_keypoints)
        feats = features_ops.describe(atlas, meta, kps, q, cfg.orb)
        frame_small = image.to_small_image(
            atlas[:h, :w].to(torch.float32), cfg.video.small_image_area
        )
    return feats, frame_small


def _cascade(
    frame_small: torch.Tensor,
    frame_hw: tuple[int, int],
    frame_seed: int,
    feats: Features,
    table: hamming.MatchTable,
    index: SlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """``cascade_from_table`` with the engine's RANSAC draws for the
    table's min(top_slides, columns) candidates."""
    with tracer.stage("match.draws"):
        n_cand = min(cfg.match.top_slides, table.dist.shape[1])
        u = ransac.uniform_draws(n_cand, cfg.match, frame_seed, feats.desc.device)
    return cascade_from_table(
        frame_small, frame_hw, u, feats, table, index.pts, index.smalls, slide_hw, cfg,
        tracer=tracer,
    )


def match_frame(
    frame: torch.Tensor,
    frame_seed: int,
    index: SlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Match one [H, W] grayscale frame against the deck; ``frame_seed``
    (the frame index) seeds the frame's RANSAC draws. A screened deck takes
    the per-frame stage-1 rule (``hamming.screen_slides_frame``), as the
    JAX package's ``match_frame`` does; ``match_frames`` takes the batched
    rule where the JAX package does."""
    n_slides, k_per_slide = index.pts.shape[0], index.pts.shape[1]
    feats, frame_small = _frame_features(frame, cfg, tracer)
    with tracer.stage("match.table"):
        table = hamming.match_table_frame(
            feats.desc, feats.score, index.desc_index, n_slides, k_per_slide, cfg.match,
        )
    return _cascade(
        frame_small, tuple(frame.shape), frame_seed, feats, table, index, slide_hw, cfg,
        tracer,
    )


def _match_frames_screened_batch(
    frames: torch.Tensor,
    frame_seeds: list[int],
    index: SlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Screened-deck batch path (``orb_matcher.py:349-435``): per-frame
    features -> ONE stage-1 sweep over the index for all frames'
    strongest queries -> per frame, the exact table over its candidate
    slides and the cascade."""
    n_slides, k_per_slide = index.pts.shape[0], index.pts.shape[1]
    front = [_frame_features(f, cfg, tracer) for f in frames]
    with tracer.stage("match.screen"):
        qdesc = torch.stack([
            hamming.screen_queries(ft.desc, ft.score, ft.valid, cfg.match) for ft, _ in front
        ])
        cand = hamming.screen_slides_batched(
            qdesc, index.desc_index, n_slides, k_per_slide, cfg.match
        )
    results = []
    for (feats, frame_small), cand_i, seed in zip(front, cand, frame_seeds):
        with tracer.stage("match.table"):
            table = hamming.match_table(
                feats.desc, index.desc_index, n_slides, k_per_slide, slide_ids=cand_i
            )
        results.append(_cascade(
            frame_small, tuple(frames.shape[1:]), int(seed), feats, table, index,
            slide_hw, cfg, tracer,
        ))
    return FrameMatch(*(torch.stack(field) for field in zip(*results)))


def match_frames(
    frames: torch.Tensor,
    frame_seeds: list[int],
    index: SlideIndex,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    tracer: StageTracer = DISABLED,
) -> FrameMatch:
    """Match a [B, H, W] batch; fields come back [B]; ``tracer`` times the
    matcher's stages (see the module's docstring).

    Routed as the JAX package routes it (``orb_matcher.py:454-463``): decks
    above ``cfg.match.screen_above_slides`` take the screened batch path
    when ``screen_bits`` is 128 and K is a multiple of 128 (where the JAX
    package has a screening tensor: on the TPU, ``hamming.py:148-154``; ORB
    descriptors are 256 bits). Every other batch runs frame by frame through
    ``match_frame``: the exact table, or above the limit the per-frame
    stage-1 rule, which honours ``screen_bits`` and ``screen_k_per_slide``."""
    n_slides, k_per_slide = index.pts.shape[0], index.pts.shape[1]
    mcfg = cfg.match
    if (n_slides > mcfg.screen_above_slides and mcfg.screen_bits == hamming.SCREEN_BITS
            and k_per_slide % 128 == 0):
        return _match_frames_screened_batch(frames, frame_seeds, index, slide_hw, cfg, tracer)
    results = [
        match_frame(f, int(s), index, slide_hw, cfg, tracer) for f, s in zip(frames, frame_seeds)
    ]
    return FrameMatch(*(torch.stack(field) for field in zip(*results)))
