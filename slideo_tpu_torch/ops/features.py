"""ORB feature extraction over a shelf-packed pyramid atlas.

Port of ``slideo_tpu/ops/features.py``: ``build_pyramid`` packs all levels
of successive exact 1.2x downscales into one [Ha, W] atlas (bf16 when
``OrbConfig.atlas_bf16``), ``detect_pyramid`` scores the whole atlas once
with FAST + NMS (kernel K1) and takes per-level quota top-k, and
``describe`` compacts the strongest ``q`` slots and runs the fused
orientation + steered BRIEF (kernel K3+K4). Slides and frames take the same
32-bin describe on every device, so their descriptors stay comparable.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import OrbConfig

from . import top_k
from .cuda_fast import fast_score_map
from .cuda_orb import level_origins, orb_describe

__all__ = [
    "Features",
    "Keypoints",
    "PyramidMeta",
    "pyramid_meta",
    "level_sizes",
    "resize_65",
    "build_pyramid",
    "detect_pyramid",
    "detect_from_scores",
    "patch_origins_of",
    "strongest",
    "describe",
    "extract_features",
]


class Features(NamedTuple):
    """Fixed-size feature set of one image.

    pts [K, 2] float32 (x, y) level-0 coords; desc [K, 256] int8 in {-1, +1}
    (0 on invalid slots); score [K] float32; valid [K] bool.
    """

    pts: torch.Tensor
    desc: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


class Keypoints(NamedTuple):
    """Detections concatenated over levels: score [K] float32, level-local
    y, x [K] int32, level [K] int32, valid [K] bool."""

    score: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    level: torch.Tensor
    valid: torch.Tensor


class PyramidMeta(NamedTuple):
    """Pyramid geometry of one image size: per-level (h, w), row and column
    offsets inside the atlas, and the atlas size (packed height, level-0
    width)."""

    sizes: tuple[tuple[int, int], ...]
    offsets: tuple[int, ...]
    xoffsets: tuple[int, ...]
    atlas_hw: tuple[int, int]


def _next_65(n: int) -> int:
    """Output size of one 5:6 block-periodic downscale (pads n to mult of 6)."""
    return 5 * ((n + 5) // 6)


def level_sizes(h: int, w: int, cfg: OrbConfig) -> list[tuple[int, int]]:
    out = [(h, w)]
    for _ in range(1, cfg.n_levels):
        h, w = _next_65(h), _next_65(w)
        out.append((h, w))
    return out


def pyramid_meta(h: int, w: int, cfg: OrbConfig) -> PyramidMeta:
    """Shelf-pack the levels into a [Ha, w] atlas (greedy first fit)."""
    sizes = tuple(level_sizes(h, w, cfg))
    offsets = [0]
    xoffsets = [0]
    shelves: list[list[int]] = []  # [row_start, height, x_cursor]
    row = sizes[0][0]
    for lh, lw in sizes[1:]:
        for shelf in shelves:
            if lh <= shelf[1] and shelf[2] + lw <= w:
                offsets.append(shelf[0])
                xoffsets.append(shelf[2])
                shelf[2] += lw
                break
        else:
            shelves.append([row, lh, lw])
            offsets.append(row)
            xoffsets.append(0)
            row += lh
    return PyramidMeta(
        sizes=sizes, offsets=tuple(offsets), xoffsets=tuple(xoffsets),
        atlas_hw=(row, w),
    )


@lru_cache(maxsize=64)
def _resize_65_weights(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] tent matrix of the exact 6->5 block resize, computed in
    float32 with the JAX package's operation order (its weights are built
    from iota on device, so every rounding step is reproduced here)."""
    f = np.float32
    i = np.broadcast_to(np.arange(n_out, dtype=f)[:, None], (n_out, n_in))
    j = np.broadcast_to(np.arange(n_in, dtype=f)[None, :], (n_out, n_in))
    block = np.floor(i / f(5.0))
    frac = f(1.2) * (i - f(5.0) * block) + f(0.1)
    base = np.minimum(f(6.0) * block, f(n_in - 1))
    frac = np.where(f(6.0) * block > f(n_in - 1), f(0.0), frac)
    frac = np.minimum(frac, f(n_in - 1) - base)
    d = (base - j) + frac
    return np.maximum(f(0.0), f(1.0) - np.abs(d)).astype(f)


@lru_cache(maxsize=64)
def _resize_65_weights_on(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_65_weights(n_out, n_in)).to(device)


def resize_65(img: torch.Tensor) -> torch.Tensor:
    """Downscale [H, W] float32 by exactly 1.2x per axis (rows, then
    columns; level->level0 map x0 = 1.2**l * x + (1.2**l - 1) / 2)."""
    h, w = img.shape
    r = _resize_65_weights_on(_next_65(h), h, img.device)
    c = _resize_65_weights_on(_next_65(w), w, img.device)
    return torch.matmul(torch.matmul(r, img), c.T)


def build_pyramid(img: torch.Tensor, cfg: OrbConfig) -> torch.Tensor:
    """Pack all pyramid levels of a [H, W] image into one [Ha, W] atlas.
    The level chain stays float32; ``atlas_bf16`` quantizes the stored copy."""
    h, w = img.shape
    meta = pyramid_meta(h, w, cfg)
    dtype = torch.bfloat16 if cfg.atlas_bf16 else torch.float32
    atlas = torch.zeros(meta.atlas_hw, dtype=dtype, device=img.device)
    prev = img.to(torch.float32)
    for lvl, ((lh, lw), off, xoff) in enumerate(
        zip(meta.sizes, meta.offsets, meta.xoffsets)
    ):
        if lvl > 0:
            prev = resize_65(prev)
        atlas[off:off + lh, xoff:xoff + lw] = prev.to(dtype)
    return atlas


def _level_scales(cfg: OrbConfig) -> np.ndarray:
    return np.asarray(
        [cfg.scale_factor**lvl for lvl in range(cfg.n_levels)], np.float32
    )


def detect_pyramid(atlas: torch.Tensor, meta: PyramidMeta, cfg: OrbConfig) -> Keypoints:
    """FAST keypoints per level with geometric quotas, from ONE score sweep
    over the whole atlas (kernel K1 on CUDA). Every consumer masks a
    per-level border of ``edge_threshold`` px, wider than the 4 px that
    FAST + NMS reach across a level boundary."""
    return detect_from_scores(fast_score_map(atlas, cfg.fast_threshold), meta, cfg)


def detect_from_scores(
    score_atlas: torch.Tensor, meta: PyramidMeta, cfg: OrbConfig
) -> Keypoints:
    """Per-level quota top-k over an NMS'd FAST score atlas; slots a level
    cannot fill are invalid, and the set is padded to ``max_keypoints``."""
    dev = score_atlas.device
    border = cfg.edge_threshold
    parts: list[Keypoints] = []
    for lvl, ((lh, lw), off, xoff, quota) in enumerate(
        zip(meta.sizes, meta.offsets, meta.xoffsets, cfg.per_level_quota)
    ):
        if quota <= 0:
            continue
        level = torch.full((quota,), lvl, dtype=torch.int32, device=dev)
        if not (lh > 2 * border and lw > 2 * border):
            zeros = torch.zeros((quota,), dtype=torch.int32, device=dev)
            parts.append(Keypoints(
                score=torch.zeros((quota,), dtype=torch.float32, device=dev),
                y=zeros, x=zeros, level=level,
                valid=torch.zeros((quota,), dtype=torch.bool, device=dev),
            ))
            continue
        score = torch.zeros((lh, lw), dtype=torch.float32, device=dev)
        score[border:lh - border, border:lw - border] = score_atlas[
            off + border:off + lh - border, xoff + border:xoff + lw - border
        ]
        top, idx = top_k(score.reshape(-1), quota)
        parts.append(Keypoints(
            score=top,
            y=(idx // lw).to(torch.int32),
            x=(idx % lw).to(torch.int32),
            level=level,
            valid=top > 0.0,
        ))
    kps = Keypoints(*(torch.cat(f) for f in zip(*parts)))
    pad = cfg.max_keypoints - kps.score.shape[0]
    if pad < 0:
        raise ValueError(
            f"quota sum {kps.score.shape[0]} exceeds max_keypoints {cfg.max_keypoints}"
        )
    if pad:
        kps = Keypoints(*(torch.nn.functional.pad(f, (0, pad)) for f in kps))
    return kps


@lru_cache(maxsize=32)
def _level_tables(
    meta: PyramidMeta, cfg: OrbConfig, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level lookup tables on ``device``: int32 [4, L] rows (row offset,
    column offset, height, width) and the float32 [L] level->level0 scales."""
    rows = [
        list(meta.offsets), list(meta.xoffsets),
        [s[0] for s in meta.sizes], [s[1] for s in meta.sizes],
    ]
    ints = torch.tensor(rows, dtype=torch.int32, device=device)
    r = torch.from_numpy(_level_scales(cfg)).to(device)
    return ints, r


def patch_origins_of(
    meta: PyramidMeta, kps: Keypoints, cfg: OrbConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Atlas top-left (y0, x0) of each keypoint's 63x63 patch, clamped
    inside the keypoint's own level (padded slots clamp harmlessly)."""
    return level_origins(kps.y, kps.x, kps.level, _level_tables(meta, cfg, kps.y.device)[0])


def strongest(kps: Keypoints, q: int) -> Keypoints:
    """The ``q`` strongest keypoint slots, valid ones first (all of them
    when ``q`` is not below their count)."""
    if q >= kps.score.shape[0]:
        return kps
    _, sel = top_k(torch.where(kps.valid, kps.score, -1.0), q)
    return Keypoints(*(f[sel] for f in kps))


def describe(
    atlas: torch.Tensor, meta: PyramidMeta, kps: Keypoints, q: int, cfg: OrbConfig
) -> Features:
    """Descriptors for the strongest ``q`` keypoint slots. With ``q`` at
    least the valid count the compaction only drops padding slots."""
    kps = strongest(kps, q)

    ints, scales = _level_tables(meta, cfg, atlas.device)
    desc, _ = orb_describe(
        atlas, kps.y, kps.x, kps.level, ints, cfg.descriptor_bits, cfg.pattern_seed,
        cfg.blur_ksize, cfg.blur_sigma,
    )
    desc = torch.where(kps.valid[:, None], desc, 0).to(torch.int8)

    # Exact level->level0 affine map of the successive 1.2x resizes.
    r = scales[kps.level.long()]
    half = (r - 1.0) * 0.5
    pts = torch.stack(
        [kps.x.to(torch.float32) * r + half, kps.y.to(torch.float32) * r + half],
        dim=-1,
    )
    return Features(pts=pts, desc=desc, score=kps.score, valid=kps.valid)


def extract_features(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """ORB features of a [H, W] grayscale image, padded to max_keypoints."""
    h, w = img.shape
    meta = pyramid_meta(h, w, cfg)
    atlas = build_pyramid(img, cfg)
    kps = detect_pyramid(atlas, meta, cfg)
    return describe(atlas, meta, kps, cfg.max_keypoints, cfg)
