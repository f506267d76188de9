"""SIFT-family scale-invariant features of the SIFT engine.

Port of ``slideo_tpu/ops/sift.py``: per octave, four Gaussian blurs, three
DoG levels, per-level spatial extrema with the contrast and edge tests
(``torch.roll`` shifts, the wrap-around borders masked), the strongest
``|DoG|`` responses as keypoints (``ops.top_k``, exact and stable, where
the JAX package asks for ``approx_max_k``, which the CPU computes exactly),
a 36-bin orientation histogram (first argmax), and a 4x4x8 descriptor over
a rotated 16x16 sample grid, tent-sampled from the keypoint's patch.

Descriptors are 128-d unit float vectors; ``hamming.match_table_float``
matches them by dot product (dist^2 = 2 - 2*dot).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import SiftConfig
from ..utils.trace import DISABLED, StageTracer
from . import image as image_ops
from . import top_k
from .orb import HALF_PATCH, PATCH, extract_patches, sample_patches

__all__ = ["SiftFeatures", "extract_sift"]


class SiftFeatures(NamedTuple):
    """Fixed-size SIFT feature set of one image: pts [K, 2] float32 (x, y)
    in full-image coordinates, desc [K, 128] float32 L2-normalised (zeros
    on invalid slots), score [K] float32 |DoG| response, scale [K] float32
    octave scale (2**octave), valid [K] bool."""

    pts: torch.Tensor
    desc: torch.Tensor
    score: torch.Tensor
    scale: torch.Tensor
    valid: torch.Tensor


def _roll(d: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(d, shifts=(dy, dx), dims=(0, 1))


def _dog_extrema(d_mid: torch.Tensor, contrast: float, edge_r: float):
    """Spatial extrema mask and |response| of one DoG level
    (``sift.py:57-99``): strictly above (below) its 8 neighbours and the
    contrast, and tr(H)^2 / det(H) < (r+1)^2 / r on the 2x2 Hessian."""
    others = [_roll(d_mid, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    omax = others[0]
    omin = others[0]
    for v in others[1:]:
        omax = torch.maximum(omax, v)
        omin = torch.minimum(omin, v)
    is_max = (d_mid > omax) & (d_mid > contrast)
    is_min = (d_mid < omin) & (d_mid < -contrast)

    dxx, dyy, dxy = _hessian(d_mid)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr * edge_r < (edge_r + 1) ** 2 * det)
    return (is_max | is_min) & edge_ok, torch.abs(d_mid)


def _hessian(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dxx, dyy, dxy of ``d`` by central differences (rolls wrap)."""
    dxx = _roll(d, 0, -1) + _roll(d, 0, 1) - 2 * d
    dyy = _roll(d, -1, 0) + _roll(d, 1, 0) - 2 * d
    dxy = 0.25 * (_roll(d, -1, -1) + _roll(d, 1, 1) - _roll(d, -1, 1) - _roll(d, 1, -1))
    return dxx, dyy, dxy


@lru_cache(maxsize=8)
def _descriptor_geometry(cfg_key: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static sample grid [G, 2] (unrotated patch px, G = 16*16), the
    trilinear weight [G, 16] of each sample in each of the 4x4 spatial
    cells, and the Gaussian window [G] (``sift.py:102-125``)."""
    n_grid, n_cells, radius = cfg_key
    step = 2.0 * radius / n_grid
    coords = (np.arange(n_grid) + 0.5) * step - radius
    gx, gy = np.meshgrid(coords, coords)
    grid = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    cstep = 2.0 * radius / 4
    cc = (np.arange(4) + 0.5) * cstep - radius
    cgx, cgy = np.meshgrid(cc, cc)
    centers = np.stack([cgx.ravel(), cgy.ravel()], -1)
    wx = np.maximum(0, 1 - np.abs(grid[:, None, 0] - centers[None, :, 0]) / cstep)
    wy = np.maximum(0, 1 - np.abs(grid[:, None, 1] - centers[None, :, 1]) / cstep)
    cell_w = (wx * wy).astype(np.float32)
    gauss = np.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2) / (2 * (radius * 0.5) ** 2))
    return grid, cell_w, gauss.astype(np.float32)


def _descriptors_from_patches(
    patches: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, radius: float
) -> torch.Tensor:
    """[K, 128] descriptors of [K, PATCH, PATCH] blurred patches at the
    keypoints' orientations (``sift.py:128-173``)."""
    dev = patches.device
    grid, cell_w, gauss = (
        torch.from_numpy(a).to(dev) for a in _descriptor_geometry((16, 16, float(radius)))
    )
    gxs, gys = grid[:, 0], grid[:, 1]
    c, s = cos[:, None], sin[:, None]
    rx = c * gxs - s * gys                      # the grid rotated, [K, G]
    ry = s * gxs + c * gys
    ex, ey = c * 1.0 - s * 0.0, s * 1.0 + c * 0.0   # rotated unit steps
    fx, fy = c * 0.0 - s * 1.0, s * 0.0 + c * 1.0
    v_px = sample_patches(patches, rx + ex, ry + ey)
    v_mx = sample_patches(patches, rx - ex, ry - ey)
    v_py = sample_patches(patches, rx + fx, ry + fy)
    v_my = sample_patches(patches, rx - fx, ry - fy)
    dx = 0.5 * (v_px - v_mx)
    dy = 0.5 * (v_py - v_my)
    mag = torch.sqrt(dx * dx + dy * dy) * gauss
    ang = torch.atan2(dy, dx)
    # Soft assignment to 8 orientation bins (circular tent).
    binf = (ang + math.pi) / (2 * math.pi) * 8.0
    b0 = torch.floor(binf)
    frac = binf - b0
    bins = torch.arange(8, dtype=torch.float32, device=dev)
    w0 = (torch.remainder(b0, 8)[..., None] == bins) * (1 - frac)[..., None]
    w1 = (torch.remainder(b0 + 1, 8)[..., None] == bins) * frac[..., None]
    ori_w = (w0 + w1) * mag[..., None]                          # [K, G, 8]
    d = torch.einsum("gc,kgo->kco", cell_w, ori_w).reshape(patches.shape[0], -1)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    d = torch.clamp(d, max=0.2)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)


@lru_cache(maxsize=1)
def _orientation_window() -> np.ndarray:
    ys = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    return np.exp(-(ys[None, :] ** 2 + ys[:, None] ** 2) / (2 * (HALF_PATCH / 2) ** 2))


def _orientations_hist(patches: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of each patch's dominant gradient orientation: the centre
    of the first largest bin of a Gaussian-weighted 36-bin histogram
    (``sift.py:176-193``), made of 36 masked sums, as in the JAX package."""
    dx = 0.5 * (torch.roll(patches, -1, 2) - torch.roll(patches, 1, 2))
    dy = 0.5 * (torch.roll(patches, -1, 1) - torch.roll(patches, 1, 1))
    g = torch.from_numpy(_orientation_window()).to(patches.device)
    mag = torch.sqrt(dx * dx + dy * dy) * g
    ang = torch.atan2(dy, dx)
    binf = torch.remainder((ang + math.pi) / (2 * math.pi) * 36.0, 36.0).to(torch.int32)
    k = patches.shape[0]
    flat_mag = mag.reshape(k, -1)
    flat_bin = binf.reshape(k, -1)
    hist = torch.stack([torch.where(flat_bin == b, flat_mag, 0.0).sum(dim=1) for b in range(36)], dim=1)
    best = torch.argmax(hist, dim=1).to(torch.float32)
    theta = (best + 0.5) / 36.0 * 2 * math.pi - math.pi
    return torch.cos(theta), torch.sin(theta)


def _octave_quotas(cfg: SiftConfig) -> list[int]:
    """Keypoints per octave: a geometric decay summing to max_keypoints."""
    quotas = []
    frac = cfg.octave_quota_decay
    q = cfg.max_keypoints * (1 - frac) / (1 - frac**cfg.n_octaves)
    for _ in range(cfg.n_octaves):
        quotas.append(max(int(round(q)), 1))
        q *= frac
    quotas[-1] += cfg.max_keypoints - sum(quotas)
    return quotas


def _empty(kq: int, device: torch.device) -> SiftFeatures:
    return SiftFeatures(
        pts=torch.zeros((kq, 2), device=device),
        desc=torch.zeros((kq, 128), device=device),
        score=torch.zeros((kq,), device=device),
        scale=torch.ones((kq,), device=device),
        valid=torch.zeros((kq,), dtype=torch.bool, device=device),
    )


def _octave(base: torch.Tensor, kq: int, scale: float, cfg: SiftConfig, tracer: StageTracer) -> SiftFeatures:
    """The ``kq`` keypoints of one octave image ``base`` (its pixels are
    ``scale`` full-image pixels). ``tracer`` times "sift.detect" (the blurs,
    DoG, extrema, offsets and top-k) and "sift.describe" (patches,
    orientation, descriptors)."""
    with tracer.stage("sift.detect"):
        oh, ow = base.shape
        # 4 blur levels -> 3 DoGs -> the union of their spatial extrema.
        sigmas = [cfg.sigma0 * (2 ** (s / 3)) for s in range(4)]
        blurs = [image_ops.gaussian_blur(base, cfg.blur_ksize, s) for s in sigmas]
        dogs = [blurs[i + 1] - blurs[i] for i in range(3)]
        resp = None
        for dlvl in dogs:
            m, r = _dog_extrema(dlvl, cfg.contrast_threshold, cfg.edge_ratio)
            r = torch.where(m, r, 0.0)
            resp = r if resp is None else torch.maximum(resp, r)
        mask = resp > 0
        # 2D subpixel offsets from a quadratic fit of the middle DoG: -H^-1 g.
        dmid = dogs[1]
        gx_d = 0.5 * (_roll(dmid, 0, -1) - _roll(dmid, 0, 1))
        gy_d = 0.5 * (_roll(dmid, -1, 0) - _roll(dmid, 1, 0))
        dxx, dyy, dxy = _hessian(dmid)
        det = dxx * dyy - dxy * dxy
        det = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
        off_x = torch.clamp(-(dyy * gx_d - dxy * gy_d) / det, -0.6, 0.6)
        off_y = torch.clamp(-(dxx * gy_d - dxy * gx_d) / det, -0.6, 0.6)
        ys_i = torch.arange(oh, device=base.device)[:, None]
        xs_i = torch.arange(ow, device=base.device)[None, :]
        inb = (
            (ys_i >= cfg.border) & (ys_i < oh - cfg.border)
            & (xs_i >= cfg.border) & (xs_i < ow - cfg.border)
        )
        score_map = torch.where(mask & inb, resp, 0.0)
        top, idx = top_k(score_map.reshape(-1), kq)
        yy = idx // ow
        xx = idx % ow
        valid = top > 0.0
    with tracer.stage("sift.describe"):
        patches = extract_patches(blurs[1], yy, xx)
        cos, sin = _orientations_hist(patches)
        desc = _descriptors_from_patches(patches, cos, sin, cfg.descriptor_radius)
        desc = torch.where(valid[:, None], desc, 0.0)
        ox = off_x.reshape(-1)[idx]
        oy = off_y.reshape(-1)[idx]
        pts = torch.stack([xx.to(torch.float32) + ox, yy.to(torch.float32) + oy], -1) * scale
        return SiftFeatures(
            pts=pts, desc=desc, score=top,
            scale=torch.full((kq,), scale, dtype=torch.float32, device=base.device), valid=valid,
        )


def extract_sift(img: torch.Tensor, cfg: SiftConfig, tracer: StageTracer = DISABLED) -> SiftFeatures:
    """SIFT-family features of a [H, W] float32 grayscale image: each
    octave's quota of keypoints, octave 0 first; an octave too small for
    the border and the patch gives invalid slots. ``tracer`` times each
    octave's stages (``_octave``); the halving between octaves is in
    neither."""
    per_octave = []
    base = img.to(torch.float32)
    scale = 1.0
    min_dim = max(2 * cfg.border + 8, PATCH + 2)
    for kq in _octave_quotas(cfg):
        oh, ow = base.shape
        if oh < min_dim or ow < min_dim:
            per_octave.append(_empty(kq, img.device))
            continue
        per_octave.append(_octave(base, kq, scale, cfg, tracer))
        base = image_ops.resize(base, (max(oh // 2, 1), max(ow // 2, 1)))
        scale *= 2.0
    return SiftFeatures(*(torch.cat(field) for field in zip(*per_octave)))
