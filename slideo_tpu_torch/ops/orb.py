"""Steered-BRIEF geometry shared by slides and frames, and patch sampling.

Port of ``slideo_tpu/ops/orb.py:37-57``: the patch geometry and the seeded
point pattern, in numpy with the same ``RandomState`` so both packages
sample identical point pairs. The describe itself is kernel K3+K4
(``cuda_orb``). The SIFT engine's patch tools (``orb.py:64-97``,
``:117-145``) follow: ``extract_patches`` as an index gather of the
[K, 63, 63] windows, ``sample_patches`` as a gather of each point's four
taps.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "HALF_PATCH", "DESC_RADIUS", "PATCH", "brief_pattern", "extract_patches",
    "sample_patches",
]

# Orientation uses the disc of radius HALF_PATCH; BRIEF points live within
# DESC_RADIUS, so after any rotation they stay inside the patch.
HALF_PATCH = 31          # reference patch_size=62 -> radius 31
DESC_RADIUS = 15
PATCH = 2 * HALF_PATCH + 1


@lru_cache(maxsize=4)
def brief_pattern(n_bits: int = 256, seed: int = 0x51DE0) -> np.ndarray:
    """Deterministic BRIEF pattern [n_bits, 2 points, 2 coords (x, y)]:
    iid Gaussian(0, (2*DESC_RADIUS/5)^2) points clipped to the DESC_RADIUS
    disc (the BRIEF paper's G-II geometry)."""
    rng = np.random.RandomState(seed)
    sigma = 2.0 * DESC_RADIUS / 5.0
    pts = rng.randn(n_bits, 2, 2) * sigma
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, DESC_RADIUS / np.maximum(norm, 1e-6))
    return (pts * scale).astype(np.float32)


def extract_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[K, PATCH, PATCH] windows of the [H, W] image centred at integer
    (ys, xs) [K]; a window that would cross an edge is shifted inside it
    (``jax.lax.dynamic_slice``'s clamp), so padded slots read harmlessly."""
    h, w = img.shape
    y0 = torch.clamp(ys.long() - HALF_PATCH, 0, max(h - PATCH, 0))
    x0 = torch.clamp(xs.long() - HALF_PATCH, 0, max(w - PATCH, 0))
    offs = torch.arange(PATCH, device=img.device)
    rows = (y0[:, None] + offs)[:, :, None]
    cols = (x0[:, None] + offs)[:, None, :]
    return img[rows, cols]


def sample_patches(patches: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of each [P, P] patch of ``patches`` [K, P, P] at its
    own patch-centred points xs, ys [K, N] -> [K, N], points outside the
    patch clamped to its edge.

    The JAX package densifies the taps into tent matrices and contracts,
    rowsum((Ry @ patch) * Cx), because gathers are slow on a TPU; here the
    four taps are gathered. The tent weights max(0, 1 - |c - j|) of the two
    taps are formed as the tent forms them, so only the order of the two
    multiply-adds of a row can round apart.
    """
    k, size = patches.shape[0], patches.shape[-1]
    x = torch.clamp(xs + HALF_PATCH, 0.0, size - 1.0)
    y = torch.clamp(ys + HALF_PATCH, 0.0, size - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx0, wy0 = 1.0 - (x - x0), 1.0 - (y - y0)
    wx1, wy1 = 1.0 - ((x0 + 1.0) - x), 1.0 - ((y0 + 1.0) - y)
    # At the last row (column) the second tap's weight is exactly 0.
    ix0, iy0 = x0.long(), y0.long()
    ix1, iy1 = torch.clamp(ix0 + 1, max=size - 1), torch.clamp(iy0 + 1, max=size - 1)
    flat = patches.reshape(k, size * size)
    tap = lambda iy, ix: torch.gather(flat, 1, iy * size + ix)  # noqa: E731
    r0 = wy0 * tap(iy0, ix0) + wy1 * tap(iy1, ix0)
    r1 = wy0 * tap(iy0, ix1) + wy1 * tap(iy1, ix1)
    return r0 * wx0 + r1 * wx1
