"""Steered-BRIEF geometry shared by slides and frames.

Port of ``slideo_tpu/ops/orb.py:37-57``: the patch geometry and the seeded
point pattern, in numpy with the same ``RandomState`` so both packages
sample identical point pairs. The describe itself is kernel K3+K4
(``cuda_orb``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["HALF_PATCH", "DESC_RADIUS", "PATCH", "brief_pattern"]

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
