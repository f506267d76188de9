"""Batched RANSAC for 8-DoF homographies, the SIFT engine's verification.

Port of ``slideo_tpu/ops/homography.py``: every minimal (4-point)
hypothesis is drawn up front and solved as a batched 8x8 linear system,
inliers are voted in chunks of ``_HYP_CHUNK`` hypotheses, and the best is
refined by weighted least squares over its inliers. Coordinates are scaled
by 1/NORM for f32 conditioning; the transform comes back in pixels. The
uniform draws ``u`` [C, H, 4] are an input, as in ``ransac.py``: the engine
draws its own (``ransac.uniform_draws``) and parity tests hand in JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig

__all__ = ["Homography", "HomographyRansacResult", "apply_homography", "ransac_homography"]

_HYP_CHUNK = 250  # the JAX scan's chunk: only the first n_chunks*250 draws score
NORM = 1024.0     # coordinate pre-scale for f32 conditioning


class Homography(NamedTuple):
    """h = [h0..h7], h8 = 1: u = (h0 x + h1 y + h2) / (h6 x + h7 y + 1)."""

    h: torch.Tensor  # [..., 8]


class HomographyRansacResult(NamedTuple):
    transform: Homography      # h in pixel coordinates, [C, 8]
    inliers: torch.Tensor      # [C, M] bool
    rating: torch.Tensor       # [C] float32 inlier count
    ok: torch.Tensor           # [C] bool — a model was found


def apply_homography(t: Homography, pts: torch.Tensor) -> torch.Tensor:
    """Map [..., 2] points; ``t.h`` [..., 8] broadcasts against pts[..., 0].
    A denominator within 1e-8 of 0 becomes +1e-8."""
    x, y = pts[..., 0], pts[..., 1]
    h = t.h
    w = h[..., 6] * x + h[..., 7] * y + 1.0
    w = torch.where(torch.abs(w) > 1e-8, w, 1e-8)
    u = (h[..., 0] * x + h[..., 1] * y + h[..., 2]) / w
    v = (h[..., 3] * x + h[..., 4] * y + h[..., 5]) / w
    return torch.stack([u, v], dim=-1)


def _dlt_rows(p: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DLT equations A h = b [..., 2M, 8], [..., 2M] of the correspondences
    p [..., M, 2] -> q [..., M, 2], with h8 = 1."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    row_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    return torch.cat([row_u, row_v], dim=-2), torch.cat([u, v], dim=-1)


def _solve_h(
    a: torch.Tensor, b: torch.Tensor, w: torch.Tensor | None = None
) -> tuple[Homography, torch.Tensor]:
    """Least-squares h of A h = b by ridge-stabilised normal equations;
    ``ok`` is False (and h zero) where the solve gave a non-finite value.
    ``solve_ex`` neither raises on a singular member nor syncs the card."""
    if w is not None:
        a = a * w[..., None]
        b = b * w
    ata = torch.einsum("...mi,...mj->...ij", a, a)
    atb = torch.einsum("...mi,...m->...i", a, b)
    ata = ata + 1e-6 * torch.eye(8, dtype=ata.dtype, device=ata.device)
    h = torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]
    ok = torch.isfinite(h).all(dim=-1)
    return Homography(torch.where(ok[..., None], h, 0.0)), ok


def _inliers(
    t: Homography, src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
    thresh: float, tol: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inlier mask [..., M]; ``tol`` [..., M] scales the threshold per
    match (localisation error grows with the detection octave)."""
    proj = apply_homography(Homography(t.h[..., None, :]), src)
    err2 = torch.sum((proj - dst) ** 2, dim=-1)
    t2 = thresh * thresh if tol is None else (thresh * tol) ** 2
    return (err2 < t2) & valid


def _denormalize(h_n: torch.Tensor) -> torch.Tensor:
    """h in NORM-scaled coordinates -> pixels: H_px = T^-1 H_n T with
    T = diag(1/N, 1/N, 1), so the translation scales by N and the
    perspective row by 1/N."""
    return torch.stack(
        [
            h_n[..., 0], h_n[..., 1], h_n[..., 2] * NORM,
            h_n[..., 3], h_n[..., 4], h_n[..., 5] * NORM,
            h_n[..., 6] / NORM, h_n[..., 7] / NORM,
        ],
        dim=-1,
    )


def ransac_homography(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    u: torch.Tensor,
    cfg: MatchConfig,
    tol: torch.Tensor | None = None,
) -> HomographyRansacResult:
    """RANSAC homography fits for C candidates at once.

    src, dst [C, M, 2] (slide -> frame) with the valid entries compacted to
    the front; u [C, H, 4] uniform draws in [0, 1) picking each hypothesis'
    four points; tol [C, M] optional per-match threshold multipliers.
    """
    c = src.shape[0]
    n_hyp = u.shape[1]
    src_n = src / NORM
    dst_n = dst / NORM
    thresh_n = cfg.ransac_threshold / NORM
    n_valid = valid.sum(dim=-1).to(torch.int32)
    idx = torch.minimum(
        (u * n_valid[:, None, None]).to(torch.int32),
        torch.clamp(n_valid - 1, min=0)[:, None, None],
    ).long()                                                        # [C, H, 4]
    distinct = torch.ones_like(idx[..., 0], dtype=torch.bool)
    for i in range(4):
        for j in range(i + 1, 4):
            distinct &= idx[..., i] != idx[..., j]
    enough = (n_valid >= 4)[:, None]
    flat = idx.reshape(c, -1, 1).expand(-1, -1, 2)
    p = torch.gather(src_n, 1, flat).reshape(c, n_hyp, 4, 2)
    q = torch.gather(dst_n, 1, flat).reshape(c, n_hyp, 4, 2)
    hyp, hyp_ok = _solve_h(*_dlt_rows(p, q))                        # [C, H, 8], [C, H]
    hyp_ok = hyp_ok & distinct & enough

    # The JAX scan scores hypotheses in chunks of _HYP_CHUNK and keeps the
    # first best; only the first max(H // 250, 1) * 250 draws take part.
    used = min(max(n_hyp // _HYP_CHUNK, 1) * _HYP_CHUNK, n_hyp)
    best_n = torch.full((c,), -1.0, device=src.device)
    best_h = torch.zeros((c, 8), device=src.device)
    tol_c = None if tol is None else tol[:, None, :]
    for h0 in range(0, used, _HYP_CHUNK):
        h_chunk = hyp.h[:, h0:h0 + _HYP_CHUNK]
        inl = _inliers(
            Homography(h_chunk), src_n[:, None], dst_n[:, None], valid[:, None], thresh_n, tol_c
        )                                                           # [C, h, M]
        counts = torch.where(hyp_ok[:, h0:h0 + _HYP_CHUNK], inl.sum(dim=-1).to(torch.float32), -1.0)
        chunk_n, chunk_best = counts.max(dim=-1)                    # first best
        better = chunk_n > best_n
        chunk_h = torch.gather(h_chunk, 1, chunk_best[:, None, None].expand(-1, 1, 8))[:, 0]
        best_h = torch.where(better[:, None], chunk_h, best_h)
        best_n = torch.maximum(best_n, chunk_n)
    found = best_n >= 4

    a_all, b_all = _dlt_rows(src_n, dst_n)                          # [C, 2M, 8], [C, 2M]
    for _ in range(cfg.ransac_refine_iters):
        inl = _inliers(Homography(best_h), src_n, dst_n, valid, thresh_n, tol)
        w = torch.cat([inl, inl], dim=-1).to(torch.float32)
        t_new, ok = _solve_h(a_all, b_all, w)
        keep = ok & found & (inl.sum(dim=-1) >= 4)
        best_h = torch.where(keep[:, None], t_new.h, best_h)

    inl = _inliers(Homography(best_h), src_n, dst_n, valid, thresh_n, tol) & found[:, None]
    return HomographyRansacResult(
        transform=Homography(_denormalize(best_h)),
        inliers=inl,
        rating=inl.sum(dim=-1).to(torch.float32),
        ok=found,
    )
