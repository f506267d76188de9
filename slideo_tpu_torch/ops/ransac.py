"""Batched RANSAC for 4-DoF similarity transforms.

Port of ``slideo_tpu/ops/ransac.py`` (reference image_utils.rs:44-61): all
2-point hypotheses are drawn up front and scored in parallel, the best is
refined with closed-form weighted least squares. The uniform draws ``u``
are an input: JAX's threefry bits cannot be reproduced with a
``torch.Generator``, so the engine draws its own (``uniform_draws``) and
parity tests hand in JAX's.

``ransac_similarity`` (``cuda_ransac.ransac_similarity``) launches the
RANSAC kernel, csrc/ransac.cu, on CUDA tensors and takes the plain version
``ransac_similarity_plain`` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchConfig
from .cuda_ransac import ransac_similarity

__all__ = [
    "Similarity",
    "RansacResult",
    "apply_similarity",
    "n_scored",
    "ransac_similarity",
    "ransac_similarity_plain",
    "score_hypotheses",
    "uniform_draws",
]

_HYP_CHUNK = 500  # the JAX scan's chunk: only the first n_chunks*500 draws score


class Similarity(NamedTuple):
    """x' = a*x - b*y + tx ; y' = b*x + a*y + ty."""

    a: torch.Tensor
    b: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor


class RansacResult(NamedTuple):
    transform: Similarity      # fields [C]
    inliers: torch.Tensor      # [C, M] bool
    rating: torch.Tensor       # [C] float32 inlier count
    ok: torch.Tensor           # [C] bool — a model was found


def apply_similarity(t: Similarity, pts: torch.Tensor) -> torch.Tensor:
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([t.a * x - t.b * y + t.tx, t.b * x + t.a * y + t.ty], dim=-1)


def _fit_two_points(p: torch.Tensor, q: torch.Tensor) -> tuple[Similarity, torch.Tensor]:
    """Closed-form similarity from p[..., 2, 2] -> q[..., 2, 2]."""
    dpx = p[..., 1, 0] - p[..., 0, 0]
    dpy = p[..., 1, 1] - p[..., 0, 1]
    dqx = q[..., 1, 0] - q[..., 0, 0]
    dqy = q[..., 1, 1] - q[..., 0, 1]
    den = dpx * dpx + dpy * dpy
    ok = den > 1e-9
    den = torch.clamp(den, min=1e-9)
    a = (dqx * dpx + dqy * dpy) / den
    b = (dqy * dpx - dqx * dpy) / den
    tx = q[..., 0, 0] - (a * p[..., 0, 0] - b * p[..., 0, 1])
    ty = q[..., 0, 1] - (b * p[..., 0, 0] + a * p[..., 0, 1])
    return Similarity(a, b, tx, ty), ok


def _fit_weighted(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor
) -> tuple[Similarity, torch.Tensor]:
    """Weighted least-squares similarity p[..., M, 2] -> q[..., M, 2]."""
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    pm = (p * w[..., None]).sum(dim=-2) / wsum
    qm = (q * w[..., None]).sum(dim=-2) / wsum
    pc = p - pm[..., None, :]
    qc = q - qm[..., None, :]
    den = (w * (pc[..., 0] ** 2 + pc[..., 1] ** 2)).sum(dim=-1)
    ok = den > 1e-9
    den = torch.clamp(den, min=1e-9)
    a = (w * (qc[..., 0] * pc[..., 0] + qc[..., 1] * pc[..., 1])).sum(dim=-1) / den
    b = (w * (qc[..., 1] * pc[..., 0] - qc[..., 0] * pc[..., 1])).sum(dim=-1) / den
    tx = qm[..., 0] - (a * pm[..., 0] - b * pm[..., 1])
    ty = qm[..., 1] - (b * pm[..., 0] + a * pm[..., 1])
    return Similarity(a, b, tx, ty), ok


def _inliers(
    t: Similarity, src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
    thresh: float,
) -> torch.Tensor:
    """Inlier mask [..., M] for transform fields shaped like src[..., 0, 0]."""
    proj = apply_similarity(Similarity(*(f[..., None] for f in t)), src)
    diff = proj - dst
    err2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    return (err2 < thresh * thresh) & valid


def uniform_draws(
    n_cand: int, cfg: MatchConfig, frame_seed: int, device: torch.device, n_points: int = 2
) -> torch.Tensor:
    """The engine's hypothesis draws u [C, H, n_points] in [0, 1) (2 for a
    similarity, 4 for a homography), from a generator seeded by
    (ransac_seed, frame index): deterministic per frame."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.ransac_seed << 32) ^ (frame_seed & 0xFFFFFFFF))
    return torch.rand(
        (n_cand, cfg.ransac_iters, n_points), generator=gen, device=device,
        dtype=torch.float32,
    )


def n_scored(n_hyp: int) -> int:
    """Hypotheses that take part: the JAX scan scores chunks of
    ``_HYP_CHUNK``, so only the first ``max(H // 500, 1) * 500`` draws, at
    most H."""
    return min(max(n_hyp // _HYP_CHUNK, 1) * _HYP_CHUNK, n_hyp)


def score_hypotheses(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    u: torch.Tensor,
    cfg: MatchConfig,
) -> tuple[torch.Tensor, torch.Tensor, Similarity]:
    """The first best of each candidate's scored hypotheses: its inlier
    count [C] float32 (-1 where no hypothesis passed), its index [C] int64
    (-1 there) and its transform (zeros there)."""
    c = src.shape[0]
    n_hyp = u.shape[1]
    n_valid = valid.sum(dim=-1).to(torch.int32)                     # [C]
    idx = torch.minimum(
        (u * n_valid[:, None, None]).to(torch.int32),
        torch.clamp(n_valid - 1, min=0)[:, None, None],
    ).long()                                                        # [C, H, 2]
    distinct = idx[..., 0] != idx[..., 1]
    enough = (n_valid >= 2)[:, None]
    flat = idx.reshape(c, -1, 1).expand(-1, -1, 2)
    p = torch.gather(src, 1, flat).reshape(c, n_hyp, 2, 2)
    q = torch.gather(dst, 1, flat).reshape(c, n_hyp, 2, 2)
    hyp, hyp_ok = _fit_two_points(p, q)                             # fields [C, H]
    hyp_ok = hyp_ok & distinct & enough

    # In chunks of _HYP_CHUNK, keeping the first best, as the JAX scan does.
    used = n_scored(n_hyp)
    best_n = torch.full((c,), -1.0, device=src.device)
    best_h = torch.full((c,), -1, dtype=torch.int64, device=src.device)
    best_t = Similarity(*(torch.zeros(c, device=src.device) for _ in range(4)))
    for h0 in range(0, used, _HYP_CHUNK):
        h1 = min(h0 + _HYP_CHUNK, used)
        t_chunk = Similarity(*(f[:, h0:h1] for f in hyp))
        inl = _inliers(
            t_chunk, src[:, None], dst[:, None], valid[:, None], cfg.ransac_threshold
        )                                                           # [C, h, M]
        counts = torch.where(
            hyp_ok[:, h0:h1], inl.sum(dim=-1).to(torch.float32), -1.0
        )
        chunk_n = counts.amax(dim=-1)
        chunk_best = counts.argmax(dim=-1)                          # first best
        better = chunk_n > best_n
        best_t = Similarity(*(
            torch.where(better, cf.gather(1, chunk_best[:, None])[:, 0], bf)
            for cf, bf in zip(t_chunk, best_t)
        ))
        best_h = torch.where(better, h0 + chunk_best, best_h)
        best_n = torch.maximum(best_n, chunk_n)
    return best_n, best_h, best_t


def ransac_similarity_plain(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    u: torch.Tensor,
    cfg: MatchConfig,
) -> RansacResult:
    """The plain version of ``ransac_similarity``: RANSAC similarity fits
    for C candidates at once.

    src, dst [C, M, 2] (slide -> frame); valid [C, M] compacted to the front;
    u [C, H, 2] uniform draws in [0, 1) picking each hypothesis' two points.
    """
    best_n, _, best_t = score_hypotheses(src, dst, valid, u, cfg)
    found = best_n >= 2

    for _ in range(cfg.ransac_refine_iters):
        inl = _inliers(best_t, src, dst, valid, cfg.ransac_threshold)
        t_new, ok = _fit_weighted(src, dst, inl.to(torch.float32))
        keep = ok & found
        best_t = Similarity(*(torch.where(keep, nf, of) for nf, of in zip(t_new, best_t)))

    inl = _inliers(best_t, src, dst, valid, cfg.ransac_threshold) & found[:, None]
    return RansacResult(
        transform=best_t, inliers=inl, rating=inl.sum(dim=-1).to(torch.float32), ok=found
    )
