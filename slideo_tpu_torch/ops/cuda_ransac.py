"""Wrapper of the RANSAC kernel (csrc/ransac.cu): similarity fits of C
candidates in one call.

Replaces no TPU kernel: the JAX package leaves ``ransac_similarity`` to
XLA, which fuses it under ``jit``; the port's eager op chain
(``ransac.ransac_similarity_plain``) launched ~580 small kernels a frame.
A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
Both score the same draws ``u``, keep the same first best and run the same
refinements in float32; the kernel's sums differ from torch's reductions
in rounding only.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["ransac_similarity", "ransac_with_winner"]

# csrc/ransac.cu's limits: a candidate's points staged in shared memory, the
# packed key's 16 bits of hypothesis index, hypotheses a block of pass 1 scores.
MAX_POINTS = 2048
MAX_HYPOTHESES = 0xFFFF
HYP_PER_BLOCK = 32


def ransac_similarity(src, dst, valid, u, cfg):
    """RANSAC similarity fits for C candidates at once.

    src, dst [C, M, 2] float32 (slide -> frame); valid [C, M] bool,
    compacted to the front; u [C, H, 2] float32 uniform draws in [0, 1)
    picking each hypothesis' two points. Returns a ``ransac.RansacResult``.
    """
    if _kernels.plain_or_raise(src):
        from .ransac import ransac_similarity_plain

        return ransac_similarity_plain(src, dst, valid, u, cfg)
    return ransac_with_winner(src, dst, valid, u, cfg)[0]


def ransac_with_winner(src, dst, valid, u, cfg):
    """The kernel's ``RansacResult`` and the winning hypothesis of each
    candidate ([C] int32, -1 where no hypothesis passed), CUDA tensors only."""
    from .ransac import RansacResult, Similarity, n_scored

    src, dst, valid, u = (t.contiguous() for t in (src, dst, valid, u))
    _kernels.require_cuda(src, "ransac src", torch.float32, 3)
    _kernels.require_cuda(dst, "ransac dst", torch.float32, 3)
    _kernels.require_cuda(valid, "ransac valid", torch.bool, 2)
    _kernels.require_cuda(u, "ransac u", torch.float32, 3)
    c, m = valid.shape
    n_hyp = u.shape[1]
    if src.shape != (c, m, 2) or dst.shape != (c, m, 2) or u.shape != (c, n_hyp, 2):
        raise ValueError(
            f"ransac: src {tuple(src.shape)}, dst {tuple(dst.shape)}, valid {(c, m)}, "
            f"u {tuple(u.shape)} are not [C, M, 2], [C, M, 2], [C, M], [C, H, 2]"
        )
    used = n_scored(n_hyp)
    if not 1 <= m <= MAX_POINTS or used > MAX_HYPOTHESES:
        raise ValueError(
            f"ransac: M = {m} outside 1..{MAX_POINTS} or {used} scored hypotheses above "
            f"{MAX_HYPOTHESES}"
        )
    n_blocks = -(-used // HYP_PER_BLOCK)
    dev = src.device
    # One int32 buffer for the transform fields and rating ([5, C], as
    # f32), the winners and the per-block keys; one bool buffer for the
    # inliers and ok.
    words = torch.empty(6 * c + c * n_blocks, dtype=torch.int32, device=dev)
    flags = torch.empty(c * m + c, dtype=torch.bool, device=dev)
    fields = words[:5 * c].view(torch.float32).view(5, c)
    winner = words[5 * c:6 * c]
    inliers = flags[:c * m].view(c, m)
    ok = flags[c * m:]
    if c > 0:
        _kernels.launch(
            "ransac", "slideo_ransac", src,
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), u.data_ptr(), c, m, n_hyp, used,
            float(cfg.ransac_threshold) ** 2, cfg.ransac_refine_iters,
            words[6 * c:].data_ptr(), fields.data_ptr(), inliers.data_ptr(), ok.data_ptr(),
            winner.data_ptr(),
        )
    a, b, tx, ty, rating = fields
    return RansacResult(transform=Similarity(a, b, tx, ty), inliers=inliers, rating=rating,
                        ok=ok), winner
