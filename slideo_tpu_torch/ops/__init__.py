"""Tensor ops of both engines' match paths; kernels live in the ``cuda_*`` modules."""

from __future__ import annotations

import torch

__all__ = ["top_k"]


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values, descending,
    with ties in ascending index order. ``torch.topk`` fixes no order among
    ties, and integer scores and counts tie constantly, so this is a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
