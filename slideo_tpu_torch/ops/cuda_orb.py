"""Kernel K3+K4 (csrc/orb.cu): oriented, blur-folded steered BRIEF.

Replaces both passes of ``slideo_tpu/ops/pallas_orb.py:orb_descriptors_pallas``
(``_kernel_bins`` and ``_kernel_desc_t``). Per keypoint, given in level-local
(y, x) with its level and the [4, L] level table of ``features._level_tables``:

1. the 63x63 patch of the bf16 atlas, its origin clamped inside the
   keypoint's own level (``pallas_orb.py:364-365``; ``level_origins``);
2. the intensity-centroid moments m10, m01 over the r=31 disc, in f32;
3. the 32-sector angle bin by ``_sector32`` (binary subdivision, no atan2);
4. ``vals = rowsum((A_bin @ P) * D_bin)`` with the bin's bf16-rounded
   blur-folded tent tables (``_bin_tables``); bit i = vals[256+i] > vals[i].

The TPU kernel carries a [72, 128] window around the patch for its DMA and
lane alignment; the tables are zero outside the 63x63 patch
(``_patch_tables`` checks it), so here the tables are cut to the patch.
The grouping of keypoints by bin before pass 2 only batched MXU work on the
TPU and has no counterpart.

The kernel reads its tables packed (``_packed_tables``): per bin, the 512
samples in the order of a bank schedule (``_schedule``) computed here from
the tile layout ``TILE`` that ``orb.cu`` keeps in shared memory, so that a
warp's 32 lanes read words in as few banks at once as the samples' starts
allow (``SCHEDULE_WAVEFRONTS``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
``orb_describe_plain`` (origins by ``level_origins``, dense tables, batched
matmul).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _kernels
from .image import _gauss_kernel_1d
from .orb import HALF_PATCH, PATCH, brief_pattern

__all__ = [
    "ANGLE_BINS", "SCHEDULE_WAVEFRONTS", "TILE", "level_origins", "orb_describe",
    "orb_describe_plain", "patch_origins",
]

ANGLE_BINS = 32
WIN_H = 80                       # TPU window rows (table geometry only)
_ROW0 = 4                        # patch top row inside the TPU window
_CENTER_Y = _ROW0 + HALF_PATCH   # 35
_CENTER_X = HALF_PATCH           # 31
_TAPS = 8                        # nonzeros of a table row: 2-tap tent * 7-tap band
_PLAIN_CHUNK = 512               # keypoints per plain-version step (memory bound)

# The kernel's shared-memory tile (orb.cu PITCH, COPY1): bf16 pixel pairs in
# 32-bit words, two copies (column pairs (2w, 2w+1) from word 0, pairs
# (2w+1, 2w+2) from word COPY1), PITCH words a row. A sample starting at
# (a, d) reads from word (d & 1) * COPY1 + a * PITCH + d // 2. ("f32", pitch,
# 0) describes a tile of f32 pixels (word a * pitch + d), for comparing
# layouts.
TILE = ("bf16", 35, 63 * 35 + 16)
# Mean shared-memory wavefronts per warp read of the sample sweep over the 32
# bins of the default tables under ``_schedule`` at ``TILE`` (orb.cu's note
# repeats it; a warp read takes 1 at best, 4.09 in the f32 tile of pitch 64
# with the samples in bit order).
SCHEDULE_WAVEFRONTS = 1.5
_BANKS = 32
_MAX_LEVELS = 32                 # levels the kernel's level table holds (orb.cu MAX_LEVELS)
_GROUPS = 2 * 256 // _BANKS      # warp reads of one sweep: 8 warps x 2 slots


def _band(n: int, ksize: int, sigma: float) -> np.ndarray:
    """[n, n] plain banded Gaussian (no edge reflection)."""
    g = _gauss_kernel_1d(ksize, sigma)
    half = ksize // 2
    b = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-half, half + 1):
            j = i + t
            if 0 <= j < n:
                b[i, j] += g[t + half]
    return b


def _tent(pos: np.ndarray, n: int) -> np.ndarray:
    """[len(pos), n] bilinear tent rows."""
    grid = np.arange(n, dtype=np.float64)
    return np.maximum(0.0, 1.0 - np.abs(pos[:, None] - grid[None, :]))


@lru_cache(maxsize=4)
def _bin_tables(
    n_bits: int, seed: int, blur_ksize: int, blur_sigma: float
) -> tuple[np.ndarray, np.ndarray]:
    """Blur-folded rotated sampling tables per angle bin, in the TPU window
    geometry: (A [BINS, 2*n_bits, 72], D [BINS, 2*n_bits, 128]) float32.
    Rows [0, n_bits) sample pattern point A, rows [n_bits, 2*n_bits) point B."""
    pat = brief_pattern(n_bits, seed).astype(np.float64)
    px = np.concatenate([pat[:, 0, 0], pat[:, 1, 0]])
    py = np.concatenate([pat[:, 0, 1], pat[:, 1, 1]])
    rows = WIN_H - 8
    b_rows = _band(rows, blur_ksize, blur_sigma)
    b_cols = _band(128, blur_ksize, blur_sigma)
    a = np.zeros((ANGLE_BINS, 2 * n_bits, rows), np.float32)
    d = np.zeros((ANGLE_BINS, 2 * n_bits, 128), np.float32)
    for bi in range(ANGLE_BINS):
        th = (bi + 0.5) * 2.0 * np.pi / ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        sx = c * px - s * py + _CENTER_X
        sy = s * px + c * py + _CENTER_Y
        a[bi] = _tent(sy, rows) @ b_rows
        d[bi] = _tent(sx, 128) @ b_cols
    return a, d


@lru_cache(maxsize=2)
def _moment_masks() -> tuple[np.ndarray, np.ndarray]:
    """[72, 128] x / y moment masks over the orientation disc (TPU window)."""
    ys = np.arange(WIN_H - 8, dtype=np.float32)[:, None] - _CENTER_Y
    xs = np.arange(128, dtype=np.float32)[None, :] - _CENTER_X
    disc = (ys * ys + xs * xs <= HALF_PATCH * HALF_PATCH).astype(np.float32)
    return (disc * xs).astype(np.float32), (disc * ys).astype(np.float32)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even to bfloat16, returned as float32 (the tables
    are bf16 on the TPU: that rounding is part of the contract)."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@lru_cache(maxsize=4)
def _patch_tables(n_bits: int, seed: int, blur_ksize: int, blur_sigma: float):
    """The bf16-rounded tables cut to the 63x63 patch, dense and compact.

    Returns (a [BINS, 2n, 63], d [BINS, 2n, 63], a_start [BINS, 2n] int32,
    a_w [BINS, 2n, 8], d_start, d_w): row r of a table equals a_w[r] placed
    at columns a_start[r] .. a_start[r] + 7. Raises if a table reaches
    outside the patch or a row spans more than 8 columns.
    """
    a_win, d_win = _bin_tables(n_bits, seed, blur_ksize, blur_sigma)
    a_win, d_win = _bf16_round(a_win), _bf16_round(d_win)
    outside_a = np.abs(a_win[..., :_ROW0]).max(initial=0.0) + np.abs(
        a_win[..., _ROW0 + PATCH:]
    ).max(initial=0.0)
    outside_d = np.abs(d_win[..., PATCH:]).max(initial=0.0)
    if outside_a > 0 or outside_d > 0:
        raise ValueError("describe tables reach outside the 63x63 patch")
    a = np.ascontiguousarray(a_win[..., _ROW0:_ROW0 + PATCH])
    d = np.ascontiguousarray(d_win[..., :PATCH])

    def compact(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        nz = t != 0
        first = np.argmax(nz, axis=-1)
        last = PATCH - 1 - np.argmax(nz[..., ::-1], axis=-1)
        if (last - first >= _TAPS).any():
            raise ValueError("a describe table row spans more than 8 columns")
        start = np.minimum(first, PATCH - _TAPS).astype(np.int32)
        cols = start[..., None] + np.arange(_TAPS)
        w = np.take_along_axis(t, cols, axis=-1).astype(np.float32)
        return start, np.ascontiguousarray(w)

    a_start, a_w = compact(a)
    d_start, d_w = compact(d)
    return a, d, a_start, a_w, d_start, d_w


@lru_cache(maxsize=8)
def _dense_tables(key: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    a, d, *_ = _patch_tables(*key)
    return torch.from_numpy(a).to(device), torch.from_numpy(d).to(device)


def _tile_words(tile: tuple, a_start: np.ndarray, d_start: np.ndarray) -> np.ndarray:
    """Shared-memory word of each sample's first tap in the tile ``tile``."""
    kind, pitch, copy1 = tile
    if kind == "f32":
        return a_start * pitch + d_start
    return (d_start & 1) * copy1 + a_start * pitch + d_start // 2


def _schedule(words: np.ndarray) -> np.ndarray:
    """Order of one bin's 512 samples over the sweep's 16 warp reads (read
    g takes positions [32 g, 32 g + 32)). A read takes as many wavefronts
    as the most samples whose first word shares a bank, so with c_r
    samples in bank r, n reads can take one of every bank (n <= min c_r)
    and the rest share the remainder evenly. Returns the sample indices in
    position order for the n of least total."""
    res = words % _BANKS
    c = np.bincount(res, minlength=_BANKS)

    def cost(n: int) -> int:
        rest = _GROUPS - n
        return n + (rest * -(-int((c - n).max()) // rest) if rest else 0)

    n1 = min(range(min(int(c.min()), _GROUPS) + 1), key=cost)
    by_bank = [list(np.flatnonzero(res == b)) for b in range(_BANKS)]
    groups = [[by_bank[b].pop(0) for b in range(_BANKS)] for _ in range(n1)]
    left = np.array([s for b in range(_BANKS) for s in by_bank[b]], np.int64)
    groups += [list(left[g::_GROUPS - n1]) for g in range(_GROUPS - n1)]
    return np.concatenate(groups).astype(np.int64)


@lru_cache(maxsize=8)
def _packed_tables(n_bits: int, seed: int, blur_ksize: int, blur_sigma: float, tile: tuple):
    """The kernel's tables: (heads [BINS, 512] int32, weights [BINS, 512, 16]
    int16). Position p of bin b holds the sample ``heads >> 12`` with
    ``a_start | d_start << 6`` in the low 12 bits and its bf16 weights (the
    8 of A, then the 8 of D, as bit patterns: lossless, the weights are
    bf16-rounded), the samples in ``_schedule`` order for ``tile``."""
    _, _, a_start, a_w, d_start, d_w = _patch_tables(n_bits, seed, blur_ksize, blur_sigma)
    bits = lambda w: (w.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)  # noqa: E731
    heads = np.zeros(a_start.shape, np.int32)
    weights = np.zeros((*a_start.shape, 2 * _TAPS), np.int16)
    for b in range(ANGLE_BINS):
        order = _schedule(_tile_words(tile, a_start[b], d_start[b]))
        heads[b] = a_start[b][order] | d_start[b][order] << 6 | order.astype(np.int32) << 12
        weights[b] = np.concatenate([bits(a_w[b][order]), bits(d_w[b][order])], axis=-1)
    return heads, weights


@lru_cache(maxsize=8)
def _kernel_tables(key: tuple, tile: tuple, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device) for t in _packed_tables(*key, tile))


def _sector32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angle bin of atan2(y, x) in 32 sectors by binary subdivision: the
    same f32 constants, operation order and strict comparisons as
    ``pallas_orb._sector32``."""
    neg_y = y < 0
    b = torch.where(neg_y, 16, 0)
    x, y = torch.where(neg_y, -x, x), torch.where(neg_y, -y, y)
    neg_x = x < 0
    b = b + torch.where(neg_x, 8, 0)
    x, y = torch.where(neg_x, y, x), torch.where(neg_x, -x, y)
    c = y > x
    b = b + torch.where(c, 4, 0)
    isq2 = float(np.float32(1.0 / np.sqrt(2.0)))
    x, y = (
        torch.where(c, (x + y) * isq2, x),
        torch.where(c, (y - x) * isq2, y),
    )
    c8, s8 = float(np.float32(np.cos(np.pi / 8))), float(np.float32(np.sin(np.pi / 8)))
    c = y > x * float(np.float32(np.tan(np.pi / 8)))
    b = b + torch.where(c, 2, 0)
    x, y = (
        torch.where(c, x * c8 + y * s8, x),
        torch.where(c, y * c8 - x * s8, y),
    )
    c = y > x * float(np.float32(np.tan(np.pi / 16)))
    b = b + torch.where(c, 1, 0)
    return b.to(torch.int32)


def patch_origins(ys, xs, y_lo, y_hi, x_lo, x_hi) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left (y0, x0) of each keypoint's patch, clamped inside its level:
    ``clip(c - 31, lo, max(hi - 63, lo))`` (padded slots clamp harmlessly)."""
    y0 = torch.minimum(torch.maximum(ys - HALF_PATCH, y_lo), torch.maximum(y_hi - PATCH, y_lo))
    x0 = torch.minimum(torch.maximum(xs - HALF_PATCH, x_lo), torch.maximum(x_hi - PATCH, x_lo))
    return y0.to(torch.int32).contiguous(), x0.to(torch.int32).contiguous()


def level_origins(
    y: torch.Tensor, x: torch.Tensor, level: torch.Tensor, level_table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``patch_origins`` of keypoints at level-local (y, x) of ``level``, with
    the level bounds from the [4, L] level table (rows: row offset, column
    offset, height, width): the clamp the kernel applies itself."""
    lvl = level.long()
    y_lo, x_lo = level_table[0][lvl], level_table[1][lvl]
    return patch_origins(
        y + y_lo, x + x_lo, y_lo, y_lo + level_table[2][lvl], x_lo, x_lo + level_table[3][lvl]
    )


def _gather_patches(atlas: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """[K, 63, 63] float32 patches; pixels beyond the atlas read 0."""
    ha, wa = atlas.shape
    ar = torch.arange(PATCH, device=atlas.device)
    rows = y0.long()[:, None] + ar                       # [K, 63]
    cols = x0.long()[:, None] + ar
    inb = (rows < ha)[:, :, None] & (cols < wa)[:, None, :]
    vals = atlas[rows.clamp(max=ha - 1)[:, :, None], cols.clamp(max=wa - 1)[:, None, :]]
    return torch.where(inb, vals.to(torch.float32), 0.0)


def orb_describe_plain(
    atlas: torch.Tensor, y: torch.Tensor, x: torch.Tensor, level: torch.Tensor,
    level_table: torch.Tensor, n_bits: int = 256, seed: int = 0x51DE0, blur_ksize: int = 7,
    blur_sigma: float = 2.0, return_values: bool = False,
):
    """Plain PyTorch describe of keypoints at level-local (y, x) of
    ``level`` (see ``orb_describe``).

    Returns (desc [K, n_bits] int8 in {-1, +1}, bins [K] int32) and, with
    ``return_values``, the sample values [K, 2*n_bits] float32.
    """
    y0, x0 = level_origins(y, x, level, level_table)
    a, d = _dense_tables((n_bits, seed, blur_ksize, float(blur_sigma)), atlas.device)
    mx, my = _moment_masks()
    mx = torch.from_numpy(mx[_ROW0:_ROW0 + PATCH, :PATCH].copy()).to(atlas.device)
    my = torch.from_numpy(my[_ROW0:_ROW0 + PATCH, :PATCH].copy()).to(atlas.device)
    bins_out, vals_out = [], []
    for k0 in range(0, y0.shape[0], _PLAIN_CHUNK):
        p = _gather_patches(atlas, y0[k0:k0 + _PLAIN_CHUNK], x0[k0:k0 + _PLAIN_CHUNK])
        m10 = (p * mx).sum(dim=(1, 2))
        m01 = (p * my).sum(dim=(1, 2))
        bins = _sector32(m10, m01)
        rows = torch.bmm(a[bins.long()], p)               # [k, 2n, 63]
        vals_out.append((rows * d[bins.long()]).sum(dim=-1))
        bins_out.append(bins)
    vals = torch.cat(vals_out) if vals_out else atlas.new_zeros((0, 2 * n_bits), dtype=torch.float32)
    bins = torch.cat(bins_out) if bins_out else torch.zeros(0, dtype=torch.int32, device=atlas.device)
    desc = torch.where(vals[:, n_bits:] > vals[:, :n_bits], 1, -1).to(torch.int8)
    if return_values:
        return desc, bins, vals
    return desc, bins


def orb_describe(
    atlas: torch.Tensor, y: torch.Tensor, x: torch.Tensor, level: torch.Tensor,
    level_table: torch.Tensor, n_bits: int = 256, seed: int = 0x51DE0, blur_ksize: int = 7,
    blur_sigma: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Descriptors and angle bins of keypoints at level-local (y, x) of
    ``level`` (int32 [K] each) on a [Ha, W] atlas whose [4, L] int32 level
    table (``features._level_tables``) gives each level's row offset, column
    offset, height and width: kernel K3+K4 for a CUDA atlas (it forms the
    patch origins itself), the plain version for a CPU one. Returns (desc
    [K, n_bits] int8, bins [K] int32)."""
    if _kernels.plain_or_raise(atlas):
        return orb_describe_plain(atlas, y, x, level, level_table, n_bits, seed, blur_ksize,
                                  blur_sigma)
    if n_bits != 256:
        raise ValueError(f"the describe kernel computes 256 bits, not {n_bits}")
    _kernels.require_cuda(atlas, "orb_describe atlas", torch.bfloat16, 2)
    for name, t in (("y", y), ("x", x), ("level", level)):
        _kernels.require_cuda(t, f"orb_describe {name}", torch.int32, 1)
    _kernels.require_cuda(level_table, "orb_describe level_table", torch.int32, 2)
    k = y.shape[0]
    if x.shape != (k,) or level.shape != (k,):
        raise ValueError(f"y {tuple(y.shape)}, x {tuple(x.shape)} and level "
                         f"{tuple(level.shape)} differ")
    if level_table.shape[0] != 4 or not 1 <= level_table.shape[1] <= _MAX_LEVELS:
        raise ValueError(f"level_table: expected [4, L] with 1 <= L <= {_MAX_LEVELS}, got "
                         f"{tuple(level_table.shape)}")
    heads, weights = _kernel_tables(
        (n_bits, seed, blur_ksize, float(blur_sigma)), TILE, atlas.device
    )
    desc = torch.empty((k, n_bits), dtype=torch.int8, device=atlas.device)
    bins = torch.empty((k,), dtype=torch.int32, device=atlas.device)
    if k == 0:
        return desc, bins
    ha, wa = atlas.shape
    if ha * wa >= 1 << 31:
        raise ValueError(f"the describe kernel indexes atlas pixels in 32 bits, not {ha} x {wa}")
    _kernels.launch(
        "orb", "slideo_orb_describe", atlas,
        atlas.data_ptr(), ha, wa, y.data_ptr(), x.data_ptr(), level.data_ptr(),
        level_table.data_ptr(), level_table.shape[1], k, heads.data_ptr(), weights.data_ptr(),
        bins.data_ptr(), desc.data_ptr(),
    )
    return desc, bins
