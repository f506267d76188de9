"""The plain reference of the ORB engine: frame -> page in plain PyTorch.

It answers, from the same pages and frames the benchmark hands the
program, what ``MatchingEngine`` must answer for a sampled frame: whether
the dedup passes it on, and if so which slide it shows (or none), with the
winner's similarity and RANSAC rating. It follows the reference project
(hediet/slideo, crates/matching-opencv: ORB features, a 5% ratio filter,
top-40 slides by match count, RANSAC, top-10 by inliers, a warped-image
similarity above 0.5) as the port's plain versions compute it, and the JAX
package before them; tier-1's CPU tests hold those plain versions to the
JAX package. It imports nothing of the port, of the JAX package or of JAX,
takes nothing the program made (no index, no table, no draws), and runs
only the batched screening rule (``screen_bits`` 128, no pre-vote), the one
the benchmark's configurations state.

Its arithmetic is float32 with TF32 off and its pyramid atlas bfloat16, as
the configuration states (the engine turns TF32 off for its resizes and
similarities; ``atlas_bf16``). ``control`` gives a control, the same code
one precision step lower: ``"fp8"`` (the benchmark's control) TF32 products
and the atlas in float8 e4m3; ``"int8"`` TF32 products and the atlas
rounded to 8-bit integers; ``"tf32"`` TF32 products alone.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1e6
_NEG = float(-(2**30))
_SCREEN_INVALID = -254.0
_SCREEN_BITS = 128
_HALF, _DESC_R = 31, 15
_PATCH = 2 * _HALF + 1
_BINS = 32
_WIN_H, _ROW0 = 80, 4
_CY, _CX = _ROW0 + _HALF, _HALF
_HYP_CHUNK = 500


def top_k(x: torch.Tensor, k: int):
    """k largest along the last dim, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---- images ------------------------------------------------------------

def small_size(h: int, w: int, area: int) -> tuple[int, int]:
    f = math.sqrt(area / float(h * w))
    return int(h * f), int(w * f)


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, area: bool) -> np.ndarray:
    """[n_out, n_in] area (OpenCV INTER_AREA) or half-pixel bilinear weights."""
    w = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    if area and scale >= 1.0:
        for o in range(n_out):
            lo, hi = o * scale, (o + 1) * scale
            for i in range(int(math.floor(lo)), min(int(math.ceil(hi)), n_in)):
                overlap = min(hi, i + 1) - max(lo, i)
                if overlap > 0:
                    w[o, i] = overlap / scale
    else:
        for o in range(n_out):
            src = (o + 0.5) * scale - 0.5
            i0 = int(math.floor(src))
            frac = src - i0
            w[o, min(max(i0, 0), n_in - 1)] += 1.0 - frac
            w[o, min(max(i0 + 1, 0), n_in - 1)] += frac
    return w


@lru_cache(maxsize=128)
def _on(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a numpy table) as a tensor on ``device``, made once."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def resize(img: torch.Tensor, out_hw, area: bool) -> torch.Tensor:
    wy = _on(_resize_matrix, (img.shape[-2], out_hw[0], area), img.device)
    wx = _on(_resize_matrix, (img.shape[-1], out_hw[1], area), img.device)
    return torch.matmul(wy, torch.matmul(img.to(torch.float32), wx.T))


def thumbnail(img: torch.Tensor, area: int) -> torch.Tensor:
    return resize(img, small_size(img.shape[-2], img.shape[-1], area), area=True)


def similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - ||a - b|| / (255 sqrt(pixels)) over the last two dims."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return 1.0 - torch.sqrt((d * d).sum(dim=(-2, -1))) / math.sqrt(255.0 * 255.0 * a.shape[-2] * a.shape[-1])


# ---- pyramid and FAST ----------------------------------------------------

def _next65(n: int) -> int:
    return 5 * ((n + 5) // 6)


def pyramid_meta(h: int, w: int, n_levels: int):
    """Level sizes and their shelf-packed offsets in one [Ha, w] atlas."""
    sizes = [(h, w)]
    for _ in range(1, n_levels):
        sizes.append((_next65(sizes[-1][0]), _next65(sizes[-1][1])))
    offsets, xoffsets, shelves, row = [0], [0], [], h
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
    return sizes, offsets, xoffsets, (row, w)


@lru_cache(maxsize=64)
def _w65(n_out: int, n_in: int) -> np.ndarray:
    """The exact 6 -> 5 tent matrix, in float32 operation by operation."""
    f = np.float32
    i = np.broadcast_to(np.arange(n_out, dtype=f)[:, None], (n_out, n_in))
    j = np.broadcast_to(np.arange(n_in, dtype=f)[None, :], (n_out, n_in))
    block = np.floor(i / f(5.0))
    frac = f(1.2) * (i - f(5.0) * block) + f(0.1)
    base = np.minimum(f(6.0) * block, f(n_in - 1))
    frac = np.where(f(6.0) * block > f(n_in - 1), f(0.0), frac)
    frac = np.minimum(frac, f(n_in - 1) - base)
    return np.maximum(f(0.0), f(1.0) - np.abs((base - j) + frac)).astype(f)


def pyramid(img: torch.Tensor, n_levels: int, store=torch.bfloat16) -> torch.Tensor:
    """[Ha, W] bfloat16 atlas of the 1.2x pyramid of a [H, W] image; the
    level chain stays float32. ``store`` rounds the stored levels through
    another type first (a control's atlas): ``torch.float8_e4m3fn``, or
    ``torch.uint8`` (integers, which bfloat16 holds exactly up to 256)."""
    h, w = img.shape
    sizes, offs, xoffs, atlas_hw = pyramid_meta(h, w, n_levels)
    atlas = torch.zeros(atlas_hw, dtype=torch.bfloat16, device=img.device)
    prev = img.to(torch.float32)
    for lvl, ((lh, lw), off, xoff) in enumerate(zip(sizes, offs, xoffs)):
        if lvl:
            r = _on(_w65, (_next65(prev.shape[0]), prev.shape[0]), img.device)
            c = _on(_w65, (_next65(prev.shape[1]), prev.shape[1]), img.device)
            prev = torch.matmul(torch.matmul(r, prev), c.T)
        level = prev
        if store == torch.uint8:
            level = torch.round(prev).clamp(0, 255)
        elif store != torch.bfloat16:
            level = prev.to(store).to(torch.float32)
        atlas[off:off + lh, xoff:xoff + lw] = level.to(torch.bfloat16)
    return atlas


_CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
           (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def _arc9(d: torch.Tensor, op) -> torch.Tensor:
    w2 = op(d, torch.roll(d, -1, dims=0))
    w4 = op(w2, torch.roll(w2, -2, dims=0))
    w8 = op(w4, torch.roll(w4, -4, dims=0))
    return op(w8, torch.roll(d, -8, dims=0))


def fast_nms(atlas: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 scores (OpenCV's FAST_SCORE on bf16-rounded differences,
    zero unless above the threshold, zero on the 3 px ring) after a 3 x 3
    non-maximum suppression, [H, W] float32."""
    x = atlas.to(torch.float32)
    h, w = x.shape
    d = torch.stack([(torch.roll(x, (-dy, -dx), dims=(0, 1)) - x).to(torch.bfloat16)
                     for dy, dx in _CIRCLE])
    score = torch.maximum(_arc9(d, torch.minimum).amax(0), -_arc9(d, torch.maximum).amin(0)).to(torch.float32)
    del d
    ys = torch.arange(h, device=x.device)[:, None]
    xs = torch.arange(w, device=x.device)[None, :]
    ring = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    score = torch.where((score > threshold) & ring, score, 0.0)
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)


def level_quotas(orb: dict) -> list[int]:
    inv = 1.0 / orb["scale_factor"]
    n = orb["n_features"]
    desired = n * (1 - inv) / (1 - inv ** orb["n_levels"])
    quotas, left = [], n
    for _ in range(orb["n_levels"] - 1):
        q = min(int(round(desired)), left)
        quotas.append(q)
        left -= q
        desired *= inv
    return quotas + [left]


def detect(score_atlas: torch.Tensor, meta, orb: dict) -> dict:
    """Per-level quota top-k keypoints, padded to max_keypoints slots:
    score, level-local y, x, level, valid."""
    sizes, offs, xoffs, _ = meta
    dev, border = score_atlas.device, orb["edge_threshold"]
    parts = {k: [] for k in ("score", "y", "x", "level")}
    for lvl, ((lh, lw), off, xoff, quota) in enumerate(zip(sizes, offs, xoffs, level_quotas(orb))):
        if quota <= 0:
            continue
        parts["level"].append(torch.full((quota,), lvl, dtype=torch.int32, device=dev))
        if not (lh > 2 * border and lw > 2 * border):
            for k in ("score", "y", "x"):
                parts[k].append(torch.zeros(quota, dtype=torch.float32 if k == "score" else torch.int32,
                                            device=dev))
            continue
        s = torch.zeros((lh, lw), dtype=torch.float32, device=dev)
        s[border:lh - border, border:lw - border] = score_atlas[
            off + border:off + lh - border, xoff + border:xoff + lw - border]
        top, idx = top_k(s.reshape(-1), quota)
        parts["score"].append(top)
        parts["y"].append((idx // lw).to(torch.int32))
        parts["x"].append((idx % lw).to(torch.int32))
    kps = {k: torch.cat(v) for k, v in parts.items()}
    pad = orb["max_keypoints"] - kps["score"].shape[0]
    kps = {k: F.pad(v, (0, pad)) for k, v in kps.items()}
    kps["valid"] = kps["score"] > 0.0
    return kps


# ---- steered BRIEF ---------------------------------------------------------

@lru_cache(maxsize=4)
def _pattern(n_bits: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_bits, 2, 2) * (2.0 * _DESC_R / 5.0)
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    return (pts * np.minimum(1.0, _DESC_R / np.maximum(norm, 1e-6))).astype(np.float32)


def _gauss1d(ksize: int, sigma: float) -> np.ndarray:
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _band(n: int, ksize: int, sigma: float) -> np.ndarray:
    g, half = _gauss1d(ksize, sigma), ksize // 2
    b = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-half, half + 1):
            if 0 <= i + t < n:
                b[i, i + t] += g[t + half]
    return b


def _tent(pos: np.ndarray, n: int) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(pos[:, None] - np.arange(n, dtype=np.float64)[None, :]))


@lru_cache(maxsize=4)
def _tables(n_bits: int, seed: int, ksize: int, sigma: float):
    """Blur-folded sampling tables of each of 32 angle bins, rounded to
    bfloat16 and cut to the 63 x 63 patch: rows A [32, 2n, 63] and columns
    D [32, 2n, 63]; a sample is rowsum((A @ patch) * D)."""
    pat = _pattern(n_bits, seed).astype(np.float64)
    px = np.concatenate([pat[:, 0, 0], pat[:, 1, 0]])
    py = np.concatenate([pat[:, 0, 1], pat[:, 1, 1]])
    rows = _WIN_H - 8
    brows, bcols = _band(rows, ksize, sigma), _band(128, ksize, sigma)
    a = np.zeros((_BINS, 2 * n_bits, rows), np.float32)
    d = np.zeros((_BINS, 2 * n_bits, 128), np.float32)
    for bi in range(_BINS):
        th = (bi + 0.5) * 2.0 * np.pi / _BINS
        c, s = np.cos(th), np.sin(th)
        a[bi] = _tent(s * px + c * py + _CY, rows) @ brows
        d[bi] = _tent(c * px - s * py + _CX, 128) @ bcols
    bf = lambda t: torch.from_numpy(t).to(torch.bfloat16).to(torch.float32).numpy()  # noqa: E731
    a, d = bf(a), bf(d)
    return np.ascontiguousarray(a[..., _ROW0:_ROW0 + _PATCH]), np.ascontiguousarray(d[..., :_PATCH])


def _moments() -> tuple[np.ndarray, np.ndarray]:
    ys = np.arange(_WIN_H - 8, dtype=np.float32)[:, None] - _CY
    xs = np.arange(128, dtype=np.float32)[None, :] - _CX
    disc = (ys * ys + xs * xs <= _HALF * _HALF).astype(np.float32)
    mx, my = (disc * xs).astype(np.float32), (disc * ys).astype(np.float32)
    return mx[_ROW0:_ROW0 + _PATCH, :_PATCH].copy(), my[_ROW0:_ROW0 + _PATCH, :_PATCH].copy()


def _moment_mask(i: int) -> np.ndarray:
    return _moments()[i]


def _table(i: int, *key) -> np.ndarray:
    return _tables(*key)[i]


def _sector32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angle bin of atan2(y, x) in 32 sectors by binary subdivision."""
    f = lambda v: float(np.float32(v))  # noqa: E731
    neg = y < 0
    b = torch.where(neg, 16, 0)
    x, y = torch.where(neg, -x, x), torch.where(neg, -y, y)
    neg = x < 0
    b = b + torch.where(neg, 8, 0)
    x, y = torch.where(neg, y, x), torch.where(neg, -x, y)
    c = y > x
    b = b + torch.where(c, 4, 0)
    r = f(1.0 / np.sqrt(2.0))
    x, y = torch.where(c, (x + y) * r, x), torch.where(c, (y - x) * r, y)
    c8, s8 = f(np.cos(np.pi / 8)), f(np.sin(np.pi / 8))
    c = y > x * f(np.tan(np.pi / 8))
    b = b + torch.where(c, 2, 0)
    x, y = torch.where(c, x * c8 + y * s8, x), torch.where(c, y * c8 - x * s8, y)
    c = y > x * f(np.tan(np.pi / 16))
    return (b + torch.where(c, 1, 0)).to(torch.int32)


def describe(atlas: torch.Tensor, kps: dict, meta, orb: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(desc [K, n_bits] int8 +-1 (0 on invalid slots), pts [K, 2] level-0
    (x, y)) of the keypoints: the 63 x 63 patch clamped inside the
    keypoint's level, its intensity-centroid angle bin, the bin's samples."""
    sizes, offs, xoffs, _ = meta
    dev = atlas.device
    lvl = kps["level"].long()
    y_lo = torch.tensor(offs, device=dev)[lvl]
    x_lo = torch.tensor(xoffs, device=dev)[lvl]
    y_hi = y_lo + torch.tensor([s[0] for s in sizes], device=dev)[lvl]
    x_hi = x_lo + torch.tensor([s[1] for s in sizes], device=dev)[lvl]
    y0 = torch.minimum(torch.maximum(kps["y"] + y_lo - _HALF, y_lo), torch.maximum(y_hi - _PATCH, y_lo))
    x0 = torch.minimum(torch.maximum(kps["x"] + x_lo - _HALF, x_lo), torch.maximum(x_hi - _PATCH, x_lo))
    ha, wa = atlas.shape
    ar = torch.arange(_PATCH, device=dev)
    rows, cols = y0.long()[:, None] + ar, x0.long()[:, None] + ar
    inb = (rows < ha)[:, :, None] & (cols < wa)[:, None, :]
    p = torch.where(inb, atlas[rows.clamp(max=ha - 1)[:, :, None], cols.clamp(max=wa - 1)[:, None, :]]
                    .to(torch.float32), 0.0)
    mx, my = (_on(_moment_mask, (i,), dev) for i in (0, 1))
    bins = _sector32((p * mx).sum(dim=(1, 2)), (p * my).sum(dim=(1, 2))).long()
    n_bits = orb["descriptor_bits"]
    key = (n_bits, orb["pattern_seed"], orb["blur_ksize"], float(orb["blur_sigma"]))
    a, d = (_on(_table, (i, *key), dev) for i in (0, 1))
    vals = torch.cat([(torch.bmm(a[bins[c:c + 512]], p[c:c + 512]) * d[bins[c:c + 512]]).sum(-1)
                      for c in range(0, p.shape[0], 512)])
    desc = torch.where(vals[:, n_bits:] > vals[:, :n_bits], 1, -1)
    desc = torch.where(kps["valid"][:, None], desc, 0).to(torch.int8)
    r = torch.tensor([orb["scale_factor"] ** l for l in range(orb["n_levels"])],
                     dtype=torch.float32, device=dev)[lvl]
    half = (r - 1.0) * 0.5
    pts = torch.stack([kps["x"].to(torch.float32) * r + half, kps["y"].to(torch.float32) * r + half], -1)
    return desc, pts


# ---- the reference ---------------------------------------------------------

class Reference:
    """The ORB engine's answers for one deck, computed plainly."""

    def __init__(self, conf: dict, deck: torch.Tensor, control: str | None = None):
        self.orb, self.match, self.video = conf["orb"], conf["match"], conf["video"]
        if conf["engine"] != "orb":
            raise NotImplementedError("the reference computes the ORB engine only")
        if self.match["screen_prevote"] or self.match["screen_bits"] != _SCREEN_BITS:
            raise NotImplementedError("the reference runs the batched screening rule only")
        if not self.orb["atlas_bf16"]:
            raise NotImplementedError("the reference keeps the atlas in bfloat16")
        self.tf32 = control is not None
        self.atlas_store = {None: torch.bfloat16, "tf32": torch.bfloat16, "int8": torch.uint8,
                            "fp8": torch.float8_e4m3fn}[control]
        self.device = deck.device
        self.slide_hw = tuple(deck.shape[1:])
        with self.precision():
            desc, valid, pts, smalls = [], [], [], []
            for c0 in range(0, deck.shape[0], 32):        # the engine's build chunks
                chunk = deck[c0:c0 + 32]
                for page in chunk:
                    f = self.features(page, slide=True)
                    desc.append(f["desc"])
                    valid.append(f["valid"])
                    pts.append(f["pts"])
                smalls.append(thumbnail(chunk, self.video["small_image_area"]))
            s, k = len(desc), self.orb["max_keypoints"]
            self.valid = torch.stack(valid).reshape(s * k)
            self.desc = torch.where(self.valid[:, None], torch.stack(desc).reshape(s * k, -1), 0).to(torch.int8)
            self.pts = torch.stack(pts)
            self.smalls = torch.cat(smalls)
            self.n_slides, self.k = s, k

    @contextlib.contextmanager
    def precision(self):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def features(self, img: torch.Tensor, slide: bool) -> dict:
        """Keypoints, descriptors at the query bucket (all slots for a
        slide), and for a frame its thumbnail."""
        orb = self.orb
        h, w = img.shape
        meta = pyramid_meta(h, w, orb["n_levels"])
        atlas = pyramid(img.to(torch.float32), orb["n_levels"], self.atlas_store)
        kps = detect(fast_nms(atlas, float(orb["fast_threshold"])), meta, orb)
        count = int(kps["valid"].sum())
        mk = orb["max_keypoints"]
        buckets = sorted({q for q in orb["query_buckets"] if 0 < q < mk}) + [mk]
        q = mk if slide else next(b for b in buckets if b >= count)
        if q < kps["score"].shape[0]:
            _, sel = top_k(torch.where(kps["valid"], kps["score"], -1.0), q)
            kps = {key: v[sel] for key, v in kps.items()}
        desc, pts = describe(atlas, kps, meta, orb)
        out = dict(desc=desc, pts=pts, score=kps["score"], valid=kps["valid"], count=count)
        if not slide:
            out["small"] = thumbnail(atlas[:h, :w].to(torch.float32), self.video["small_image_area"])
        return out

    def _screen(self, f: dict) -> torch.Tensor:
        """The frame's 16 candidate slides by the batched stage-1 rule: its
        256 strongest descriptors' 128-bit prefixes vote for every slide
        within 5% + 1 bit of their best prefix distance."""
        m = self.match
        n = m["screen_queries"]
        key = torch.where(f["valid"], f["score"], -1.0)
        desc = f["desc"]
        if desc.shape[0] < n:
            desc = torch.cat([desc, desc.new_zeros((n - desc.shape[0], desc.shape[1]))])
            key = torch.cat([key, key.new_full((n - key.shape[0],), -1.0)])
        q = desc[top_k(key, n)[1], :_SCREEN_BITS].to(torch.float32)
        d3 = self.desc.reshape(self.n_slides, self.k, -1)[:, :, :_SCREEN_BITS]
        v2 = self.valid.reshape(self.n_slides, self.k)
        best = []
        for c0 in range(0, self.n_slides, 64):
            sc = q @ d3[c0:c0 + 64].reshape(-1, _SCREEN_BITS).to(torch.float32).T
            sc = torch.where(v2[c0:c0 + 64].reshape(1, -1), sc, _SCREEN_INVALID)
            best.append(sc.reshape(n, -1, self.k).amax(-1))
        dist = (_SCREEN_BITS - torch.cat(best, 1)) * 0.5
        keep = dist <= dist.amin(dim=1, keepdim=True) * 1.05 + 1.0
        votes = keep.sum(dim=0).to(torch.float32)
        return top_k(votes, min(m["screen_slides"], self.n_slides))[1]

    def _table(self, f: dict, cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Best Hamming distance [Q, C] and first arg-best slot per (query,
        column slide), and each column's validity."""
        d3 = self.desc.reshape(self.n_slides, self.k, -1)[cols]
        v2 = self.valid.reshape(self.n_slides, self.k)[cols]
        qf = f["desc"].to(torch.float32)
        best, arg = [], []
        for c0 in range(0, cols.shape[0], 8):
            sc = (qf @ d3[c0:c0 + 8].reshape(-1, d3.shape[-1]).to(torch.float32).T).reshape(qf.shape[0], -1, self.k)
            sc = torch.where(v2[None, c0:c0 + 8], sc, _NEG)
            best.append(sc.amax(-1))
            arg.append(sc.argmax(-1))
        best, arg = torch.cat(best, 1), torch.cat(arg, 1)
        return (d3.shape[-1] - best) * 0.5, arg, v2.any(dim=1)

    def _ransac(self, src, dst, valid, u):
        m = self.match
        c, n_hyp = src.shape[0], u.shape[1]
        n_valid = valid.sum(-1).to(torch.int32)
        idx = torch.minimum((u * n_valid[:, None, None]).to(torch.int32),
                            torch.clamp(n_valid - 1, min=0)[:, None, None]).long()
        flat = idx.reshape(c, -1, 1).expand(-1, -1, 2)
        p = torch.gather(src, 1, flat).reshape(c, n_hyp, 2, 2)
        q = torch.gather(dst, 1, flat).reshape(c, n_hyp, 2, 2)
        dpx, dpy = p[..., 1, 0] - p[..., 0, 0], p[..., 1, 1] - p[..., 0, 1]
        dqx, dqy = q[..., 1, 0] - q[..., 0, 0], q[..., 1, 1] - q[..., 0, 1]
        den = dpx * dpx + dpy * dpy
        ok = (den > 1e-9) & (idx[..., 0] != idx[..., 1]) & (n_valid >= 2)[:, None]
        den = torch.clamp(den, min=1e-9)
        a = (dqx * dpx + dqy * dpy) / den
        b = (dqy * dpx - dqx * dpy) / den
        hyp = [a, b, q[..., 0, 0] - (a * p[..., 0, 0] - b * p[..., 0, 1]),
               q[..., 0, 1] - (b * p[..., 0, 0] + a * p[..., 0, 1])]
        thr2 = m["ransac_threshold"] ** 2

        def inliers(t, s_, d_, v_):
            x, y = s_[..., 0], s_[..., 1]
            px = t[0][..., None] * x - t[1][..., None] * y + t[2][..., None]
            py = t[1][..., None] * x + t[0][..., None] * y + t[3][..., None]
            ex, ey = px - d_[..., 0], py - d_[..., 1]
            return ((ex * ex + ey * ey) < thr2) & v_

        used = max(n_hyp // _HYP_CHUNK, 1) * _HYP_CHUNK
        best_n = torch.full((c,), -1.0, device=src.device)
        best_t = [torch.zeros(c, device=src.device) for _ in range(4)]
        for h0 in range(0, min(used, n_hyp), _HYP_CHUNK):
            h1 = min(h0 + _HYP_CHUNK, used, n_hyp)
            tc = [f[:, h0:h1] for f in hyp]
            inl = inliers(tc, src[:, None], dst[:, None], valid[:, None])
            counts = torch.where(ok[:, h0:h1], inl.sum(-1).to(torch.float32), -1.0)
            chunk_n, chunk_best = counts.amax(-1), counts.argmax(-1)
            better = chunk_n > best_n
            best_t = [torch.where(better, cf.gather(1, chunk_best[:, None])[:, 0], bf)
                      for cf, bf in zip(tc, best_t)]
            best_n = torch.maximum(best_n, chunk_n)
        found = best_n >= 2
        for _ in range(m["ransac_refine_iters"]):
            w = inliers(best_t, src, dst, valid).to(torch.float32)
            wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            pm = (src * w[..., None]).sum(-2) / wsum
            qm = (dst * w[..., None]).sum(-2) / wsum
            pc, qc = src - pm[..., None, :], dst - qm[..., None, :]
            den = (w * (pc[..., 0] ** 2 + pc[..., 1] ** 2)).sum(-1)
            ok_w = (den > 1e-9) & found
            den = torch.clamp(den, min=1e-9)
            a = (w * (qc[..., 0] * pc[..., 0] + qc[..., 1] * pc[..., 1])).sum(-1) / den
            b = (w * (qc[..., 1] * pc[..., 0] - qc[..., 0] * pc[..., 1])).sum(-1) / den
            new = [a, b, qm[..., 0] - (a * pm[..., 0] - b * pm[..., 1]),
                   qm[..., 1] - (b * pm[..., 0] + a * pm[..., 1])]
            best_t = [torch.where(ok_w, nf, of) for nf, of in zip(new, best_t)]
        rating = (inliers(best_t, src, dst, valid) & found[:, None]).sum(-1).to(torch.float32)
        return best_t, rating, found

    def _verify(self, f: dict, frame_hw, t, slides: torch.Tensor) -> torch.Tensor:
        """Similarity of each candidate slide's thumbnail (on the stride
        grid) with the frame thumbnail warped by its transform."""
        stride = self.match["verify_stride"]
        hs, ws = self.smalls.shape[-2:]
        fsh, fsw = small_size(*frame_hw, self.video["small_image_area"])
        sx, sy = self.slide_hw[1] / ws, self.slide_hw[0] / hs
        dev = self.device
        jj = (torch.arange(0, ws, stride, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
        ii = (torch.arange(0, hs, stride, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
        gx, gy = jj[None, None, :], ii[None, :, None]
        a, b, tx, ty = (v[:, None, None] for v in t)
        x = ((a * gx - b * gy + tx) + 0.5) * (fsw / frame_hw[1]) - 0.5
        y = ((b * gx + a * gy + ty) + 0.5) * (fsh / frame_hw[0]) - 0.5
        img = f["small"]
        h, w = img.shape
        xf, yf = x.reshape(-1), y.reshape(-1)
        inb = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        gyy = torch.arange(h, dtype=torch.float32, device=dev)
        gxx = torch.arange(w, dtype=torch.float32, device=dev)
        vals = []
        for i in range(0, xf.shape[0], 2048):
            ry = torch.clamp(1.0 - torch.abs(torch.clamp(yf[i:i + 2048], 0.0, h - 1.0)[:, None] - gyy), min=0.0)
            cx = torch.clamp(1.0 - torch.abs(torch.clamp(xf[i:i + 2048], 0.0, w - 1.0)[:, None] - gxx), min=0.0)
            vals.append(((ry @ img) * cx).sum(-1))
        warped = torch.where(inb, torch.cat(vals), 0.0).reshape(x.shape)
        return similarity(warped, self.smalls[slides][:, ::stride, ::stride])

    def match_frame(self, img: torch.Tensor, frame_idx: int) -> dict:
        """slide (-1: none), similarity and rating of the winner, and the
        frame's valid keypoint count."""
        m = self.match
        with self.precision():
            f = self.features(img, slide=False)
            if self.n_slides > m["screen_above_slides"] and self.k % 128 == 0:
                cols = self._screen(f)
            else:
                cols = torch.arange(self.n_slides, device=self.device)
            dist, arg, svalid = self._table(f, cols)
            # Ratio filter, fan-out cap, slides by kept-match count.
            qv = f["valid"]
            valid = svalid[None, :] & qv[:, None]
            best = torch.where(valid, dist, _BIG).amin(dim=1, keepdim=True)
            keep = valid & (dist < best * m["ratio"])
            if dist.shape[1] > m["knn_k"]:
                key = torch.where(keep, _BIG - dist, -_BIG)
                kth = top_k(key, m["knn_k"])[0][:, -1:]
                keep &= key >= torch.clamp(kth, min=0.0)
            counts = keep.sum(0).to(torch.float32)
            top_counts, cand = top_k(counts, min(m["top_slides"], dist.shape[1]))
            mm = min(m["max_matches_per_slide"], dist.shape[0])
            key = torch.where(keep, _BIG - dist, -_BIG).T[cand]
            topv, qidx = top_k(key, mm)
            train = torch.gather(arg.T[cand], 1, qidx)
            slides = cols[cand]
            cand_valid = top_counts > 0
            src = torch.gather(self.pts[slides], 1, train[..., None].expand(-1, -1, 2))
            dst = f["pts"][qidx]
            mvalid = (topv > 0) & cand_valid[:, None]
            gen = torch.Generator(device=self.device)
            gen.manual_seed((m["ransac_seed"] << 32) ^ (frame_idx & 0xFFFFFFFF))
            u = torch.rand((cand.shape[0], m["ransac_iters"], 2), generator=gen, device=self.device,
                           dtype=torch.float32)
            t, rating, ok = self._ransac(src, dst, mvalid, u)
            top_r, top_i = top_k(rating, min(m["top_rated"], rating.shape[0]))
            retain = (top_r > m["min_rating"]) & (top_r / torch.clamp(top_r[0], min=1e-9) > m["min_rating_ratio"])
            retain &= (ok & cand_valid)[top_i]
            sims = self._verify(f, tuple(img.shape), [v[top_i] for v in t], slides[top_i])
            sims = torch.where(retain, sims, -torch.inf)
            win = int(torch.argmax(sims))
            sim = float(sims[win])
            slide = int(slides[top_i][win]) if sim > m["min_similarity"] else -1
            return dict(slide=slide, similarity=sim, rating=float(top_r[win]), keypoints=f["count"])

    def changed(self, img: torch.Tensor, prev: torch.Tensor | None) -> bool:
        """Whether the dedup passes the frame on: its thumbnail's similarity
        with its predecessor's is below the threshold (the first frame of a
        stream always passes)."""
        if prev is None:
            return True
        area = self.video["small_image_area"]
        with self.precision():
            sim = similarity(thumbnail(img, area), thumbnail(prev, area))
        return bool(sim < self.video["dedup_similarity"])
