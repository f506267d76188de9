"""The plain reference of the SIFT engine: frame -> page in plain PyTorch.

It answers, from the same pages and frames the benchmark hands the
program, what ``MatchingEngine(engine="sift")`` must answer for a sampled
frame: whether the dedup passes it on, and if so which slide it shows (or
none), with the winner's similarity and RANSAC rating. The features follow
Lowe (IJCV 60(2):91-110, 2004): a Gaussian scale space from sigma0 with
three scales an octave (3.2-3.3), DoG extrema with a contrast floor and the
edge test at r = 10 (4, 4.1), a 36-bin orientation histogram (5), a 4x4x8
descriptor normalised, clamped at 0.2 and normalised again (6.1), and his
distance ratio (7.1); the cascade after it is the reference project's
(hediet/slideo, crates/matching-opencv lib.rs:249-414: top-40 slides by
match count, top-10 by inliers, a warped-image similarity above 0.5).

It departs from Lowe where the engine does, and computes what the engine
computes:

- the extrema are 2-D, on each of the 3 DoG levels of an octave apart (4
  blurs a octave), not 3-D over 5 levels; the response is the largest
  |DoG| of a pixel over the levels where it is an extremum, its subpixel
  offset a 2-D quadratic fit of the middle level, clamped to 0.6 px;
- an octave keeps a quota of the strongest responses (half as many as the
  octave before, ``octave_quota_decay``), inside a border of ``border``
  px; an octave smaller than the border and the patch gives none;
- one orientation a keypoint: the centre of the first largest bin of the
  histogram over a 63 x 63 patch of the octave's second blur level, with a
  Gaussian window of sigma 15.5 and no smoothing or interpolation;
- the descriptor samples a fixed 16 x 16 grid of radius
  ``descriptor_radius`` on that patch, rotated, bilinearly, with a
  Gaussian window of half the radius and trilinear cell weights;
- Lowe's ratio is taken within each slide (nearest and second nearest in
  that slide), so a kept match does not depend on the other slides;
- a 4-point homography RANSAC (500 hypotheses scored, the first best,
  then 10 least-squares refinements over its inliers, a tolerance of 3 px
  times the larger detection octave of the match) in place of the Hough
  transform and affine fit.

It imports nothing of the port, of the JAX package or of JAX, takes
nothing the program made (no index, no table, no draws: it draws the
hypotheses by the engine's rule, a ``torch.Generator`` seeded by
``(ransac_seed << 32) ^ frame``, [C, ransac_iters, 4], the first 500
scored), and runs only the exact table over every slide: a deck above
``screen_above_slides`` slides, which the engine screens first, raises
``NotImplementedError``.

Its arithmetic is float32 with TF32 off, as the configuration states (the
engine turns TF32 off for its blurs, resizes, table and similarities).
``control="tf32"`` gives the control one precision step lower: the
operands of the table's products and of the blurs' convolutions rounded
to TF32 (10 mantissa bits, to nearest, ties away from zero), as the card's
TF32 units round them; rounded here, so the control is the same on any
device.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .orb import _on, resize, similarity, small_size, thumbnail, top_k

_NEG = float(-(2**30))      # the score of an invalid slot
_BIG = 1e6
_HALF = 31                  # patch radius: 63 x 63 patches
_PATCH = 2 * _HALF + 1
_NORM = 1024.0              # RANSAC's coordinate scale
_HYP_CHUNK = 250            # hypotheses are scored in whole chunks of 250
_TABLE_SLIDES = 8           # slides a table product
_BUILD_PAGES = 32           # pages a thumbnail product (the engine's build chunks)
_THUMB_AREA = 300 * 400     # the frame thumbnail's area, whatever the configuration says


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


# ---- scale space -------------------------------------------------------------

def _gauss(ksize: int, sigma: float) -> np.ndarray:
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, ksize: int, sigma: float, rnd=_same) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] float32, reflect-101 borders: a row
    pass, then a column pass."""
    pad = ksize // 2
    k = rnd(torch.from_numpy(_gauss(ksize, sigma)).to(img.device))
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(rnd(x), k.reshape(1, 1, 1, ksize))
    return F.conv2d(rnd(x), k.reshape(1, 1, ksize, 1))[0, 0]


def _sh(d: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``d`` shifted by (dy, dx), wrapping around: out[y, x] = d[y - dy, x - dx]."""
    return torch.roll(d, shifts=(dy, dx), dims=(0, 1))


def _hessian(d: torch.Tensor):
    dxx = _sh(d, 0, -1) + _sh(d, 0, 1) - 2 * d
    dyy = _sh(d, -1, 0) + _sh(d, 1, 0) - 2 * d
    dxy = 0.25 * (_sh(d, -1, -1) + _sh(d, 1, 1) - _sh(d, -1, 1) - _sh(d, 1, -1))
    return dxx, dyy, dxy


def _extremum_response(d: torch.Tensor, contrast: float, r: float) -> torch.Tensor:
    """|d| where ``d`` is a strict extremum of its 8 neighbours beyond the
    contrast and passes the edge test tr^2 r < (r + 1)^2 det, else 0."""
    nb = torch.stack([_sh(d, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx])
    peak = ((d > nb.amax(0)) & (d > contrast)) | ((d < nb.amin(0)) & (d < -contrast))
    dxx, dyy, dxy = _hessian(d)
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    return torch.where(peak & edge_ok, torch.abs(d), 0.0)


def quotas(sift: dict) -> list[int]:
    frac, n = sift["octave_quota_decay"], sift["max_keypoints"]
    q = n * (1 - frac) / (1 - frac ** sift["n_octaves"])
    out = []
    for _ in range(sift["n_octaves"]):
        out.append(max(int(round(q)), 1))
        q *= frac
    out[-1] += n - sum(out)
    return out


# ---- orientation and descriptor ------------------------------------------------

def _patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[K, 63, 63] windows centred at (ys, xs), shifted inside the image."""
    h, w = img.shape
    ar = torch.arange(_PATCH, device=img.device)
    y0 = torch.clamp(ys - _HALF, 0, max(h - _PATCH, 0))
    x0 = torch.clamp(xs - _HALF, 0, max(w - _PATCH, 0))
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def _bilinear(p: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Samples [K, N] of patches p [K, P, P] at patch-centred points,
    clamped to the patch."""
    k, n = p.shape[0], p.shape[-1]
    x = torch.clamp(xs + _HALF, 0.0, n - 1.0)
    y = torch.clamp(ys + _HALF, 0.0, n - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    ax0, ay0 = 1.0 - (x - x0), 1.0 - (y - y0)
    ax1, ay1 = 1.0 - ((x0 + 1.0) - x), 1.0 - ((y0 + 1.0) - y)
    ix0, iy0 = x0.long(), y0.long()
    ix1, iy1 = torch.clamp(ix0 + 1, max=n - 1), torch.clamp(iy0 + 1, max=n - 1)
    flat = p.reshape(k, n * n)
    at = lambda iy, ix: torch.gather(flat, 1, iy * n + ix)  # noqa: E731
    return (ay0 * at(iy0, ix0) + ay1 * at(iy1, ix0)) * ax0 + (ay0 * at(iy0, ix1) + ay1 * at(iy1, ix1)) * ax1


@lru_cache(maxsize=1)
def _orientation_window() -> np.ndarray:
    ys = np.arange(-_HALF, _HALF + 1, dtype=np.float32)
    return np.exp(-(ys[None, :] ** 2 + ys[:, None] ** 2) / (2 * (_HALF / 2) ** 2))


def orientation(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the centre of each patch's first largest bin of 36."""
    dx = 0.5 * (torch.roll(p, -1, 2) - torch.roll(p, 1, 2))
    dy = 0.5 * (torch.roll(p, -1, 1) - torch.roll(p, 1, 1))
    mag = (torch.sqrt(dx * dx + dy * dy) * _on(_orientation_window, (), p.device)).reshape(p.shape[0], -1)
    bins = torch.remainder((torch.atan2(dy, dx) + math.pi) / (2 * math.pi) * 36.0, 36.0).to(torch.int32)
    bins = bins.reshape(p.shape[0], -1)
    hist = torch.stack([torch.where(bins == b, mag, 0.0).sum(dim=1) for b in range(36)], dim=1)
    theta = (torch.argmax(hist, dim=1).to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi
    return torch.cos(theta), torch.sin(theta)


@lru_cache(maxsize=4)
def _grid(radius: float, part: int) -> np.ndarray:
    """The 16 x 16 sample grid [256, 2], each sample's weight in the 4 x 4
    cells [256, 16] and the Gaussian window [256]; ``part`` picks one."""
    step = 2.0 * radius / 16
    coords = (np.arange(16) + 0.5) * step - radius
    gx, gy = np.meshgrid(coords, coords)
    grid = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    cstep = 2.0 * radius / 4
    cc = (np.arange(4) + 0.5) * cstep - radius
    cgx, cgy = np.meshgrid(cc, cc)
    wx = np.maximum(0, 1 - np.abs(grid[:, None, 0] - cgx.ravel()[None, :]) / cstep)
    wy = np.maximum(0, 1 - np.abs(grid[:, None, 1] - cgy.ravel()[None, :]) / cstep)
    window = np.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2) / (2 * (radius * 0.5) ** 2))
    return (grid, (wx * wy).astype(np.float32), window.astype(np.float32))[part]


def descriptors(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor, radius: float) -> torch.Tensor:
    """[K, 128] unit descriptors of patches p at orientations (c, s)."""
    grid, cell_w, window = (_on(_grid, (float(radius), i), p.device) for i in range(3))
    c, s = c[:, None], s[:, None]
    rx = c * grid[:, 0] - s * grid[:, 1]
    ry = s * grid[:, 0] + c * grid[:, 1]
    gx = 0.5 * (_bilinear(p, rx + c, ry + s) - _bilinear(p, rx - c, ry - s))
    gy = 0.5 * (_bilinear(p, rx - s, ry + c) - _bilinear(p, rx + s, ry - c))
    mag = torch.sqrt(gx * gx + gy * gy) * window
    binf = (torch.atan2(gy, gx) + math.pi) / (2 * math.pi) * 8.0
    b0 = torch.floor(binf)
    frac = binf - b0
    bins = torch.arange(8, dtype=torch.float32, device=p.device)
    w8 = (torch.remainder(b0, 8)[..., None] == bins) * (1 - frac)[..., None] \
        + (torch.remainder(b0 + 1, 8)[..., None] == bins) * frac[..., None]
    d = torch.einsum("gc,kgo->kco", cell_w, w8 * mag[..., None]).reshape(p.shape[0], -1)
    d = torch.clamp(d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9), max=0.2)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)


# ---- homography RANSAC -------------------------------------------------------------

def _dlt(p: torch.Tensor, q: torch.Tensor):
    """Rows A [..., 2M, 8] and b [..., 2M] of A h = b for p -> q, h8 = 1."""
    x, y, u, v = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    o, z = torch.ones_like(x), torch.zeros_like(x)
    a = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], dim=-2)
    return a, torch.cat([u, v], dim=-1)


def _fit(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor | None = None):
    """(h [..., 8], ok): ridge-stabilised normal equations, h zero where
    the solve is not finite."""
    if w is not None:
        a, b = a * w[..., None], b * w
    ata = torch.einsum("...mi,...mj->...ij", a, a) + 1e-6 * torch.eye(8, device=a.device)
    atb = torch.einsum("...mi,...m->...i", a, b)
    h = torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]
    ok = torch.isfinite(h).all(dim=-1)
    return torch.where(ok[..., None], h, 0.0), ok


def _project(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    w = h[..., 6] * x + h[..., 7] * y + 1.0
    w = torch.where(torch.abs(w) > 1e-8, w, 1e-8)
    return (h[..., 0] * x + h[..., 1] * y + h[..., 2]) / w, (h[..., 3] * x + h[..., 4] * y + h[..., 5]) / w


def _inliers(h, src, dst, valid, thr2):
    u, v = _project(h[..., None, :], src[..., 0], src[..., 1])
    du, dv = u - dst[..., 0], v - dst[..., 1]
    return (du * du + dv * dv < thr2) & valid


def ransac(src, dst, valid, tol, u, thresh: float, refine: int):
    """Homographies [C, 8] (slide -> frame pixels), ratings [C] and found
    [C] of C candidates' matches src, dst [C, M, 2] (valid first)."""
    c, n_hyp = u.shape[:2]
    src, dst = src / _NORM, dst / _NORM
    thr2 = (thresh / _NORM * tol) ** 2
    n = valid.sum(-1).to(torch.int32)
    idx = torch.minimum((u * n[:, None, None]).to(torch.int32), torch.clamp(n - 1, min=0)[:, None, None]).long()
    distinct = torch.stack([idx[..., i] != idx[..., j] for i in range(4) for j in range(i + 1, 4)]).all(0)
    flat = idx.reshape(c, -1, 1).expand(-1, -1, 2)
    hyp, ok = _fit(*_dlt(torch.gather(src, 1, flat).reshape(c, n_hyp, 4, 2),
                         torch.gather(dst, 1, flat).reshape(c, n_hyp, 4, 2)))
    used = min(max(n_hyp // _HYP_CHUNK, 1) * _HYP_CHUNK, n_hyp)
    ok = ok & distinct & (n >= 4)[:, None]
    counts = _inliers(hyp[:, :used], src[:, None], dst[:, None], valid[:, None], thr2[:, None]).sum(-1)
    counts = torch.where(ok[:, :used], counts.to(torch.float32), -1.0)
    first = torch.argmax(counts, dim=1)
    found = counts.amax(dim=1) >= 4
    h = hyp[torch.arange(c, device=u.device), first]
    a, b = _dlt(src, dst)
    for _ in range(refine):
        inl = _inliers(h, src, dst, valid, thr2)
        new, fit_ok = _fit(a, b, torch.cat([inl, inl], dim=-1).to(torch.float32))
        h = torch.where((fit_ok & found & (inl.sum(-1) >= 4))[:, None], new, h)
    rating = (_inliers(h, src, dst, valid, thr2) & found[:, None]).sum(-1).to(torch.float32)
    h = torch.stack([h[:, 0], h[:, 1], h[:, 2] * _NORM, h[:, 3], h[:, 4], h[:, 5] * _NORM,
                     h[:, 6] / _NORM, h[:, 7] / _NORM], -1)      # back to pixels
    return h, rating, found


# ---- the reference ---------------------------------------------------------------

class Reference:
    """The SIFT engine's answers for one deck, computed plainly."""

    def __init__(self, conf: dict, deck: torch.Tensor, control: str | None = None):
        if conf["engine"] != "sift":
            raise NotImplementedError("the reference computes the SIFT engine only")
        self.sift, self.match, self.video = conf["sift"], conf["match"], conf["video"]
        if deck.shape[0] > self.match["screen_above_slides"]:
            raise NotImplementedError("the reference runs the exact table over every slide only")
        self.rnd = {None: _same, "tf32": _tf32}[control]
        self.device = deck.device
        self.slide_hw = tuple(deck.shape[1:])
        with self.precision():
            feats, smalls = [], []
            for c0 in range(0, deck.shape[0], _BUILD_PAGES):
                chunk = deck[c0:c0 + _BUILD_PAGES]
                feats += [self.features(page.to(torch.float32)) for page in chunk]
                smalls.append(thumbnail(chunk, self.video["small_image_area"]))
            self.desc = torch.stack([f["desc"] for f in feats])     # [S, K, 128]
            self.valid = torch.stack([f["valid"] for f in feats])   # [S, K]
            self.pts = torch.stack([f["pts"] for f in feats])
            self.scale = torch.stack([f["scale"] for f in feats])
            self.smalls = torch.cat(smalls)

    @contextlib.contextmanager
    def precision(self):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def features(self, img: torch.Tensor) -> dict:
        """Keypoints of a [H, W] float32 image, octave by octave: desc [K,
        128], valid [K], pts [K, 2] (x, y) full-image, scale [K]."""
        sf, dev = self.sift, img.device
        min_dim = max(2 * sf["border"] + 8, _PATCH + 2)
        parts, base, scale = [], img, 1.0
        for o, kq in enumerate(quotas(sf)):
            if o:
                base = resize(base, (max(base.shape[0] // 2, 1), max(base.shape[1] // 2, 1)), area=False)
            oh, ow = base.shape
            if oh < min_dim or ow < min_dim:
                parts.append(dict(desc=torch.zeros((kq, 128), device=dev),
                                  valid=torch.zeros(kq, dtype=torch.bool, device=dev),
                                  pts=torch.zeros((kq, 2), device=dev), scale=torch.ones(kq, device=dev)))
                continue
            blurs = [blur(base, sf["blur_ksize"], sf["sigma0"] * (2 ** (s / 3)), self.rnd) for s in range(4)]
            dogs = [blurs[i + 1] - blurs[i] for i in range(3)]
            resp = torch.stack([_extremum_response(d, sf["contrast_threshold"], sf["edge_ratio"]) for d in dogs])
            resp = torch.maximum(torch.maximum(resp[0], resp[1]), resp[2])
            d = dogs[1]
            gx, gy = 0.5 * (_sh(d, 0, -1) - _sh(d, 0, 1)), 0.5 * (_sh(d, -1, 0) - _sh(d, 1, 0))
            dxx, dyy, dxy = _hessian(d)
            det = dxx * dyy - dxy * dxy
            det = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
            off_x = torch.clamp(-(dyy * gx - dxy * gy) / det, -0.6, 0.6).reshape(-1)
            off_y = torch.clamp(-(dxx * gy - dxy * gx) / det, -0.6, 0.6).reshape(-1)
            b = sf["border"]
            inside = torch.zeros_like(resp, dtype=torch.bool)
            inside[b:oh - b, b:ow - b] = True
            top, at = top_k(torch.where(inside, resp, 0.0).reshape(-1), kq)
            ys, xs = at // ow, at % ow
            p = _patches(blurs[1], ys, xs)
            c, s = orientation(p)
            valid = top > 0.0
            parts.append(dict(
                desc=torch.where(valid[:, None], descriptors(p, c, s, sf["descriptor_radius"]), 0.0),
                valid=valid,
                pts=torch.stack([xs.to(torch.float32) + off_x[at], ys.to(torch.float32) + off_y[at]], -1) * scale,
                scale=torch.full((kq,), scale, device=dev)))
            scale *= 2.0
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _table(self, q: torch.Tensor):
        """(dist, dist2, arg) [Q, S]: the distance of each query's nearest
        and second nearest valid slot in each slide, and the first nearest."""
        s, k = self.valid.shape
        qr = self.rnd(q)
        best, second, arg = [], [], []
        for c0 in range(0, s, _TABLE_SLIDES):
            d = self.desc[c0:c0 + _TABLE_SLIDES]
            sc = torch.matmul(qr, self.rnd(d.reshape(-1, 128)).T).reshape(q.shape[0], d.shape[0], k)
            sc = torch.where(self.valid[None, c0:c0 + _TABLE_SLIDES], sc, _NEG)
            b, a = sc.max(dim=-1)
            best.append(b)
            arg.append(a)
            second.append(torch.where(torch.arange(k, device=q.device) == a[..., None], _NEG, sc).amax(-1))
        dist = lambda x: torch.sqrt(torch.clamp(2.0 - 2.0 * torch.cat(x, 1), min=0.0))  # noqa: E731
        return dist(best), dist(second), torch.cat(arg, 1)

    def _verify(self, small: torch.Tensor, frame_hw, h: torch.Tensor, slides: torch.Tensor) -> torch.Tensor:
        """Similarity of each candidate slide's thumbnail (on the stride
        grid) with the frame thumbnail seen through its homography."""
        stride, dev = self.match["verify_stride"], self.device
        hs, ws = self.smalls.shape[-2:]
        fsh, fsw = small_size(*frame_hw, _THUMB_AREA)
        sx, sy = self.slide_hw[1] / ws, self.slide_hw[0] / hs
        gx = ((torch.arange(0, ws, stride, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5)[None, None, :]
        gy = ((torch.arange(0, hs, stride, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5)[None, :, None]
        fx, fy = _project(h[:, None, None, :], gx, gy)
        x = ((fx + 0.5) * (fsw / frame_hw[1]) - 0.5).reshape(-1)
        y = ((fy + 0.5) * (fsh / frame_hw[0]) - 0.5).reshape(-1)
        fh, fw = small.shape
        inb = (x >= 0) & (x <= fw - 1) & (y >= 0) & (y <= fh - 1)
        rows = torch.arange(fh, dtype=torch.float32, device=dev)
        cols = torch.arange(fw, dtype=torch.float32, device=dev)
        vals = []
        for i in range(0, x.shape[0], 2048):
            ry = torch.clamp(1.0 - torch.abs(torch.clamp(y[i:i + 2048], 0.0, fh - 1.0)[:, None] - rows), min=0.0)
            cx = torch.clamp(1.0 - torch.abs(torch.clamp(x[i:i + 2048], 0.0, fw - 1.0)[:, None] - cols), min=0.0)
            vals.append(((ry @ small) * cx).sum(-1))
        warped = torch.where(inb, torch.cat(vals), 0.0).reshape(h.shape[0], gy.shape[1], gx.shape[2])
        return similarity(warped, self.smalls[slides][:, ::stride, ::stride])

    def match_frame(self, img: torch.Tensor, frame_idx: int) -> dict:
        """slide (-1: none), similarity and rating of the winner, and the
        frame's valid keypoint count."""
        m = self.match
        with self.precision():
            frame = img.to(torch.float32)
            f = self.features(frame)
            small = thumbnail(frame, _THUMB_AREA)
            dist, dist2, arg = self._table(f["desc"])
            # Lowe's ratio within each slide; slides by kept-match count.
            keep = self.valid.any(1)[None, :] & f["valid"][:, None] & (dist < self.sift["lowe_ratio"] * dist2)
            counts, cand = top_k(keep.sum(0).to(torch.float32), min(m["top_slides"], dist.shape[1]))
            key = torch.where(keep, _BIG - dist, -_BIG).T[cand]
            topv, qidx = top_k(key, min(m["max_matches_per_slide"], dist.shape[0]))
            train = torch.gather(arg.T[cand], 1, qidx)
            src = torch.gather(self.pts[cand], 1, train[..., None].expand(-1, -1, 2))
            dst = f["pts"][qidx]
            valid = (topv > 0) & (counts > 0)[:, None]
            tol = torch.maximum(torch.gather(self.scale[cand], 1, train), f["scale"][qidx])
            gen = torch.Generator(device=self.device)
            gen.manual_seed((m["ransac_seed"] << 32) ^ (frame_idx & 0xFFFFFFFF))
            u = torch.rand((cand.shape[0], m["ransac_iters"], 4), generator=gen, device=self.device,
                           dtype=torch.float32)
            h, rating, found = ransac(src, dst, valid, tol, u, m["ransac_threshold"], m["ransac_refine_iters"])
            top_r, top_i = top_k(rating, min(m["top_rated"], rating.shape[0]))
            retain = (top_r > self.sift["min_rating"]) & (top_r / torch.clamp(top_r[0], min=1e-9) > m["min_rating_ratio"])
            retain &= (found & (counts > 0))[top_i]
            sims = self._verify(small, tuple(img.shape), h[top_i], cand[top_i])
            sims = torch.where(retain, sims, -torch.inf)
            win = int(torch.argmax(sims))
            sim = float(sims[win])
            slide = int(cand[top_i][win]) if sim > m["min_similarity"] else -1
            return dict(slide=slide, similarity=sim, rating=float(top_r[win]), keypoints=int(f["valid"].sum()))

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

