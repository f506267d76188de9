"""The one generator of sampled frames; a traffic mix is a data file of its
parameters (``portbench/traffic/<mix>.json``), a cell adds its own
(``portbench/workloads/<cell>.json``: ``dwell``).

A client's stream is a pool of ``pool`` sampled frames, cycled in order.
The pool is cut into periods of ``period`` samples: the first ``period -
len(no_slide)`` show slides, the last ones no slide (``"noise"``: uniform
random pixels; ``"blank"``: one gray level). A slide sample is a new camera
view of the current slide: a perspective that moves each page corner by up
to ``corner_frac`` of the width, a rotation of up to ``rotate_deg``, a scale
in ``scale``, a shift of up to ``shift_px`` (``chip_smoke.py:warp``, lines
456-470, and ``perspective``, lines 1825-1843, rewritten in PyTorch on the
device), the gray 230 outside the page, a lighting gain and Gaussian noise
of ``noise_sigma``. The gain alternates between ``gain_low`` and
``gain_high`` from sample to sample, so every slide sample differs from the
one before it by more than the dedup threshold. Slides dwell ``dwell``
samples each: on a ``lecture`` deck the pages in an order drawn from (seed,
client); on a ``reveal`` deck the families in such an order, each family's
members in reveal order. With ``hold`` (a screen recording: the screen
shows a slide unchanged while it dwells) every sample of a dwell is the
dwell's first sample, pixel for pixel, wherever the dwell's samples lie.
So every seed gives the same number of samples a slide, the same changed
share and no-slide samples at the same positions; only the pixels change.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import seeds

NOISE, BLANK = -1, -2


class FilmedStream:
    """The sampled frames of one client (``client``) of a cell."""

    def __init__(self, mix: dict, dwell: int, deck: dict, seed: int, client: int):
        self.mix, self.dwell, self.deck = mix, dwell, deck
        self.seed, self.client = seed, client
        self.pool, self.period = mix["pool"], mix["period"]
        self.no_slide = [{"noise": NOISE, "blank": BLANK}[k] for k in mix["no_slide"]]
        self.per_period = self.period - len(self.no_slide)
        if self.pool % self.period:
            raise ValueError(f"pool {self.pool} is not a multiple of the period {self.period}")
        self.hw = (deck["height"], deck["width"])
        n_slide = self.pool // self.period * self.per_period
        units = deck["pages"]                     # pages, or families of a reveal deck
        per_unit = dwell * (deck["reveals"] if deck["kind"] == "reveal" else 1)
        g = seeds.generator("cpu", seed, seeds.ORDER, client)
        order: list[int] = []
        while len(order) * per_unit < n_slide:
            perm = torch.randperm(units, generator=g).tolist()
            if order and perm[0] == order[-1]:
                perm[0], perm[-1] = perm[-1], perm[0]
            order += perm
        self._order, self._per_unit = order, per_unit

    def page(self, k: int) -> int:
        """The slide that sample ``k`` shows (``NOISE`` or ``BLANK`` for none)."""
        k %= self.pool
        pos = k % self.period
        if pos >= self.per_period:
            return self.no_slide[pos - self.per_period]
        j = k // self.period * self.per_period + pos
        unit = self._order[j // self._per_unit]
        if self.deck["kind"] == "reveal":
            return unit * self.deck["reveals"] + (j % self._per_unit) // self.dwell
        return unit

    def source(self, k: int) -> int:
        """The pool sample whose draws make sample ``k``: ``k`` in the pool
        or, with ``hold``, a slide sample's dwell's first sample."""
        k %= self.pool
        pos = k % self.period
        if not self.mix.get("hold") or pos >= self.per_period:
            return k
        j = k // self.period * self.per_period + pos
        j -= j % self.dwell
        return j // self.per_period * self.period + j % self.per_period

    def _homography(self, k: int) -> torch.Tensor:
        """Frame pixel -> page pixel map [3, 3] (float64) of sample ``k``."""
        m, (h, w) = self.mix, self.hw
        g = seeds.generator("cpu", self.seed, seeds.FRAME, self.client, k)
        u = lambda lo, hi, n=1: (lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64))  # noqa: E731
        th = math.radians(float(u(-m["rotate_deg"], m["rotate_deg"])))
        s = float(u(*m["scale"]))
        t = u(-m["shift_px"], m["shift_px"], 2) * (w / 1920)
        c = torch.tensor([w / 2, h / 2], dtype=torch.float64)
        rot = torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]],
                           dtype=torch.float64) * s
        sim = torch.eye(3, dtype=torch.float64)
        sim[:2, :2] = rot
        sim[:2, 2] = c + t - rot @ c
        src = torch.tensor([[0, 0], [w, 0], [w, h], [0, h]], dtype=torch.float64)
        dst = src + u(-m["corner_frac"] * w, m["corner_frac"] * w, 8).reshape(4, 2)
        a, b = [], []
        for (x, y), (p, q) in zip(src.tolist(), dst.tolist()):
            a += [[x, y, 1, 0, 0, 0, -p * x, -p * y], [0, 0, 0, x, y, 1, -q * x, -q * y]]
            b += [p, q]
        persp = torch.cat([torch.linalg.solve(torch.tensor(a, dtype=torch.float64),
                                              torch.tensor(b, dtype=torch.float64)),
                           torch.ones(1, dtype=torch.float64)]).reshape(3, 3)
        return torch.linalg.inv(persp @ sim)

    def gain(self, k: int) -> float:
        g = seeds.generator("cpu", self.seed, seeds.FRAME, self.client, k, 1)
        lo, hi = self.mix["gain_low"] if k % 2 == 0 else self.mix["gain_high"]
        return lo + (hi - lo) * float(torch.rand(1, generator=g, dtype=torch.float64))

    def make(self, ks: list[int], deck: torch.Tensor) -> torch.Tensor:
        """Samples ``ks`` as [n, H, W] uint8 on ``deck``'s device."""
        dev, (h, w) = deck.device, self.hw
        out = torch.empty((len(ks), h, w), dtype=torch.uint8, device=dev)
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        for i, k in enumerate(ks):
            page, k = self.page(k), self.source(k)
            noise_g = seeds.generator(dev, self.seed, seeds.NOISE, self.client, k)
            if page == NOISE:
                out[i] = torch.randint(0, 256, (h, w), generator=noise_g, device=dev).to(torch.uint8)
                continue
            if page == BLANK:
                out[i] = self.mix["blank_level"]
                continue
            hi = self._homography(k).to(torch.float32).tolist()
            den = hi[2][0] * xs + hi[2][1] * ys + hi[2][2]
            u = (hi[0][0] * xs + hi[0][1] * ys + hi[0][2]) / den
            v = (hi[1][0] * xs + hi[1][1] * ys + hi[1][2]) / den
            inside = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
            grid = torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1], dim=-1)[None]
            img = F.grid_sample(deck[page].to(torch.float32)[None, None], grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)[0, 0]
            img = torch.where(inside, img, 230.0) * self.gain(k)
            img = img + torch.randn((h, w), generator=noise_g, device=dev) * self.mix["noise_sigma"]
            out[i] = torch.round(img).clamp(0, 255).to(torch.uint8)
        return out

    def make_pool(self, deck: torch.Tensor, chunk: int = 32) -> tuple[np.ndarray, list[int]]:
        """The whole pool as one host array [pool, H, W] uint8, and each
        frame's ``pages.checksums``."""
        from .pages import checksums

        pool, sums = np.empty((self.pool, *self.hw), np.uint8), []
        for c0 in range(0, self.pool, chunk):
            frames = self.make(list(range(c0, min(c0 + chunk, self.pool))), deck)
            sums += checksums(frames)
            pool[c0:c0 + len(frames)] = frames.cpu().numpy()
        return pool, sums
