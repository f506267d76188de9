"""Slide decks made on the device from the seed.

A PyTorch rewrite of ``chip_smoke.py:make_deck`` (lines 364-391) and
``make_reveal_deck`` (lines 1498-1512) at the commit that added this
benchmark: a white page, a title bar, lines of word-like boxes made of
glyph-sized strokes of random ink, one or two figures of blocky random
texture, all at the same sizes and in the same ranges, drawn on a 1080 x
1920 design grid and scaled to the deck's size. Each page comes from its
own generator (``seeds.mix(seed, PAGE, page)``), so a page can be made
alone and a deck of n pages starts with the pages of any shorter one.

Departures from ``make_deck`` and ``make_reveal_deck``, so that every seed
gives the same work: every page carries a block of texture at the top
right (a header logo, 10 x 24 blocks of 12 px), so that a reveal step that
shows only the top of a page still yields far more than 768 FAST
keypoints; the extra gap between lines (1 in 5) comes only after the sixth
line, so a page has at least six lines; and a reveal step's cut lies at the
top of a text line, not at a fixed row: the first member of a family shows
the header and the first two lines, each further member at least one more
line, the last the whole page (a fixed row can cut a band without text,
and two members that show the same pixels have no right answer between
them). The glyphs are drawn as boxes with a white interior through a
difference array, in one scatter a chunk of pages.
"""

from __future__ import annotations

import torch

from . import seeds

DESIGN_HW = (1080, 1920)
_TOP, _BOTTOM_MARGIN = 220, 90      # make_deck's text lines lie in between
_MAX_LINES, _MAX_WORDS, _MAX_GLYPHS = 20, 60, 8
_MIN_LINES = 6                       # lines before the first extra gap
_BLOCK = 12                          # texture block size (design px)
_CHUNK = 16                          # pages rasterised at once


def _ri(g: torch.Generator, lo: int, hi: int, shape, device) -> torch.Tensor:
    """numpy's ``randint(lo, hi)``: integers in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=g, device=device)


def _page_rects(g: torch.Generator, device) -> tuple[torch.Tensor, list, list[int]]:
    """One page's boxes in design pixels, [n, 5] int64 rows (y0, y1, x0, x1,
    value added to white), its textures [(y, x, blocks [bh, bw])] and the
    top row of each of its text lines."""
    h, w = DESIGN_HW
    rects = []
    title_w, title_ink = _ri(g, 500, 1500, (), device), _ri(g, 10, 120, (), device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    rects.append(torch.stack([zero + 50, zero + 150, zero + 80, 80 + title_w, title_ink - 255])[None])

    # Lines: y_0 = 220, then line height + gap (+ an extra gap, 1 in 5, from
    # the seventh line on); a line exists while its top is above h - 90.
    line_h = _ri(g, 18, 40, (_MAX_LINES,), device)
    gap = _ri(g, 22, 70, (_MAX_LINES,), device)
    extra = _ri(g, 40, 160, (_MAX_LINES,), device) * (torch.rand(_MAX_LINES, generator=g, device=device) < 0.2)
    extra[:_MIN_LINES] = 0
    pitch = line_h + gap + extra
    y = _TOP + torch.cumsum(pitch, 0) - pitch
    line_ok = y < h - _BOTTOM_MARGIN
    x_start = 100 + _ri(g, 0, 200, (_MAX_LINES,), device)
    ink = _ri(g, 0, 140, (_MAX_LINES,), device)

    # Words of 2-8 glyphs; a word starts while x < w - 200.
    shape = (_MAX_LINES, _MAX_WORDS, _MAX_GLYPHS)
    n_glyphs = _ri(g, 2, 9, shape[:2], device)
    gw = _ri(g, 6, 16, shape, device)
    space = _ri(g, 2, 5, shape, device)
    word_gap = _ri(g, 14, 45, shape[:2], device)
    glyph_ok = torch.arange(_MAX_GLYPHS, device=device) < n_glyphs[..., None]
    step = (gw + space) * glyph_ok
    word_w = step.sum(-1) + word_gap
    word_x = x_start[:, None] + torch.cumsum(word_w, 1) - word_w
    word_ok = (word_x < w - 200) & line_ok[:, None]
    gx = word_x[..., None] + torch.cumsum(step, -1) - step
    ok = glyph_ok & word_ok[..., None]
    lh = line_h[:, None, None].expand(shape)
    top = y[:, None, None] + (torch.rand(shape, generator=g, device=device) * (lh // 3)).long()
    bottom = (y + line_h)[:, None, None].expand(shape)
    inset_t, inset_b = _ri(g, 2, 8, shape, device), _ri(g, 2, 8, shape, device)
    v = (ink[:, None, None] - 255).expand(shape)
    outer = torch.stack([top, bottom, gx, gx + gw, v], -1)[ok]
    inner_y0, inner_y1 = top + inset_t, bottom - inset_b
    inner = torch.stack([inner_y0, torch.maximum(inner_y1, inner_y0), gx + 2, gx + gw - 2, -v], -1)[ok]
    rects += [outer, inner]

    textures = [(30, 1600, _ri(g, 0, 256, (10, 24), device))]   # header logo
    for _ in range(int(_ri(g, 1, 3, (), device))):
        bh, bw = int(_ri(g, 10, 30, (), device)), int(_ri(g, 14, 40, (), device))
        fy = int(_ri(g, 200, h - bh * _BLOCK - 10, (), device))
        fx = int(_ri(g, 100, w - bw * _BLOCK - 10, (), device))
        textures.append((fy, fx, _ri(g, 0, 256, (bh, bw), device)))
    return torch.cat(rects), textures, y[line_ok].tolist()


def _rasterise(rects: list[torch.Tensor], textures: list[list], hw, device) -> torch.Tensor:
    """[n, H, W] uint8 pages from their boxes (added to white through a
    difference array) and textures (pasted over), scaled from the design
    grid to ``hw``."""
    n, (h, w) = len(rects), hw
    sy, sx = h / DESIGN_HW[0], w / DESIGN_HW[1]
    diff = torch.zeros((n, h + 1, w + 1), dtype=torch.int32, device=device)
    rows = torch.cat([torch.full((r.shape[0],), i, dtype=torch.int64, device=device)
                      for i, r in enumerate(rects)])
    r = torch.cat(rects)
    y0 = torch.round(r[:, 0] * sy).long().clamp(0, h)
    y1 = torch.round(r[:, 1] * sy).long().clamp(0, h)
    x0 = torch.round(r[:, 2] * sx).long().clamp(0, w)
    x1 = torch.round(r[:, 3] * sx).long().clamp(0, w)
    val = r[:, 4].to(torch.int32)
    base = rows * (h + 1) * (w + 1)
    flat = diff.view(-1)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        flat.index_put_((base + yy * (w + 1) + xx,), val * sign, accumulate=True)
    pages = (255 + diff.cumsum(1).cumsum(2)[:, :h, :w]).clamp(0, 255).to(torch.uint8)
    for page, texs in zip(pages, textures):
        for fy, fx, blocks in texs:
            by, bx = max(1, round(_BLOCK * sy)), max(1, round(_BLOCK * sx))
            tex = blocks.to(torch.uint8).repeat_interleave(by, 0).repeat_interleave(bx, 1)
            y, x = round(fy * sy), round(fx * sx)
            tex = tex[:max(0, h - y), :max(0, w - x)]
            page[y:y + tex.shape[0], x:x + tex.shape[1]] = tex
    return pages


def lecture_pages(seed: int, n: int, hw=DESIGN_HW, device="cuda") -> tuple[torch.Tensor, list]:
    """[n, H, W] uint8 pages in ``make_deck``'s style, and each page's text
    line tops (design rows)."""
    out, tops = [], []
    for c0 in range(0, n, _CHUNK):
        rects, textures = [], []
        for p in range(c0, min(c0 + _CHUNK, n)):
            r, t, lines = _page_rects(seeds.generator(device, seed, seeds.PAGE, p), device)
            rects.append(r)
            textures.append(t)
            tops.append(lines)
        out.append(_rasterise(rects, textures, hw, device))
    return torch.cat(out), tops


def reveal_cuts(line_tops: list[int], reveals: int, h: int) -> list[int]:
    """Rows from which each member of a family is white: member j shows
    lines [0, 2 + round(j (n - 2) / (reveals - 1))) of the page's n, the
    last member the whole page."""
    n, sy = len(line_tops), h / DESIGN_HW[0]
    shown = [2 + round(j * (n - 2) / (reveals - 1)) for j in range(reveals - 1)]
    return [round(line_tops[k] * sy) if k < n else h for k in shown] + [h]


def make_deck(deck: dict, seed: int, device="cuda") -> torch.Tensor:
    """The deck a configuration names: ``{"kind": "lecture", "pages": n}``
    or ``{"kind": "reveal", "pages": n, "reveals": r}`` (n pages, each
    revealed line by line into r slides, page-major), at ``height`` x
    ``width``."""
    hw = (deck["height"], deck["width"])
    base, tops = lecture_pages(seed, deck["pages"], hw, device)
    if deck["kind"] == "lecture":
        return base
    if deck["kind"] != "reveal":
        raise ValueError(f"deck kind {deck['kind']!r}: expected 'lecture' or 'reveal'")
    r = deck["reveals"]
    slides = base.repeat_interleave(r, 0)
    cuts = torch.tensor([c for lines in tops for c in reveal_cuts(lines, r, hw[0])], device=device)
    rows = torch.arange(hw[0], device=device)
    return slides.masked_fill_(rows[None, :, None] >= cuts[:, None, None], 255)


def checksums(imgs: torch.Tensor) -> list[int]:
    """One number a page or frame of [n, H, W], to show that two processes
    hold the same arrays: the sum of its pixels weighted by their position
    mod 251."""
    flat = imgs.reshape(imgs.shape[0], -1)
    weight = torch.arange(flat.shape[1], device=imgs.device) % 251 + 1
    return [int((img.to(torch.int64) * weight).sum()) for img in flat]
