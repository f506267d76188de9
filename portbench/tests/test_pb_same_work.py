"""Every seed gives the same work: as many samples a slide, no-slide
samples at the same positions; in filmed traffic every slide sample passed
on by the dedup and every slide frame far above the 768-keypoint query
bucket; in screen-recorded traffic every sample of a dwell its first
sample's pixels, and the same samples passed on. Held over 8 seeds at
reduced sizes, on the CPU, with the port's own dedup arithmetic and FAST
keypoints."""

import pytest
import torch

from portbench.lib import pages, spec
from portbench.lib.traffic import BLANK, NOISE, FilmedStream

SEEDS = [0, 1, 7, 2**31 - 1, 2**31 + 5, 123456789, 3**20, 2**40 + 17]
CELLS = ["orb500-filmed-x4", "orb64-filmed-x4", "orb64-screencap-x4"]


def _stream(cell_name, seed, client, hw, n_pages=None):
    cell = spec.cell(cell_name)
    deck = dict(cell["config"]["deck"], height=hw[0], width=hw[1])
    if n_pages:
        deck["pages"] = n_pages
    return cell, deck, FilmedStream(cell["traffic"], cell["dwell"], deck, seed, client)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_slides_dwell_alike_and_no_slide_samples_sit_alike(cell_name, seed):
    cell, deck, s = _stream(cell_name, seed, seed % 4, (1080, 1920))
    mix = cell["traffic"]
    per = mix["period"] - len(mix["no_slide"])
    seq = [s.page(k) for k in range(s.pool)]
    assert [k for k, p in enumerate(seq) if p == NOISE] == list(range(per, s.pool, mix["period"]))
    assert [k for k, p in enumerate(seq) if p == BLANK] == list(range(per + 1, s.pool, mix["period"]))
    slides = [p for p in seq if p >= 0]
    assert len(slides) == s.pool // mix["period"] * per
    runs = [slides[i:i + cell["dwell"]] for i in range(0, len(slides), cell["dwell"])]
    assert all(len(set(r)) == 1 for r in runs)               # one slide a dwell
    assert all(a[0] != b[0] for a, b in zip(runs, runs[1:]))  # and the next dwell another
    if deck["kind"] == "reveal":                               # members in reveal order
        r = deck["reveals"]
        fams = [slides[i:i + cell["dwell"] * r] for i in range(0, len(slides) - cell["dwell"] * r + 1,
                                                              cell["dwell"] * r)]
        for fam in fams:
            assert [p % r for p in fam[::cell["dwell"]]] == list(range(r))
            assert len({p // r for p in fam}) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_every_sample_passes_the_dedup(seed):
    """The port's dedup arithmetic (``MatchingEngine._dedup``) on one period
    and the pool's wrap, at a quarter of the size."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.ops import image as image_ops

    cell, deck_spec, s = _stream("orb500-filmed-x4", seed, 1, (270, 480), n_pages=8)
    deck = pages.make_deck(deck_spec, seed, "cpu")
    ks = list(range(s.period + 1)) + [s.pool - 1]
    frames = s.make(ks, deck)
    video = DEFAULT_CONFIG.video
    small = image_ops.resize(frames, image_ops.small_size(*frames.shape[1:], video.small_image_area), area=True)
    pairs = [(i - 1, i) for i in range(1, s.period + 1)] + [(len(ks) - 1, 0)]   # and pool[-1] -> pool[0]
    sims = image_ops.compute_similarity(small[[b for _, b in pairs]], small[[a for a, _ in pairs]], channels=1)
    assert bool((sims < video.dedup_similarity).all()), sims.max()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_sparsest_slide_frames_fill_the_large_query_bucket(seed):
    """The first member of a family (the header and two lines) at half
    the size still has far more than the 768 keypoints that would put it
    in the small bucket (about 1,500); at full size every member has its
    2000 (chip runs)."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.ops.features import build_pyramid, detect_pyramid, pyramid_meta

    cell, deck_spec, s = _stream("orb500-filmed-x4", seed, 2, (540, 960))
    r = deck_spec["reveals"]
    firsts = sorted((s.page(k), k) for k in range(s.pool) if s.page(k) >= 0 and s.page(k) % r == 0)
    ks = [firsts[0][1], next(k for p, k in firsts if p > firsts[0][0])]   # the two lowest families
    deck = pages.make_deck(dict(deck_spec, pages=max(s.page(k) for k in ks) // deck_spec["reveals"] + 1),
                           seed, "cpu")
    orb = DEFAULT_CONFIG.orb
    for img in s.make(ks, deck):
        img = img.to(torch.float32)
        atlas = build_pyramid(img, orb)
        count = int(detect_pyramid(atlas, pyramid_meta(*img.shape, orb), orb).valid.sum())
        assert count > 1.5 * orb.query_buckets[0], count


def _screencap(seed):
    """A screencap client's stream at a quarter of the size, its whole pool,
    and the pool positions of each dwell's samples, found from the slide
    sequence alone: runs of ``dwell`` slide samples, no-slide samples
    between them counting for none."""
    cell, deck_spec, s = _stream("orb64-screencap-x4", seed, seed % 4, (270, 480))
    deck = pages.make_deck(deck_spec, seed, "cpu")
    frames = s.make(list(range(s.pool)), deck)
    slide_ks = [k for k in range(s.pool) if s.page(k) >= 0]
    dwells = [slide_ks[i:i + cell["dwell"]] for i in range(0, len(slide_ks), cell["dwell"])]
    return cell, s, frames, dwells


@pytest.mark.parametrize("seed", SEEDS)
def test_screencap_samples_hold_their_dwell(seed):
    """Every sample of a dwell is byte-identical to the dwell's first, and no
    two dwells in a row show the same pixels."""
    _, s, frames, dwells = _screencap(seed)
    for dwell in dwells:
        assert all(torch.equal(frames[k], frames[dwell[0]]) for k in dwell[1:])
    assert all(not torch.equal(frames[a[0]], frames[b[0]]) for a, b in zip(dwells, dwells[1:]))


# A screencap pool of 384 = 4 periods of 94 slide samples: 32 dwells of 12
# (the last one 4 samples), 4 noise and 4 blank samples, and 3 samples after
# a blank that start no dwell (the fourth, the pool's wrap, starts one).
SCREENCAP_PASSED = 32 + 4 + 4 + 3


@pytest.mark.parametrize("seed", SEEDS)
def test_screencap_dedup_passes_dwell_starts_and_no_slide_samples(seed):
    """The port's dedup arithmetic (``MatchingEngine._dedup``) over the whole
    pool and its wrap passes on the first sample of each dwell, the noise
    and blank samples and the sample after each blank, and nothing else: as
    many samples for every seed."""
    from slideo_tpu_torch.ops import image as image_ops

    cell, s, frames, dwells = _screencap(seed)
    video = cell["config"]["video"]
    small = image_ops.resize(frames, image_ops.small_size(*frames.shape[1:], video["small_image_area"]),
                             area=True)
    prev = torch.roll(small, 1, dims=0)                  # pool[-1] before pool[0]
    changed = image_ops.compute_similarity(small, prev, channels=1) < video["dedup_similarity"]
    after_blank = {(k + 1) % s.pool for k in range(s.pool) if s.page(k) == BLANK}
    want = {d[0] for d in dwells} | {k for k in range(s.pool) if s.page(k) < 0} | after_blank
    assert set(torch.nonzero(changed)[:, 0].tolist()) == want
    assert len(want) == SCREENCAP_PASSED
