"""The SIFT configuration and its cell, ``sift64-perspective-x4``: the cell
resolves to ``references/sift.py``; ``build_config`` builds what
``configs/sift-lecture-64.json`` states; the ``perspective`` mix gives every
seed the same work and moves each page corner by up to 4% of the width;
the readers of the SIFT matcher's stages read them from a hand-made run and
give None without them (and the ORB matcher's readers give None on them);
on the card, the reference's TF32 control reads above the cell's limits."""

import pytest
import torch

from portbench.client import build_config
from portbench.lib import check, pages, spec
from portbench.lib.run_data import Run
from portbench.lib.traffic import BLANK, NOISE, FilmedStream
from portbench.references import sift

CELL = "sift64-perspective-x4"
SEEDS = [0, 1, 7, 2**31 - 1, 2**31 + 5, 123456789, 3**20, 2**40 + 17]


def test_the_cell_resolves_to_the_sift_reference():
    cell = spec.cell(CELL)
    assert cell["config"]["name"] == "sift-lecture-64" and cell["config"]["engine"] == "sift"
    assert spec.reference(cell["config"]) is sift.Reference
    assert (spec.ROOT / "references" / "sift.py").is_file()


def test_build_config_builds_what_the_file_states():
    """Every section as the file writes it: ``sift`` at the port's defaults,
    ``orb``, ``match`` and ``video`` as orb-lecture-64's; nothing reduced."""
    from slideo_tpu_torch.config import DEFAULT_CONFIG, MatchConfig, OrbConfig, SiftConfig, SlideoConfig, VideoConfig

    conf = spec.cell(CELL)["config"]
    orb_ = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["orb"].items()}
    want = SlideoConfig(engine="sift", sift=SiftConfig(**conf["sift"]), orb=OrbConfig(**orb_),
                        match=MatchConfig(**conf["match"]), video=VideoConfig(**conf["video"]))
    cfg = build_config(conf)
    assert cfg == want and cfg.sift == DEFAULT_CONFIG.sift
    lecture = build_config(spec.cell("orb64-filmed-x4")["config"])
    assert (cfg.orb, cfg.match, cfg.video) == (lecture.orb, lecture.match, lecture.video)
    assert conf["deck"] == {"kind": "lecture", "pages": 64, "height": 1080, "width": 1920}
    assert conf["reduced"] == []


def test_perspective_is_filmed_with_its_corners_moved():
    mix, filmed = spec.cell(CELL)["traffic"], spec.cell("orb64-filmed-x4")["traffic"]
    assert mix == dict(filmed, corner_frac=0.04)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_gives_the_same_samples_and_all_pass_the_dedup(seed):
    """The slide sequence's shape as in the filmed cells, and the port's
    dedup arithmetic (``MatchingEngine._dedup``) on one period and the
    pool's wrap, at a quarter of the size: every sample passes."""
    from slideo_tpu_torch.ops import image as image_ops

    cell = spec.cell(CELL)
    mix, video = cell["traffic"], cell["config"]["video"]
    deck_spec = dict(cell["config"]["deck"], height=270, width=480, pages=8)
    s = FilmedStream(mix, cell["dwell"], deck_spec, seed, seed % 4)
    per = mix["period"] - len(mix["no_slide"])
    seq = [s.page(k) for k in range(s.pool)]
    assert [k for k, p in enumerate(seq) if p == NOISE] == list(range(per, s.pool, mix["period"]))
    assert [k for k, p in enumerate(seq) if p == BLANK] == list(range(per + 1, s.pool, mix["period"]))
    slides = [p for p in seq if p >= 0]
    runs = [slides[i:i + cell["dwell"]] for i in range(0, len(slides), cell["dwell"])]
    assert len(slides) == s.pool // mix["period"] * per and all(len(set(r)) == 1 for r in runs)
    assert all(a[0] != b[0] for a, b in zip(runs, runs[1:]))

    deck = pages.make_deck(deck_spec, seed, "cpu")
    ks = list(range(s.period + 1)) + [s.pool - 1]
    small = image_ops.resize(s.make(ks, deck), image_ops.small_size(270, 480, video["small_image_area"]),
                             area=True)
    pairs = [(i - 1, i) for i in range(1, s.period + 1)] + [(len(ks) - 1, 0)]
    sims = image_ops.compute_similarity(small[[b for _, b in pairs]], small[[a for a, _ in pairs]], channels=1)
    assert bool((sims < video["dedup_similarity"]).all()), sims.max()


@pytest.mark.parametrize("seed", SEEDS)
def test_each_corner_moves_by_up_to_four_percent_of_the_width(seed):
    """The perspective alone (no rotation, scale or shift) takes each page
    corner to within 4% of the width of where it was, and far enough that
    the view is not an affine one."""
    cell = spec.cell(CELL)
    mix = dict(cell["traffic"], rotate_deg=0.0, scale=[1.0, 1.0], shift_px=0.0)
    d = cell["config"]["deck"]
    s = FilmedStream(mix, cell["dwell"], d, seed, 0)
    w, h = d["width"], d["height"]
    corners = torch.tensor([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype=torch.float64).T
    moved = []
    for k in range(0, 94, 7):
        page_to_frame = torch.linalg.inv(s._homography(k))
        p = page_to_frame @ corners
        moved.append((p[:2] / p[2] - corners[:2]).abs().max().item())
    assert max(moved) <= 0.04 * w + 1e-6 and max(moved) > 0.02 * w, moved


# ---- the readers of the SIFT matcher's stages ----------------------------------

# The stages of one matched frame, in ms: 4 octaves of detect and describe
# inside ``sift.features``, then the table, draws, Lowe, RANSAC and verify
# (with its three ``sync.pick``).
OCTAVE = [("sift.detect", 2.0), ("sift.describe", 3.0)]
CASCADE = [("sift.table", 4.0), ("sift.draws", 0.5), ("sift.lowe", 1.0), ("sift.homography", 6.0)]


def _frame(t: float, scale: float) -> tuple[list, float]:
    spans, now = [], t
    for name, ms in OCTAVE * 4:
        spans.append((name, now, now + ms * scale * 1e-3))
        now += ms * scale * 1e-3
    now += 1e-3 * scale                                   # the thumbnail
    spans.append(("sift.features", t, now))
    for name, ms in CASCADE:
        spans.append((name, now, now + ms * scale * 1e-3))
        now += ms * scale * 1e-3
    t0 = now
    for _ in range(3):
        spans.append(("sync.pick", now, now + 0.5 * scale * 1e-3))
        now += 0.5 * scale * 1e-3
    spans.append(("sift.verify", t0, now + 0.5 * scale * 1e-3))
    return spans, now + 0.5 * scale * 1e-3


def _batch(t: float, scale: float = 1.0) -> list:
    """A batch of 2 matched frames from ``t`` s, in its ``match.dispatch``."""
    spans, now = [], t
    for _ in range(2):
        frame, now = _frame(now, scale)
        spans += frame
    return spans + [("match.dispatch", t, now), ("match.fetch", now, now + 1e-3)]


def _run(keep=lambda name: True) -> Run:
    """Two clients; the window is 100-110 s and each profile starts at 104 s.
    Batches at 101, 102 and 103 s count; one before the window and one after
    the profile's start, ten times as long, do not."""
    reports = []
    for _ in range(2):
        spans = [s for t in (99.5, 101, 102, 103) for s in _batch(t)] + _batch(105, scale=10.0)
        reports.append(dict(spans=[s for s in spans if keep(s[0])], batch=2, profile=dict(start=104.0, stop=110.0)))
    return Run(cell={}, seed=1, seconds=10.0, t_start=100.0, t_run=90.0, ready=[], reports=reports)


WANT = {"sift_detect_ms_per_frame": 8.0, "sift_describe_ms_per_frame": 12.0, "float_table_ms_per_frame": 4.0,
        "homography_ms_per_frame": 7.5, "homography_verify_ms_per_frame": 2.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_sift_reader_counts_its_spans_before_the_profile(name):
    assert spec.metric_module(name).read(_run()) == pytest.approx(WANT[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_sift_reader_gives_none_without_its_spans(name):
    run = _run()
    for r in run.reports:
        del r["spans"]
    assert spec.metric_module(name).read(run) is None
    # A program that times the SIFT matcher as a whole (the engine's stages only).
    assert spec.metric_module(name).read(_run(lambda n: not n.startswith("sift."))) is None


@pytest.mark.parametrize("name", ["features_ms_per_frame", "table_ms_per_frame", "select_ms_per_frame",
                                  "ransac_ms_per_frame", "verify_ms_per_frame", "screen_ms_per_frame"])
def test_the_orb_readers_give_none_on_the_sift_stages(name):
    assert spec.metric_module(name).read(_run()) is None


# ---- the control, on the card ----------------------------------------------------

@pytest.mark.card
def test_the_tf32_control_is_not_correct(card):
    """The reference with TF32 operands in the table and the blurs, put in
    the program's place, at full frame size with a cut deck (16 pages), on
    24 frames of one client."""
    cell = spec.cell(CELL)
    conf = cell["config"]
    conf["deck"]["pages"] = 16
    seed = 2**31 + 99
    deck = pages.make_deck(conf["deck"], seed, card)
    ref, ctl = sift.Reference(conf, deck), sift.Reference(conf, deck, control="tf32")
    stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], seed, 0)
    pairs = []
    for k in check.sample(seed, 0, 128, 128 + 383, 24):
        r = check.answer(ref, stream, deck, k, 128)
        pairs.append((check.answer(ctl, stream, deck, k, 128), r, stream.page(k)))
    nums = check.numbers(pairs)
    assert any(nums[name] > limit for name, limit in cell["limits"].items()), nums
