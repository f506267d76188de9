"""The port's SIFT engine against the benchmark's plain SIFT reference
(``portbench/references/sift.py``), on the CPU at a small size.

1. ``MatchingEngine(engine="sift").match_samples`` on 8 perspective samples
   of a 6-page deck (270 x 480, ``FilmedStream`` of the ``perspective``
   mix: corners moved by up to 4% of the width) gives every frame the
   reference's dedup verdict and slide, and its similarity and rating
   within the tolerances below; the reference's TF32 control does not.
2. The reference imports nothing of the port, of the JAX package or of JAX
   (in a process of its own).
3. The traced run records one ``sift.features`` a matched frame, each
   octave's ``sift.detect`` and ``sift.describe`` inside it, and one span of
   each further matcher stage, inside ``match.dispatch``; the ORB matcher's
   stages keep their names.

The engine is cut as ``test_torch_sift_engine.py`` cuts it (256 keypoints
over 3 octaves, a border of 24 px), and verifies 4 candidates on a stride-4
grid: the plain sampling of 10 candidates at stride 2 costs about a second
a frame on one CPU thread.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.client import build_config  # noqa: E402
from portbench.lib import pages, spec  # noqa: E402
from portbench.lib.traffic import FilmedStream  # noqa: E402
from portbench.references import sift as sift_ref  # noqa: E402
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage  # noqa: E402
from slideo_tpu_torch.models import orb_matcher  # noqa: E402
from slideo_tpu_torch.utils.trace import StageTracer  # noqa: E402

torch.set_num_threads(1)

SEED = 2**31 + 2024
FRAMES = list(range(0, 96, 12))[:8]     # one sample of each of 8 dwells
N_OCTAVES = 3

# On the CPU the engine (K6h takes its plain version there) and the
# reference run the same float32 operations in the same order, and agreed
# to the last bit on every frame tried; a library that orders a sum
# otherwise (the table's products are cut into other chunks) may round a
# similarity near 0.9 apart by a few units of 6e-8, and push one keypoint
# over the contrast floor or the top-k's edge, which moves a rating by one
# inlier. A step down in precision (TF32 operands in the table and the
# blurs) moved the similarities by 1e-5 to 4e-4 and the ratings by up to 4.
SIM_TOL = 5e-6
RATING_TOL = 1.0


def _conf() -> tuple[dict, dict]:
    cell = spec.cell("sift64-perspective-x4")
    conf = cell["config"]
    conf["deck"].update(pages=6, height=270, width=480)
    conf["sift"].update(max_keypoints=256, n_octaves=N_OCTAVES, border=24)
    conf["match"].update(top_rated=4, verify_stride=4)
    return cell, conf


@pytest.fixture(scope="module")
def run():
    """The engine's traced answers and the reference's and the control's,
    on the same deck and samples."""
    cell, conf = _conf()
    deck = pages.make_deck(conf["deck"], SEED, "cpu")
    stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], SEED, 0)
    frames = stream.make(FRAMES, deck)
    objs = [PdfPage(Path("deck.pdf"), "deck", Path(f"p-{i + 1}.png"), i + 1) for i in range(len(deck))]
    engine = MatchingEngine(build_config(conf), objs, device="cpu", page_grays=deck.numpy())
    answers, orig = {}, engine.match_batch

    def match_batch(batch, seeds):
        res = orig(batch, seeds)
        for k, s, sim, r in zip(seeds, res.slide.tolist(), res.similarity.tolist(), res.rating.tolist()):
            answers[k] = dict(slide=s, similarity=sim, rating=r)
        return res

    engine.match_batch = match_batch
    tracer = StageTracer()
    engine.match_samples([(k, k * 5.0, f.numpy()) for k, f in zip(FRAMES, frames)],
                         total_ms=10**6, total_frames=10**3, tracer=tracer)

    def answer(ref):
        out = {}
        for i, k in enumerate(FRAMES):
            a = dict(changed=ref.changed(frames[i], None if i == 0 else frames[i - 1]))
            if a["changed"]:
                a.update(ref.match_frame(frames[i], k))
            out[k] = a
        return out

    return dict(answers=answers, tracer=tracer, deck=deck, frames=frames,
                truth=[stream.page(k) for k in FRAMES], ref=answer(sift_ref.Reference(conf, deck)),
                control=answer(sift_ref.Reference(conf, deck, control="tf32")))


def _gaps(prog: dict, ref: dict) -> list[tuple[float, float]]:
    return [(abs(prog[k]["similarity"] - ref[k]["similarity"]), abs(prog[k]["rating"] - ref[k]["rating"]))
            for k in FRAMES]


def test_the_engine_answers_as_the_reference(run):
    ref, prog = run["ref"], run["answers"]
    assert all(ref[k]["changed"] for k in FRAMES) and sorted(prog) == FRAMES   # every view passes the dedup
    assert [prog[k]["slide"] for k in FRAMES] == [ref[k]["slide"] for k in FRAMES] == run["truth"]
    for k, (sim_gap, rating_gap) in zip(FRAMES, _gaps(prog, ref)):
        assert sim_gap <= SIM_TOL and rating_gap <= RATING_TOL, (k, prog[k], ref[k])


def test_the_tf32_control_fails_a_tolerance(run):
    ctl, ref = run["control"], run["ref"]
    assert any(ctl[k]["slide"] != ref[k]["slide"] for k in FRAMES) or any(
        s > SIM_TOL or r > RATING_TOL for s, r in _gaps(ctl, ref)), (ctl, ref)


def test_the_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 3 * 2**-11), 3.0e-3, -7.5], dtype=torch.float32)
    got = sift_ref._tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-9), got[4].item(), -7.5]
    assert (got.view(torch.int32) & 0x1FFF == 0).all() and abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2**-11


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    code = (
        "import sys, torch; sys.path.insert(0, sys.argv[1]);"
        "from portbench.lib import check, pages, spec;"
        "from portbench.lib.traffic import FilmedStream;"
        "from portbench.references import sift;"
        "cell = spec.cell('sift64-perspective-x4'); conf = cell['config'];"
        "conf['deck'].update(pages=2, height=180, width=320);"
        "conf['sift'].update(max_keypoints=128, n_octaves=2, border=24);"
        "deck = pages.make_deck(conf['deck'], 5, 'cpu');"
        "img = FilmedStream(cell['traffic'], 12, conf['deck'], 5, 0).make([0], deck)[0];"
        "sift.Reference(conf, deck).match_frame(img, 0);"
        "found = check.forbidden_modules() + [m for m in sys.modules if m.split('.')[0] == 'slideo_tpu_torch'];"
        "print('found', found); sys.exit(1 if found else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _children(tracer: StageTracer, i: int) -> list:
    return [(j, s) for j, s in enumerate(tracer.spans) if s.parent == i]


SIFT_STAGES = ["sift.features", "sift.table", "sift.draws", "sift.lowe", "sift.homography", "sift.verify"]


def test_a_traced_run_records_the_sift_stages_inside_the_dispatch(run):
    tracer = run["tracer"]
    dispatches = [i for i, s in enumerate(tracer.spans) if s.name == "match.dispatch"]
    assert len(dispatches) == 1
    kids = _children(tracer, dispatches[0])
    names = [s.name for _, s in kids]
    for name in SIFT_STAGES:
        assert names.count(name) == len(FRAMES), (name, names)
    assert set(names) == set(SIFT_STAGES)
    for j, s in kids:
        inner = [c.name for _, c in _children(tracer, j)]
        if s.name == "sift.features":
            assert inner == ["sift.detect", "sift.describe"] * N_OCTAVES
        elif s.name == "sift.verify":
            assert inner == ["sync.pick"] * 3
        else:
            assert inner == []
        assert tracer.spans[dispatches[0]].start <= s.start <= s.end <= tracer.spans[dispatches[0]].end
    assert sum(s.name == "sift.features" for s in tracer.spans) == len(run["answers"])


def test_the_orb_matcher_keeps_its_stage_names(run):
    from slideo_tpu_torch import DEFAULT_CONFIG

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        orb=dataclasses.replace(DEFAULT_CONFIG.orb, n_features=200, max_keypoints=256, query_buckets=(128,),
                                edge_threshold=16, n_levels=4),
    )
    deck = run["deck"][:2]
    objs = [PdfPage(Path("deck.pdf"), "deck", Path(f"p-{i + 1}.png"), i + 1) for i in range(2)]
    engine = MatchingEngine(cfg, objs, device="cpu", page_grays=np.ascontiguousarray(deck.numpy()))
    tracer = StageTracer()
    orb_matcher.match_frames(run["frames"][:1], [FRAMES[0]], engine.index, engine.slide_hw, cfg, tracer)
    assert [s.name for s in tracer.spans if s.parent == -1] == [
        "match.detect", "sync.count", "match.describe", "match.table", "match.draws", "match.select",
        "match.ransac", "match.verify"]
