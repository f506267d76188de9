"""How ``correct`` is decided: the program's answers for a sample of the
frames decided in the window, drawn from the seed, against the plain
reference's, on the same pages and frames made again here from the seed.
The reference is the configuration's own (``spec.reference``: a module of
``portbench/references/``).

An answer is the dedup's verdict on the frame and, for a frame it passed
on, the slide the engine decided (or none) with the winner's verification
similarity and RANSAC rating. A frame's gap is 1 where the program's
verdict or slide differs from the reference's, else the difference of the
two similarities of the slide both decided (0 for a frame both dropped or
matched to no slide). The numbers a cell may compare, each against its
limit (``limits`` in ``workloads/<cell>.json``):

- ``answer_gap_median``: the median gap of the sampled frames, which a
  step down in precision moves where the dedup passes most frames on;
- ``slide_gap_median``: the median gap of the sampled frames on which the
  reference decided a slide, which a step down in precision moves where the
  dedup drops most frames (and ``answer_gap_median`` reads 0 either way);
- ``answer_gap_max``: the largest, which any wrong answer sets to 1;
- ``rating_answer_gap_max``: the largest gap where a frame's gap on a slide
  both decided is instead the difference of the two RANSAC ratings over the
  reference's (1 for a wrong answer, as above). It stands in for
  ``answer_gap_max`` where a frame is the slide's own pixels: the
  transform is then the identity to a thousandth of a pixel, so the
  verification grid's edge samples lie on the frame thumbnail's edge, and
  a translation of -0.004 px on one side alone moves them out of it, where
  they count as black (similarity 0.845 against 0.934 on one frame). The
  inlier count does not jump so, and a step down in precision still moves
  it: it loses about a fifth of the inliers.

``inputs_differ`` (pages or frames that differ from the clients' own, by
checksum) must be 0 whatever the limits. The other numbers are printed:
``answers_differ`` counts the frames of gap 1.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from . import pages, seeds, spec
from .traffic import NOISE, BLANK, FilmedStream

FORBIDDEN = ("jax", "jaxlib", "flax", "slideo_tpu")
WIDEST = ("answer_gap_max", "rating_answer_gap_max")   # a cell compares one: a wrong answer sets it to 1


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``slideo_tpu_torch`` is not ``slideo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sample(seed: int, client: int, first: int, last: int, n: int) -> list[int]:
    """``n`` of the frames [first, last] of a client, drawn from the seed."""
    rng = np.random.default_rng(seeds.mix(seed, seeds.SAMPLE, client))
    span = last - first + 1
    if span <= 0:
        return []
    return sorted(int(first + i) for i in rng.choice(span, size=min(n, span), replace=False))


def answer(ref, stream: FilmedStream, deck, k: int, first: int) -> dict:
    """The reference's answer for frame ``k`` of a stream whose first frame
    in the call was ``first``."""
    img = stream.make([k], deck)[0]
    prev = None if k == first else stream.make([k - 1], deck)[0]
    out = dict(changed=ref.changed(img, prev), img_sum=pages.checksums(img[None])[0], frame=k)
    if out["changed"]:
        out.update(ref.match_frame(img, k))
    return out


def numbers(pairs: list[tuple[dict, dict, int]]) -> dict:
    """The comparison's numbers over (program answer, reference answer,
    true slide) triples; an answer is {"changed", "slide", "similarity",
    "rating"} (slide etc. only when changed). ``worst`` lists the frames
    that differ, then those of the largest similarity gaps."""
    differ, gaps, slide_gaps, rating_gaps, rating_rel = 0, [], [], [], []
    truth_prog = truth_ref = 0
    kps, worst = [], []
    for prog, ref, truth in pairs:
        brief = lambda a: [a.get(k) for k in ("changed", "slide", "similarity", "rating")]  # noqa: E731
        if prog["changed"] != ref["changed"] or (ref["changed"] and prog["slide"] != ref["slide"]):
            differ += 1
            gap = rel = 1.0
        elif ref["changed"] and ref["slide"] >= 0:
            gap = abs(prog["similarity"] - ref["similarity"])
            rating_gaps.append(abs(prog["rating"] - ref["rating"]))
            rel = rating_gaps[-1] / max(ref["rating"], 1.0)
        else:
            gap = rel = 0.0
        rating_rel.append(rel)
        gaps.append(gap)
        if ref["changed"] and ref["slide"] >= 0:
            slide_gaps.append(gap)
        worst.append((gap, ref.get("frame"), truth, brief(prog), brief(ref)))
        if ref["changed"]:
            want = -1 if truth in (NOISE, BLANK) else truth
            truth_ref += ref["slide"] != want
            truth_prog += prog.get("slide") != want
            if truth >= 0:
                kps.append(ref["keypoints"])
    return dict(
        answer_gap_median=statistics.median(gaps) if gaps else 1.0,
        slide_gap_median=statistics.median(slide_gaps) if slide_gaps else 1.0,
        answer_gap_max=max(gaps, default=1.0),
        rating_answer_gap_max=max(rating_rel, default=1.0),
        answers_differ=differ,
        rating_gap_max=max(rating_gaps, default=0.0),
        compared=len(pairs), with_slide=len(slide_gaps), same_slide=len(rating_gaps),
        truth_errors_program=truth_prog, truth_errors_reference=truth_ref,
        min_slide_keypoints=min(kps, default=0),
        worst=sorted(worst, key=lambda w: -w[0])[:4],
    )


def compare(run, device: str) -> dict:
    """The verdict on a run: {"correct", "failed", "checks", "numbers"}."""
    import torch

    t0 = time.monotonic()
    cell, conf = run.cell, run.cell["config"]
    dev = torch.device(device)
    deck = pages.make_deck(conf["deck"], run.seed, dev)
    inputs_differ = sum(r["deck_sums"] != pages.checksums(deck) for r in run.reports)
    ref = spec.reference(conf)(conf, deck)
    t_index = time.monotonic() - t0
    pairs = []
    for c, rep in enumerate(run.reports):
        stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], run.seed, c)
        for k in sample(run.seed, c, rep["first"], rep["last"], cell["check_frames"]):
            r = answer(ref, stream, deck, k, rep["first"])
            inputs_differ += r["img_sum"] != rep["pool_sums"][k % stream.pool]
            changed = k in rep["rows"]
            prog = dict(changed=changed)
            if changed:
                slide, sim, rating = rep["answers"].get(k, (None, None, None))
                prog.update(slide=rep["rows"][k], similarity=sim, rating=rating)
            pairs.append((prog, r, stream.page(k)))
    del ref, deck
    nums = numbers(pairs)
    nums["inputs_differ"] = inputs_differ
    print(f"[portbench] reference: index {t_index:.3f} s, {len(pairs)} frames in "
          f"{time.monotonic() - t0 - t_index:.3f} s; numbers {nums}", file=sys.stderr, flush=True)
    checks = {name: {"value": nums[name], "limit": limit} for name, limit in cell["limits"].items()}
    checks["inputs_differ"] = {"value": inputs_differ, "limit": 0}
    return dict(correct=all(c["value"] <= c["limit"] for c in checks.values()),
                failed=nums["answers_differ"], checks=checks, numbers=nums)
