"""Per-stage times of the ORB match path on one CUDA card.

The port's counterpart of ``tools/profile_stages.py``: per-frame device
time of each stage of ``orb_matcher.match_frames`` on 1080p frames, from
CUDA events around each stage's calls for one batch, median over distinct
batches after a warm-up batch:

- pyramid: ``features.build_pyramid`` (f32 matmuls, bf16 atlas);
- FAST + NMS: per-frame K1 launches against one K2 launch for the batch
  (``cuda_fast.fast_score_map`` / ``fast_score_map_batch``);
- detect: the per-level quota top-k (``features.detect_from_scores``);
- describe at the first query bucket (768 slots), K3+K4;
- describe + table (``hamming.match_table_frame``; above 96 slides each
  frame is screened alone by the per-frame stage-1 rule,
  ``hamming.screen_slides_frame``, as the JAX package's ``match_frame``
  screens it, not by the batched rule that ``match_frames`` takes at the
  default settings);
- the full ``match_frames``.

The deck and the frames are synthetic, made from ``--seed`` with numpy:
slide-like pages (a title bar and word-sized dark boxes on white), and
frames that show them shifted by a few pixels with noise (an identical
copy would match nothing: a best distance of 0 keeps no match). Run from
the root of a checkout on a machine with a CUDA card and nvcc:

    python -m slideo_tpu_torch.tools.profile_stages --slides 64 --batch 8

A machine without a card fails: the times are device times.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SlideoConfig
from ..models import orb_matcher
from ..ops import cuda_fast, features, hamming

__all__ = ["synth_deck", "synth_frames", "profile", "main"]

FRAME_HW = (1080, 1920)
N_BATCHES = 4  # one warm-up batch, then the median of three


def synth_deck(rng: np.random.RandomState, n: int, hw: tuple[int, int] = FRAME_HW) -> np.ndarray:
    """[n, H, W] uint8 slide-like pages."""
    h, w = hw
    deck = np.full((n, h, w), 255, np.uint8)
    for page in deck:
        page[40:120, 60:60 + rng.randint(400, w // 2)] = rng.randint(0, 120)
        for _ in range(160):
            y, x = rng.randint(160, h - 40), rng.randint(40, w - 200)
            page[y:y + rng.randint(8, 30), x:x + rng.randint(10, 160)] = rng.randint(0, 160)
    return deck


def synth_frames(rng: np.random.RandomState, deck: np.ndarray, n: int) -> np.ndarray:
    """[n, H, W] uint8 frames: page i % S shifted by a few pixels, noise
    of sigma 3."""
    frames = np.empty((n, *deck.shape[1:]), np.uint8)
    for i in range(n):
        page = np.roll(deck[i % len(deck)], (1 + i % 5, 2 + i % 7), axis=(0, 1))
        noisy = page + rng.randn(*page.shape).astype(np.float32) * 3.0
        frames[i] = np.clip(np.rint(noisy), 0, 255).astype(np.uint8)
    return frames


def _timed(fn: Callable, inputs: Sequence) -> float:
    """Median ms of ``fn`` over ``inputs[1:]`` from CUDA events, after a
    warm-up call on ``inputs[0]``."""
    fn(inputs[0])
    torch.cuda.synchronize()
    times = []
    for x in inputs[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile(
    slides: np.ndarray,
    frames: np.ndarray,
    batch: int,
    cfg: SlideoConfig = DEFAULT_CONFIG,
    report: Callable[[str], None] = print,
) -> dict[str, float]:
    """Per-frame ms of each stage for ``slides`` [S, H, W] and batches of
    ``batch`` of ``frames`` [n, H, W] (uint8, n >= 2 * batch) on the
    current CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_stages measures device time and needs a CUDA card")
    n_in = min(N_BATCHES, len(frames) // batch)
    if n_in < 2:
        raise ValueError(f"profile_stages needs at least {2 * batch} frames, got {len(frames)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    orb, thr = cfg.orb, cfg.orb.fast_threshold
    hw = tuple(frames.shape[1:])
    chunks = (slides[c:c + 32] for c in range(0, len(slides), 32))
    index = orb_matcher.build_slide_index_from_chunks(chunks, cfg, dev)
    n_slides, k = index.pts.shape[0], index.pts.shape[1]
    meta = features.pyramid_meta(*hw, orb)
    q = orb.query_buckets[0]

    batches = [torch.from_numpy(frames[i * batch:(i + 1) * batch]).to(dev) for i in range(n_in)]
    seeds = [list(range(i * batch, (i + 1) * batch)) for i in range(n_in)]
    pyramid = lambda fr: [features.build_pyramid(f.to(torch.float32), orb) for f in fr]
    atlases = [pyramid(fr) for fr in batches]
    stacked = [torch.stack(a) for a in atlases]
    scores = [cuda_fast.fast_score_map_batch(s, thr) for s in stacked]
    kps = [[features.detect_from_scores(s, meta, orb) for s in sc] for sc in scores]

    def describe(inp):
        return [features.describe(a, meta, kp, q, orb) for a, kp in zip(*inp)]

    def describe_table(inp):
        for ft in describe(inp):
            hamming.match_table_frame(ft.desc, ft.score, index.desc_index, n_slides, k, cfg.match)

    stages = {
        "pyramid": (pyramid, batches),
        "fast_k1": (lambda atl: [cuda_fast.fast_score_map(a, thr) for a in atl], atlases),
        "fast_k2": (lambda st: cuda_fast.fast_score_map_batch(st, thr), stacked),
        "detect": (lambda sc: [features.detect_from_scores(s, meta, orb) for s in sc], scores),
        "describe": (describe, list(zip(atlases, kps))),
        "describe_table": (describe_table, list(zip(atlases, kps))),
        "match_frames": (
            lambda i: orb_matcher.match_frames(batches[i], seeds[i], index, hw, cfg),
            list(range(n_in)),
        ),
    }
    per_frame = {}
    for name, (fn, inputs) in stages.items():
        per_frame[name] = _timed(fn, inputs) / batch
        report(f"[profile] {name:15s} {per_frame[name]:9.4f} ms/frame")
    report(
        f"[profile] {n_slides} slides, batch {batch}, {hw[0]}x{hw[1]} frames on "
        f"{torch.cuda.get_device_name(0)}: K2 takes {per_frame['fast_k2']:.4f} ms/frame "
        f"against {per_frame['fast_k1']:.4f} with one K1 launch per frame"
    )
    return per_frame


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slides", type=int, default=500, help="slides in the synthetic deck")
    ap.add_argument("--batch", type=int, default=8, help="frames per batch")
    ap.add_argument("--seed", type=int, default=0, help="seed of the deck and the frames")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    deck = synth_deck(rng, args.slides)
    frames = synth_frames(rng, deck, N_BATCHES * args.batch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[profile] nvidia-smi: {smi}")
    profile(deck, frames, args.batch)


if __name__ == "__main__":
    main()
