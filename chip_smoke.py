#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slideo_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py [--seed N]

Phases:

1. Environment: torch / CUDA versions, the card's name and power limit,
   TF32 off for f32 matmuls and convolutions.
2. Build: compiles slideo_tpu_torch/csrc/*.cu with nvcc into
   slideo_tpu_torch/_build/ (the library is reused while the sources are
   unchanged).
3. Each hand-written kernel against its plain PyTorch version on the card,
   at the shapes the match path gives it: K1 (bit-equal on a frame's atlas
   and on a corner-dense atlas, the pyramid of a uniform-noise frame, each
   with its candidate share and content-aware bound, and on an odd width,
   an unaligned view and a 7 x 9 image), K3+K4 (within the describe
   tolerance of its plain version on ``orb_cases``: a slide's 2048 slots
   and a frame's strongest 768 and 2048, the three timed shapes, and
   patches past the atlas's bottom and right edges, padded slots, odd and
   even origins, K = 1 and 37, an odd width and a 2-byte aligned view), K5
   (bit-equal at Q=768 and Q=2048 x 64 slides, and on an adversarial index
   made to break its tie rule, over all slides and over a slide list with
   repeated ids), K6
   (10 candidates at stride 2, one mapping partly outside the frame), K6h
   (K6's homography form: 10 perspective candidates at stride 2, one
   mapping partly outside, one whose denominator crosses zero inside the
   grid; timed against ``grid_sample`` on the same points), and the RANSAC
   kernel (``csrc/ransac.cu``) on the cascade's call for a frame's matches
   against the 64-slide deck (40 candidates x 512 match slots, 512 draws):
   ok, the winning hypotheses and ratings equal to the plain version's,
   the transform within 1e-3, every output bit-equal to ``ransac_replay``
   (a numpy replay of the kernel's arithmetic and sum order), and a second
   launch bit-identical. Every engine run below must launch it.
4. The exact-table path: a synthetic 64-slide 1080x1920 deck indexed by
   ``MatchingEngine``, 88 sampled 1080p frames (runs of warped slides,
   noise, blank) streamed through ``match_samples``, the timeline written
   to and read back from the SQLite store. It checks every run's slide and
   that every kernel of the path was launched by this run.
5. The screened path (decks above ``screen_above_slides`` = 96 slides): a
   500-slide 1080x1920 deck of near-duplicate families (100 pages, each
   revealed line by line into 5 slides) and 80 sampled frames (runs of
   adjacent family members, noise, blank), through the engine three
   times: screened (single-stage stage 1), exact (screening off) and with
   the strided pre-vote (``screen_prevote=True``). Each timeline is
   checked through the port's ``Db``; the screened and the pre-vote runs
   must assign every matched frame the exact run's slide; the screened
   run launched ``screen`` and ``table`` and no pre-vote form, the
   pre-vote run ``screen_strided``, ``screen_listed`` and ``table`` and
   not ``screen``. Then K5 mode (b) is held bit-equal to its plain version
   in its three forms (``screen_cases``): the single stage on 64 frames'
   stacked query prefixes, one frame's, a ragged last batch of 37 frames'
   (R = 9,472) and the 1,000 query prefixes of the adversarial index at
   K = 2048 and 1000; the strided form (stride 4) on each frame's 128
   strongest rows of 64, one and 37 frames and on the adversarial index
   (K = 1000 at stride 8); the listed form on 64 frames' rows against the
   64 slides the pre-vote lists for each, one frame, 37 frames, groups of
   200 and 300 rows and the adversarial index in 8 groups whose lists
   repeat a slide and name the one without a valid slot. The pre-vote's
   candidates of the 64 frames from the kernels equal those from the plain
   versions. Every case is timed; each form also at 64 frames and one frame
   beside its plain version (and ``torch._int_mm`` of the product alone at
   one frame). Last, K5 mode (a) bit-equal over a frame's 16 listed
   slides in both query buckets and over all 500 slides at Q=2048 (each
   timed).
6. The multi-device path, on every visible card or, with one card, on a
   mesh of two entries of ``cuda:0`` (it shows the path is right, not that
   it scales). (a) Frame DP: phase 4's deck and stream through
   ``MatchingEngine(..., mesh_devices=...)``; the timeline must equal
   phase 4's row for row. (b) Index parallel: phase 5's 500-slide index
   (the exact run's, not built again) split over a 1 x 2 ("frames",
   "index") mesh and ``match_frames_mesh`` on the exact run's matched
   frames (Q = 2048 against 250 slides x 2048 slots per shard): the
   gathered table is bit-equal to the table over all 500 slides, the
   assignments equal the exact run's, and one shard's table launch (the
   counterpart of the TPU table kernel's non-transposed mode, K5 (c)) is
   held bit-equal to and timed against its plain version.
7. K2: the batched FAST kernel on the 64 page atlases of phase 4's deck
   ([64, 3880, 1920] bf16) and on 8 corner-dense atlases, bit-equal to K1
   launches and to its plain version, timed against both; then the stage profile
   (``slideo_tpu_torch.tools.profile_stages``, batch 8) on that deck and
   the first 32 frames of phase 4's stream.
8. The SIFT engine (``SlideoConfig(engine="sift")``, default ``SiftConfig``:
   2048 keypoints over 5 octaves). (a) Phase 4's 64-slide deck and a stream
   of 12 runs x 2 frames, each a slide under a homography that moves each
   corner by up to 4% of the width, plus 2 noise and 2 blank runs, through
   ``match_samples`` and ``Db``: every warped run gets its page, noise and
   blank none, and the run launched ``warp_homography`` (K6h) and not
   ``warp``. (b) The first 250 slides of phase 5's reveal deck (50
   families) and 8 families x 3 adjacent members x 2 perspective frames
   plus noise and blank runs: the screened run (stage 1 by
   ``screen_slides_float``) and the exact run assign every frame the same
   slide. Each prints its frames/s and a per-stage split of
   ``match_frames_sift`` (features, table, select + RANSAC, verify) from
   CUDA events.
9. The index cache and the viewer, reusing the cold indexes of phases 4,
   5 and 8 (a): each deck's pages are written as PNG files (zlib and
   struct only) under a temporary TMPDIR, the cold index is saved under
   the pipeline's own key of those files by its own save function, and a
   warm ``MatchingEngine`` from the files must load it (its breakdown
   names a load, no build) with no kernel launched; the warm index must
   equal the cold one (ORB desc, valid and pts bit-equal; SIFT valid, pts
   and scale bit-equal, desc within 2^-11; thumbnails within 0.0625), and
   the cold run's frames through the warm engine must give its rows
   exactly (phase 5's 80 frames, screened). Prints each archive's MB, the
   cold extract_s, save_fetch_s, save_write_s and the warm read_s and
   upload_assemble_s beside the card's name and power limit. Then the
   viewer's server (``make_server``, port 0, in a thread, shut down in a
   ``finally``) over phase 4's store: ``/pdf-matchings/<hash>`` returns
   phase 4's rows in the JAX package's JSON shape, ``/files/<hash>`` with a
   ``Range`` header returns 206 and the bytes of a page file, ``/`` the
   port's index.html.
10. The per-frame stage-1 rule (``hamming.screen_slides_frame``, the JAX
   package's ``_screen_slides``), which ``match_frames`` takes where the
   JAX package does: at ``screen_bits`` other than 128 or a K that is not
   a multiple of 128. (a) Its prefix table against the plain version,
   bit-equal: K5 (b)'s prefix form on phase 5's 500 x 2048 index with one
   frame's 256 query rows (picked by raw score, as the rule picks them)
   and with 64 frames', at (slots, prefix bits) = (512, 128), (2048, 64)
   and (512, 64); on ``adversarial_table``'s index at K = 1000 at (512,
   128), (1000, 64), (333, 100) (a ragged last tile, a prefix padded to
   128) and K5 (a) over the first 512 slots at 200 bits. Each case prints
   call and device ms, plain ms, the bound and (but at 64 frames, whose
   product would not fit) ``torch._int_mm`` of the product alone.
   (b) ``MatchingEngine`` on phase 5's deck and frames twice: at
   ``screen_bits = 64`` (K = 2048) and at ``OrbConfig(max_keypoints=2000)``
   (K = 2000, the reference's feature count) with ``screen_k_per_slide =
   512``. Each run must launch ``screen_prefix`` and none of ``screen``,
   ``screen_strided`` and ``screen_listed``, and give every sampled frame
   the same candidates through the kernels as through the plain versions;
   it prints its frames/s and how many assignments differ from phase 5's
   exact run (not gated: the JAX package records that the trim loses
   recall, ``slideo_tpu/config.py:215-222``).

``python3 chip_smoke.py --profiler-check`` runs phases 1 and 2 and then
only the cross-check of the device-time method: K5's graph-replay device
ms against ``torch.profiler``'s kernel durations at Q=768 x 64 slides. It
is a separate run because an attached profiler slows every later launch
of the process.

``python3 chip_smoke.py --compare-fast SOURCE [SOURCE ...]`` runs phases 1
and 2 and then only times versions of ``csrc/fast.cu`` (the checked-in one
or edited copies keeping its two launchers) against each other in turns,
each held bit-equal to the plain version first.
``python3 chip_smoke.py --compare-screen SOURCE [SOURCE ...]`` does the
same for versions of ``csrc/screen.cu`` (each exporting ``slideo_screen``,
in the current signature or in the earlier single-stage one of 8
arguments) on a random index of phase 5's shape: ptxas's resources and
SASS counts, bit-equality on every K5 (b) case a version takes, device ms
at 64 frames and one frame and, for the current signature, of the
strided and listed forms at 64 frames.
``python3 chip_smoke.py --compare-orb SOURCE [SOURCE ...]`` does the same
for versions of ``csrc/orb.cu`` (the current launcher, or the earlier one
that takes patch origins): ptxas's resources and SASS counts, every K3+K4
case of ``orb_cases``, device ms at the three describe shapes.
``python3 chip_smoke.py --compare-ransac SOURCE [SOURCE ...]`` does the
same for versions of ``csrc/ransac.cu``: ptxas's resources and SASS
counts, then every case of ``ransac_cases`` (two frames' matches at C = 40
and C = 16, M = 512, H = 512; H = 256 and 1,200; C = 1; candidates with
one and no valid point; tied best counts; M = 2,048) held to the plain
version and bit for bit to ``ransac_replay``, and call, device, plain and
bound ms at C = 40 and C = 16.

Every path (phases 4, 5 screened and pre-vote, 6a, 6b, 7's profile, 8a,
8b screened and exact, 9's three warm runs, 10's two runs) runs with the
launch counts set to 0 just before it and read just after; a kernel's
``launches`` is its count summed over them, where the table launches of 6b
are K5 (c)'s and the others K5 (a)'s. Every kernel has two times: call
ms (``cuda_ms``: one wrapper call between two CUDA events, the wrapper's
host work included) and device ms (``device_ms``: N calls captured in a
CUDA graph and replayed between two events, divided by N), and so has the
library call beside it where there is one. Prints the kernel table as one
JSON line (each kernel's times, its plain version's call time, its bound
on an H100 SXM from this run's shapes and, where one PyTorch call computes
the same function, that call's times; K1 and K2 also carry the candidate
share of the input timed, and the same numbers on the corner-dense input
under ``dense``), then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.
Any failed check raises and exits nonzero; without a CUDA device it exits
nonzero before printing any result. Imports neither jax nor cv2, and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

FRAME_HW = (1080, 1920)
N_SLIDES = 64
RUN_LEN = 4          # sampled frames per run (the dedup drops repeats)
FPS, INTERVAL = 25, 5.0
SCREENED_PAGES, PER_FAMILY = 100, 5   # 500 slides: 100 pages x 5 reveals
SIFT_SLIDES = 250    # phase 8 (b): the first 50 pages' families of that deck

# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fns: dict, reps: int = 10) -> dict:
    """Median call time (ms) of each callable: one call between two CUDA
    events, so the wrapper's host work (checks, allocation, the ctypes call)
    is inside the window; in turns, after a warm-up call of each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def device_ms(fns: dict, call_ms: dict, reps: int = 7, window_ms: float = 2.0,
              max_n: int = 500) -> dict:
    """Median device time (ms) of one call of each callable, without the
    host's share: N calls captured in one CUDA graph, the graph replayed
    between two CUDA events, the time divided by N; in turns, after a
    warm-up replay of each. N starts at 20 (fewer for a callable whose call
    takes over 1 ms, ``call_ms``) and grows until a replay lasts
    ``window_ms``, up to ``max_n``. Every callable must be capturable: no
    host sync, no pageable host-to-device copy."""
    import torch

    def capture(fn, n: int):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        return graph

    def replay_ms(graph) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    graphs = {}
    for name, fn in fns.items():
        n = max(1, min(20, math.ceil(20.0 / call_ms[name])))
        graph = capture(fn, n)
        per = replay_ms(graph) / n
        if per * n < window_ms and n < max_n:
            n = min(max_n, math.ceil(window_ms / max(per, 1e-6)))
            del graph
            graph = capture(fn, n)
        graphs[name] = (graph, n)
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, (graph, n) in graphs.items():
            times[name].append(replay_ms(graph) / n)
    del graphs
    return {name: float(np.median(t)) for name, t in times.items()}


def profiler_device_ms(fn, kernel: str, n: int = 20) -> float | None:
    """Mean device time (ms) of the kernels whose name holds ``kernel`` in
    ``torch.profiler``'s trace of ``n`` calls, or None when the profiler
    records no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total / count / 1e3 if count and total else None


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by of a kernel that must move ``nbytes`` and do
    ``ops`` operations of type ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_row(name: str, source: str, replaces: str, err: float, ms: dict, dev: dict,
               cost: dict, **extra) -> dict:
    """A kernel's line of the JSON table: ``ms`` holds the call ms of the
    kernel, its plain version and the library call (if any), ``dev`` the
    device ms of the kernel and the library call; ``extra`` adds keys."""
    return dict(name=name, route="cuda", source=f"slideo_tpu_torch/csrc/{source}",
                replaces=replaces, launches=0, max_abs_err=err, ms=ms["kernel"],
                device_ms=dev["kernel"], plain_ms=ms["plain"], **cost,
                library_ms=ms.get("library"), library_device_ms=dev.get("library"), **extra)


def fast_bound(imgs, threshold: int) -> tuple[dict, float]:
    """The content-aware bound of K1 / K2 on a [H, W] atlas or a [B, H, W]
    batch, and its candidate share. Each pixel reads 2 bytes and writes 4,
    and takes the compass pretest (4 differences, 8 pair min/max, 2
    compares); only the candidates (``fast.compass_candidates``) need the
    score: 16 differences, 2 x 59 van Herk min/max, 1 max and 8 NMS
    compares. f32 operations."""
    from slideo_tpu_torch.ops import fast

    frames = imgs if imgs.dim() == 3 else imgs[None]
    n_px = frames.numel()
    n_cand = sum(int(fast.compass_candidates(f, threshold).sum()) for f in frames)
    return (bound(n_px * (2 + 4), n_px * (4 + 8 + 2) + n_cand * (16 + 2 * 59 + 1 + 8), "f32"),
            n_cand / n_px)


def fast_case(torch, label: str, atlas, threshold: int, smi: str) -> dict:
    """Hold K1 bit-equal to its plain version on ``atlas`` and time both;
    returns ``kernel_row``'s keyword arguments and the candidate share."""
    from slideo_tpu_torch.ops import cuda_fast

    got = cuda_fast.fast_score_map(atlas, threshold)
    want = cuda_fast.fast_score_map_plain(atlas, threshold)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got - want).abs().max())
    cost, share = fast_bound(atlas, threshold)
    print(f"[K1] {label} {tuple(atlas.shape)} {atlas.dtype}: corners {int((got > 0).sum())}, "
          f"candidate share {share:.4f}, bit-equal {same}, max_abs_err {err}")
    check(same, f"K1 FAST kernel is not bit-equal to its plain version ({label})")
    kernel = lambda: cuda_fast.fast_score_map(atlas, threshold)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": lambda: cuda_fast.fast_score_map_plain(atlas, threshold)})
    dev_ms = device_ms({"kernel": kernel}, ms)
    print(f"[time] fast_nms {label}: kernel call {ms['kernel']:.4f} ms, device {dev_ms['kernel']:.4f} "
          f"ms; plain {ms['plain']:.4f} ms; bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}) at "
          f"candidate share {share:.4f} ({smi})")
    return dict(err=err, ms=ms, dev=dev_ms, cost=cost, candidate_share=share)


def make_deck(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 1080, 1920] uint8 slides: white page, a title bar, lines of
    word-like boxes made of glyph-sized strokes of random ink, and one or
    two figures of blocky random texture."""
    h, w = FRAME_HW
    deck = np.full((n, h, w), 255, np.uint8)
    for page in deck:
        page[50:150, 80:80 + rng.randint(500, 1500)] = rng.randint(10, 120)
        y = 220
        while y < h - 90:
            x, line_h = 100 + rng.randint(0, 200), rng.randint(18, 40)
            ink = rng.randint(0, 140)
            while x < w - 200:
                for _ in range(rng.randint(2, 9)):           # glyphs of a word
                    gw = rng.randint(6, 16)
                    top = y + rng.randint(0, line_h // 3)
                    page[top:y + line_h, x:x + gw] = ink
                    page[top + rng.randint(2, 8):y + line_h - rng.randint(2, 8),
                         x + 2:x + gw - 2] = 255               # open glyph
                    x += gw + rng.randint(2, 5)
                x += rng.randint(14, 45)
            y += line_h + rng.randint(22, 70) + (rng.randint(40, 160) if rng.rand() < 0.2 else 0)
        for _ in range(rng.randint(1, 3)):
            bh, bw = rng.randint(10, 30), rng.randint(14, 40)
            tex = np.kron(rng.randint(0, 256, (bh, bw)), np.ones((12, 12), np.int64))
            fy, fx = rng.randint(200, h - tex.shape[0] - 10), rng.randint(100, w - tex.shape[1] - 10)
            page[fy:fy + tex.shape[0], fx:fx + tex.shape[1]] = tex
    return deck


def adversarial_table(seed: int, q: int = 1000, s: int = 24, k: int = 2048):
    """An index and queries made to break K5's tie rule (the first slot
    attaining the best score wins): (query [q, 256], desc [s, k, 256] int8
    +-1, valid [s, k] bool, slide list [C] int32).

    Every 7th query row is all zero, so every valid slot of every slide ties
    at 0. Query rows 3, 10, 17, ... are copied into several slots of one
    slide: the same lane's two slots, two lanes of a quad, the two slot
    halves of a 64-slot tile, a tile boundary, far tiles, slots listed in
    descending order; every third such copy marks the first slot invalid.
    Slide 1 has no valid slot, slide 2 none in its first half. q need not
    be a multiple of the 64-query tile (1000 is not), and the slide list
    repeats ids and lists the slide without a valid slot. ``tests`` holds
    the plain table on this index bit-equal to the JAX package's."""
    rng = np.random.RandomState(seed)
    desc = np.where(rng.rand(s, k, 256) > 0.5, 1, -1).astype(np.int8)
    valid = rng.rand(s, k) > 0.2
    query = np.where(rng.rand(q, 256) > 0.5, 1, -1).astype(np.int8)
    query[::7] = 0
    groups = [(0, 1), (2, 4), (8, 40), (31, 32), (63, 64), (5, 133, k - 1),
              (k - 1, k - 2), (100, 37), (k // 2 + 3, k // 2 + 2, 6)]
    for n, r in enumerate(range(3, q, 7)):
        sl = (5 * r) % s
        sl = 0 if sl == 1 else sl
        slots = list(groups[n % len(groups)])
        desc[sl, slots] = query[r]
        valid[sl, slots] = True
        if n % 3 == 2:
            valid[sl, slots[0]] = False
    valid[1] = False
    valid[2, :k // 2] = False
    cand = np.array([3, 1, 3, 0, 2, 2, s - 1, 1, 5, 3], np.int32) % s
    return query, desc, valid, cand


def adversarial_table_case(torch, dev, seed: int):
    """``adversarial_table`` on the card: (query, DescriptorIndex, S, K,
    slide list)."""
    from slideo_tpu_torch.ops import hamming

    query, desc, valid, cand = adversarial_table(seed)
    di = hamming.build_index(torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev))
    return (torch.from_numpy(query).to(dev), di, desc.shape[0], desc.shape[1],
            torch.from_numpy(cand).to(dev))


RANSAC_SOURCE = Path(__file__).resolve().parent / "slideo_tpu_torch/csrc/ransac.cu"


def ransac_constants(text: str) -> dict:
    """The block shapes of a version of csrc/ransac.cu: its ``constexpr
    int`` constants (HYP_WARPS, HYP_PER_WARP, REFINE_THREADS, ...)."""
    import re

    found = {k: v for k, v in re.findall(r"constexpr int (\w+) = (\d+|0x[0-9A-Fa-f]+);", text)}
    return {k: int(v, 0) for k, v in found.items()}


def ransac_replay(src, dst, valid, u, threshold: float, n_refine: int, consts: dict) -> dict:
    """A numpy float32 replay of csrc/ransac.cu on [C, M, 2] ``src`` /
    ``dst``, [C, M] ``valid`` and [C, H, 2] ``u``: pass 1's hypotheses,
    counts and per-block packed keys (``consts``: the source's block
    shapes), the decode of their max, and pass 2's refinements with each
    block sum in the kernel's order (each thread's points in turn, the
    warp's xor fold, the warp sums in warp order). Every float32 operation
    is the kernel's, rounded alike, so on the same inputs the replay gives
    the kernel's bits. Returns a, b, tx, ty, rating [C] float32, ok [C]
    bool, inliers [C, M] bool, winner and count [C] int (-1: none), and
    each scored hypothesis' count, counts [C, n_used] (-1: failed)."""
    f32 = np.float32
    src, dst, u = (np.asarray(x, f32) for x in (src, dst, u))
    valid = np.asarray(valid, bool)
    n_cand, m = valid.shape
    n_hyp = u.shape[1]
    used = min(max(n_hyp // 500, 1) * 500, n_hyp)
    per_block = consts["HYP_WARPS"] * consts["HYP_PER_WARP"]
    threads, top = consts["REFINE_THREADS"], consts["MAX_HYPOTHESES"]
    thr2, den_min = f32(float(threshold) ** 2), f32(1e-9)
    out = {k: np.zeros(n_cand, f32) for k in ("a", "b", "tx", "ty", "rating")}
    out.update(ok=np.zeros(n_cand, bool), inliers=np.zeros((n_cand, m), bool),
               winner=np.full(n_cand, -1), count=np.full(n_cand, -1),
               counts=np.zeros((n_cand, used), np.int64))
    lanes = np.arange(32)

    def block_sum(vals, take):
        acc = np.zeros(threads, f32)
        for j0 in range(0, m, threads):
            i = j0 + np.arange(threads)
            live = i < m
            i = np.minimum(i, m - 1)
            acc = np.where(live & take[i], acc + vals[i], acc)
        warps = acc.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            warps = warps + warps[:, lanes ^ off]
        total = warps[0, 0]
        for w in range(1, warps.shape[0]):
            total = f32(total + warps[w, 0])
        return total

    with np.errstate(all="ignore"):
        for c in range(n_cand):
            sx, sy, dx, dy, v = src[c, :, 0], src[c, :, 1], dst[c, :, 0], dst[c, :, 1], valid[c]
            n_valid = int(v.sum())

            def draw(x):
                return np.minimum((x * f32(n_valid)).astype(np.int32), max(n_valid - 1, 0))

            def fit_two(i0, i1):
                dpx, dpy = sx[i1] - sx[i0], sy[i1] - sy[i0]
                dqx, dqy = dx[i1] - dx[i0], dy[i1] - dy[i0]
                den = dpx * dpx + dpy * dpy
                den_c = np.where(den < den_min, den_min, den)
                a = (dqx * dpx + dqy * dpy) / den_c
                b = (dqy * dpx - dqx * dpy) / den_c
                return (a, b, dx[i0] - (a * sx[i0] - b * sy[i0]),
                        dy[i0] - (b * sx[i0] + a * sy[i0]), den > den_min)

            def inliers_of(a, b, tx, ty):
                a, b, tx, ty = (np.asarray(f, f32)[..., None] for f in (a, b, tx, ty))
                ex = ((a * sx - b * sy) + tx) - dx
                ey = ((b * sx + a * sy) + ty) - dy
                return ((ex * ex + ey * ey) < thr2) & v

            i0, i1 = draw(u[c, :used, 0]), draw(u[c, :used, 1])
            *hyp, fit_ok = fit_two(i0, i1)
            hyp_ok = fit_ok & (i0 != i1) & (n_valid >= 2)
            counts = out["counts"][c] = np.where(hyp_ok, inliers_of(*hyp).sum(-1), -1)
            keys = ((counts + 1) << 16) | (top - np.arange(used))
            block_keys = [keys[b0:b0 + per_block].max() for b0 in range(0, used, per_block)]
            key = max(block_keys, default=0)
            count, h = (key >> 16) - 1, top - (key & 0xFFFF)
            t = [f32(0)] * 4
            if count >= 0:
                t = [f32(f[0]) for f in fit_two(draw(u[c, h:h + 1, 0]), draw(u[c, h:h + 1, 1]))[:4]]
            found = count >= 2
            for _ in range(n_refine):
                inl = inliers_of(*t)
                s = [block_sum(x, inl) for x in (np.ones(m, f32), sx, sy, dx, dy)]
                wsum = s[0] if s[0] >= den_min else den_min
                pmx, pmy, qmx, qmy = (x / wsum for x in s[1:])
                pcx, pcy, qcx, qcy = sx - pmx, sy - pmy, dx - qmx, dy - qmy
                den = block_sum(pcx * pcx + pcy * pcy, inl)
                na = block_sum(qcx * pcx + qcy * pcy, inl)
                nb = block_sum(qcy * pcx - qcx * pcy, inl)
                if den > den_min and found:
                    a, b = na / den, nb / den
                    t = [a, b, qmx - (a * pmx - b * pmy), qmy - (b * pmx + a * pmy)]
            inl = inliers_of(*t) & found
            for k, f in zip(("a", "b", "tx", "ty"), t):
                out[k][c] = f
            out["rating"][c] = inl.sum()
            out["ok"][c], out["inliers"][c] = found, inl
            out["winner"][c], out["count"][c] = (h, count) if count >= 0 else (-1, -1)
    return out


def ransac_synthetic(seed: int, c: int, m: int):
    """Random RANSAC inputs (src, dst [c, m, 2] float32, valid [c, m] bool):
    each candidate's points under a similarity (rotation up to 10 degrees,
    scale 0.85-1.1, shift up to 30 px) with noise of sigma 0.7 px, up to
    half its valid points replaced by outliers, its valid points a prefix
    of random length; candidate 3 (where c > 3) has one valid point."""
    rng = np.random.RandomState(seed)
    src = (rng.rand(c, m, 2) * 400).astype(np.float32)
    dst = np.empty_like(src)
    n_valid = rng.randint(m // 4, m + 1, c)
    if c > 3:
        n_valid[3] = 1
    for i in range(c):
        th, sc = np.deg2rad(rng.uniform(-10, 10)), rng.uniform(0.85, 1.1)
        a, b = sc * np.cos(th), sc * np.sin(th)
        dst[i, :, 0] = a * src[i, :, 0] - b * src[i, :, 1] + rng.uniform(-30, 30)
        dst[i, :, 1] = b * src[i, :, 0] + a * src[i, :, 1] + rng.uniform(-30, 30)
        n_out = rng.randint(0, n_valid[i] // 2 + 1)
        dst[i] += rng.randn(m, 2).astype(np.float32) * 0.7
        dst[i, n_valid[i] - n_out:n_valid[i]] = rng.rand(n_out, 2) * 400
    valid = np.arange(m)[None, :] < n_valid[:, None]
    return src, dst, valid


def verify_transforms(torch, dev, t: int, seed: int = 7):
    """``t`` similarity transforms (full-res slide -> frame coords) like the
    ones RANSAC hands verification: rotation up to 3 degrees, scale 0.9-1.0,
    shifts up to 10 px; the last is shifted 700 px right, so part of its
    grid maps outside the frame."""
    from slideo_tpu_torch.ops import ransac

    rng = np.random.RandomState(seed)
    th = np.deg2rad(rng.uniform(-3, 3, t))
    sc = rng.uniform(0.9, 1.0, t)
    shift = rng.uniform(-10, 10, (2, t))
    shift[0, -1] = 700.0
    fields = (sc * np.cos(th), sc * np.sin(th), shift[0], shift[1])
    return ransac.Similarity(*(torch.from_numpy(f.astype(np.float32)).to(dev) for f in fields))


def warp(page: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The page as a camera/recording sees it: rotated up to 3 degrees,
    scaled 0.9-1.0, shifted a few pixels (float32, before noise)."""
    from scipy import ndimage

    th = np.deg2rad(rng.uniform(-3, 3))
    s = rng.uniform(0.9, 1.0)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    a = rot / s                                      # output -> input (row, col)
    c = np.array(FRAME_HW, np.float64) / 2
    t = rng.uniform(-6, 6, 2)
    offset = c - a @ (c + t)
    return ndimage.affine_transform(
        page.astype(np.float32), a, offset=offset, order=1, cval=230.0
    )


def with_noise(img: np.ndarray, rng: np.random.RandomState, sigma: float) -> np.ndarray:
    return np.clip(np.rint(img + rng.randn(*img.shape).astype(np.float32) * sigma), 0, 255).astype(np.uint8)


def regime(case: dict) -> dict:
    """A second input's numbers, as keys of a kernel row."""
    return dict(max_abs_err=case["err"], ms=case["ms"]["kernel"], device_ms=case["dev"]["kernel"],
                plain_ms=case["ms"]["plain"], **case["cost"], candidate_share=case["candidate_share"])


def phase_environment(torch) -> str:
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] device 0: {torch.cuda.get_device_name(0)}; devices: {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def phase_build() -> None:
    from slideo_tpu_torch import _kernels

    t0 = time.perf_counter()
    lib = _kernels.library()
    print(f"[build] {lib._name} in {time.perf_counter() - t0:.2f} s")


def phase_kernels(torch, deck: np.ndarray, frame: np.ndarray, seed: int, smi: str) -> list[dict]:
    """Each kernel against its plain version at main-path shapes."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import (cuda_orb, cuda_table, cuda_warp, features, image, ransac,
                                      verify)

    cfg = DEFAULT_CONFIG
    dev = torch.device("cuda")
    rows = []

    # K1: FAST + NMS on a 1080p frame's bf16 pyramid atlas, and on the
    # pyramid of a uniform-noise frame (corner-dense: most pixels pass the
    # pretest, so the scores bound the kernel, not the bytes).
    atlas = features.build_pyramid(torch.from_numpy(frame).to(dev).float(), cfg.orb)
    noise = np.random.RandomState(seed + 2).randint(0, 256, FRAME_HW).astype(np.uint8)
    dense = features.build_pyramid(torch.from_numpy(noise).to(dev).float(), cfg.orb)
    k1 = fast_case(torch, "K1 frame atlas", atlas, cfg.orb.fast_threshold, smi)
    k1["dense"] = regime(fast_case(torch, "K1 corner-dense atlas", dense, cfg.orb.fast_threshold, smi))
    rows.append(kernel_row("fast_nms", "fast.cu", "slideo_tpu/ops/pallas_fast.py:286", **k1))
    check_fast_edges(torch, dense, cfg.orb.fast_threshold, "csrc/fast.cu")
    del dense

    # K3+K4: describe, held to its plain version on every case of
    # ``orb_cases`` and timed at the main path's three shapes.
    slide_atlas = features.build_pyramid(torch.from_numpy(deck[0]).to(dev).float(), cfg.orb)
    cases, shapes = orb_cases(torch, slide_atlas, atlas, seed)
    err = check_orb(torch, cases, "csrc/orb.cu", cuda_orb.orb_describe)
    timed = {label: time_orb(torch, label, *shapes[label], smi, cuda_orb.orb_describe)
             for label in ORB_SHAPES}
    main = timed[ORB_SHAPES[0]]
    sub_row = lambda t: dict(ms=t["ms"]["kernel"], device_ms=t["dev"]["kernel"],  # noqa: E731
                             plain_ms=t["ms"]["plain"], **t["cost"])
    rows.append(kernel_row(
        "orb_describe", "orb.cu", "slideo_tpu/ops/pallas_orb.py:330", err, main["ms"], main["dev"],
        main["cost"], shape=ORB_SHAPES[0],
        frame_q768=dict(shape=ORB_SHAPES[1], **sub_row(timed[ORB_SHAPES[1]])),
        frame_q2048=dict(shape=ORB_SHAPES[2], **sub_row(timed[ORB_SHAPES[2]])),
    ))

    # K5: exact table, frame queries x 64 slides x 2048 slots, in both query
    # buckets of the match path (Q=768 and Q=max_keypoints=2048). The row
    # of the kernel table carries the Q=768 times.
    index = orb_matcher.build_slide_index(deck, cfg, dev)
    fmeta = features.pyramid_meta(*FRAME_HW, cfg.orb)
    fkps = features.detect_pyramid(atlas, fmeta, cfg.orb)
    di = index.desc_index
    n_slides, kps_per = index.pts.shape[0], index.pts.shape[1]
    k5_err, k5_ms, k5_dev = 0.0, {}, {}
    for q in (768, cfg.orb.max_keypoints):
        query = features.describe(atlas, fmeta, fkps, q, cfg.orb).desc.contiguous()
        k5_err = max(k5_err, check_table(torch, f"Q={q} x {n_slides} slides", query, di, n_slides, kps_per))
        k5_ms[q], k5_dev[q] = time_table(torch, f"Q={q} x {n_slides} slides", query, di, n_slides,
                                         kps_per, None, smi)
        if q == 768:
            # The int8 product alone (torch._int_mm, no mask, no max /
            # argmax): informational, not a library_ms.
            int_mm = {"int_mm": lambda: torch._int_mm(query, di.desc.T)}
            mm = device_ms(int_mm, cuda_ms(int_mm, reps=3))
            print(f"[time] torch._int_mm [{q}, 256] x [256, {n_slides * kps_per}]: device "
                  f"{mm['int_mm']:.4f} ms ({smi})")
    # Q=768: reads the index and the queries once, writes best + arg.
    n_idx = n_slides * kps_per
    rows.append(kernel_row(
        "match_table", "table.cu", "slideo_tpu/ops/pallas_table.py:143", k5_err, k5_ms[768],
        k5_dev[768], table_bound(768, n_slides, kps_per)))
    # The tie rule on an adversarial index, over all slides and a slide list.
    query, adv, n_adv, k_adv, cand = adversarial_table_case(torch, dev, seed=3)
    check_table(torch, "adversarial", query, adv, n_adv, k_adv)
    check_table(torch, "adversarial, slide list", query, adv, n_adv, k_adv, cand)

    # K6: verification sampling of a 1080p frame's thumbnail, 10 candidates
    # on the stride-2 grid of 1080p slides' thumbnails (the main path's
    # shapes: 10 x 30,030 points); the last candidate maps partly outside.
    small = image.to_small_image(torch.from_numpy(frame).to(dev).float()).contiguous()
    hs, ws = small.shape
    grid = verify.sample_grid((hs, ws), FRAME_HW, FRAME_HW, cfg.video.small_image_area,
                              cfg.match.verify_stride)
    tf = verify_transforms(torch, dev, 10)
    got = cuda_warp.warp_sample(small, tf, grid)
    want = verify.warp_sample_plain(small, tf, grid)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_pt = got.numel()
    print(f"[K6] image {tuple(small.shape)}, {got.shape[0]} candidates x {grid.out_h}x{grid.out_w} "
          f"points: max_abs_err {err}, {int((got != want).sum())} of {n_pt} points differ, "
          f"{int((want == 0).sum())} zero (outside) in the plain version, "
          f"{int((got == 0).sum())} in the kernel")
    check(err <= 1e-3, f"K6 warp kernel differs from its plain version by {err} > 1e-3")
    check(bool((want[-1] == 0).any()) and bool((want[-1] != 0).any()),
          "the last K6 candidate does not map partly outside the image")
    # The library yardstick: grid_sample (bilinear, zeros outside) on the
    # same points, made by the plain version outside the timing, in its
    # normalised coordinates (coordinate generation is excluded: this
    # favours the library).
    sxp, syp = verify.warp_coords(tf, grid, dev)
    img4 = small[None, None]
    gs_grid = torch.stack([sxp * (2.0 / (ws - 1)) - 1.0, syp * (2.0 / (hs - 1)) - 1.0],
                          dim=-1).reshape(1, -1, grid.out_w, 2)
    library = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        img4, gs_grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    lib = library().reshape(got.shape)
    inb = (sxp >= 0) & (sxp <= ws - 1) & (syp >= 0) & (syp <= hs - 1)
    print(f"[K6] grid_sample vs kernel on the {int(inb.sum())} points inside the image: "
          f"max_abs_diff {float((lib - got)[inb].abs().max())} (outside, the kernel gives 0 "
          "and grid_sample blends the border taps)")
    kernel = lambda: cuda_warp.warp_sample(small, tf, grid)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": lambda: verify.warp_sample_plain(small, tf, grid),
                  "library": library})
    dev_ms = device_ms({"kernel": kernel, "library": library}, ms)
    # Reads the thumbnail once and 16 B of transform per candidate, writes
    # one value per point; ~12 f32 operations per point to form it and ~20
    # to sample it (clips, tent weights, 4 multiply-adds).
    rows.append(kernel_row(
        "warp_sample", "warp.cu", "slideo_tpu/ops/pallas_warp.py:86", err, ms, dev_ms,
        bound(small.numel() * 4 + 16 * got.shape[0] + 4 * n_pt, 32 * n_pt, "f32")))
    rows.append(k6h_case(torch, small, grid, smi))

    # RANSAC: the cascade's call on this frame's matches (40 candidates x
    # 512 match slots, 512 draws), held to the plain version and the
    # replay, and timed.
    src, dst, valid = ransac_inputs(torch, index, [frame], cfg)[0]
    args = (src, dst, valid, ransac.uniform_draws(src.shape[0], cfg.match, seed, dev))
    err = check_ransac(torch, RANSAC_TIMED[0], args, ransac_constants(RANSAC_SOURCE.read_text()),
                       "csrc/ransac.cu")
    timed = time_ransac(torch, RANSAC_TIMED[0], args, smi)
    rows.append(kernel_row(
        "ransac_similarity", "ransac.cu",
        "none: the JAX package leaves ransac_similarity to XLA (slideo_tpu/ops/ransac.py:106)", err,
        timed["ms"], timed["dev"], timed["cost"], shape=RANSAC_TIMED[0]))
    for r in rows:
        print_row(r, smi)
    return rows


ORB_SHAPES = ("slide atlas K=2048", "frame atlas Q=768", "frame atlas Q=2048")


def orb_cases(torch, slide_atlas, frame_atlas, seed: int):
    """K3+K4's inputs (atlas, (y, x, level, level table)): the cases it is
    held to its plain version on, as (label, atlas, inputs), and the main
    path's three shapes by ``ORB_SHAPES`` label. The shapes: the 2048 slots
    of a slide's pyramid atlas (index build) and the strongest 768 and 2048
    of a frame's (``features.strongest``, the two query buckets). The other
    cases: keypoints of levels that run past the atlas's bottom and right
    edges; padded slots (y = x = level 0) after 40 real ones; random
    keypoints over the pyramid's levels, whose origins take both parities
    in y and x; K = 1 and K = 37; an odd-width crop [400, 1001]; and a
    [400, 640] view one pixel into the atlas, whose ``data_ptr`` is only
    2-byte aligned."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.ops import cuda_orb, features

    cfg = DEFAULT_CONFIG.orb
    dev = frame_atlas.device
    rng = np.random.RandomState(seed + 5)
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)  # noqa: E731
    meta = features.pyramid_meta(*FRAME_HW, cfg)
    table = features._level_tables(meta, cfg, dev)[0]

    def of(kps):
        return kps.y.contiguous(), kps.x.contiguous(), kps.level.contiguous(), table

    def scattered(n: int, levels: np.ndarray):
        """n keypoints uniform over the levels (columns of a level table)."""
        lv = rng.randint(0, levels.shape[1], n)
        y = (rng.rand(n) * levels[2, lv]).astype(np.int32)
        x = (rng.rand(n) * levels[3, lv]).astype(np.int32)
        return i32(y), i32(x), i32(lv), i32(levels)

    slide_kps = features.detect_pyramid(slide_atlas, meta, cfg)
    frame_kps = features.detect_pyramid(frame_atlas, meta, cfg)
    shapes = {
        ORB_SHAPES[0]: (slide_atlas, of(slide_kps)),
        ORB_SHAPES[1]: (frame_atlas, of(features.strongest(frame_kps, 768))),
        ORB_SHAPES[2]: (frame_atlas, of(features.strongest(frame_kps, cfg.max_keypoints))),
    }
    ha, wa = frame_atlas.shape
    # columns: the whole atlas; a corner level smaller than a patch; a strip
    # along the bottom; a strip along the right edge
    edges = np.array([[0, ha - 40, ha - 20, 100], [0, wa - 50, 100, wa - 10],
                      [ha, 40, 20, 300], [wa, 50, 300, 10]], np.int32)
    y, x, lv, _ = of(features.strongest(frame_kps, 768))
    zeros = torch.zeros(24, dtype=torch.int32, device=dev)
    padded = (torch.cat([y[:40], zeros]), torch.cat([x[:40], zeros]),
              torch.cat([lv[:40], zeros]), table)
    levels = table.cpu().numpy()
    odd = frame_atlas[:400, :1001].contiguous()
    view = frame_atlas.flatten()[1:1 + 400 * 640].view(400, 640)
    check(view.data_ptr() % 4 == 2, "the unaligned K3+K4 view is 4-byte aligned")
    one_level = lambda h, w: np.array([[0], [0], [h], [w]], np.int32)  # noqa: E731
    cases = [(label, *shapes[label]) for label in ORB_SHAPES] + [
        ("edges", frame_atlas, scattered(256, edges)),
        ("padded slots", frame_atlas, padded),
        ("random over levels", frame_atlas, scattered(512, levels)),
        ("K=1", frame_atlas, tuple(t[:1] for t in (y, x, lv)) + (table,)),
        ("K=37", frame_atlas, tuple(t[:37] for t in (y, x, lv)) + (table,)),
        ("odd width", odd, scattered(300, one_level(*odd.shape))),
        ("2-byte aligned view", view, scattered(300, one_level(*view.shape))),
    ]
    y0, x0 = cuda_orb.level_origins(*cases[3][2])
    check(bool((y0 + 63 > ha).any()) and bool((x0 + 63 > wa).any()),
          "no K3+K4 edge case patch runs past the atlas's bottom and right edges")
    y0, x0 = cuda_orb.level_origins(*cases[5][2])
    check(all(bool(((o % 2) == p).any()) for o in (y0, x0) for p in (0, 1)),
          "the K3+K4 random case lacks an odd or an even origin")
    return cases, shapes


def check_orb(torch, cases: list, tag: str, describe) -> float:
    """Hold ``describe`` (``orb_describe``'s signature) to the plain version
    on every case: bins equal on >= 99.9% of keypoints, bits on >= 99.5%,
    none of the bits whose two samples differ by more than 1.5 flipped.
    Returns the largest |kernel - plain| of a descriptor entry."""
    from slideo_tpu_torch.ops import cuda_orb

    err = 0.0
    for label, atlas, args in cases:
        desc, bins = describe(atlas, *args)
        pdesc, pbins, vals = cuda_orb.orb_describe_plain(atlas, *args, return_values=True)
        torch.cuda.synchronize()
        bin_ok = bins == pbins
        bit_ok = desc == pdesc
        big_bad = int((~bit_ok & ((vals[:, 256:] - vals[:, :256]).abs() > 1.5)).sum())
        bin_rate, bit_rate = float(bin_ok.float().mean()), float(bit_ok.float().mean())
        err = max(err, float((desc.float() - pdesc.float()).abs().max()))
        print(f"[K3+K4] {tag} {label}: atlas {tuple(atlas.shape)}, K={bins.shape[0]}: bins equal "
              f"{bin_rate:.6f}, bits equal {bit_rate:.6f}, margin>1.5 disagreements {big_bad}")
        for i in torch.nonzero(~bin_ok).flatten().tolist():
            print(f"[K3+K4]   bin differs at slot {i}: kernel {int(bins[i])} plain {int(pbins[i])}")
        check(bin_rate >= 0.999, f"K3+K4 ({tag}, {label}) bins agree on {bin_rate} < 0.999")
        check(bit_rate >= 0.995, f"K3+K4 ({tag}, {label}) bits agree on {bit_rate} < 0.995")
        check(big_bad == 0, f"K3+K4 ({tag}, {label}) {big_bad} bits with margin > 1.5 disagree")
    return err


def orb_bound(torch, atlas, args) -> dict:
    """K3+K4's bound on ``args``: it reads the atlas pixels its patches cover,
    12 B of keypoint and the packed tables of the bins it uses (36 B a
    sample), writes 256 bits and a bin per keypoint; per keypoint ~4 f32
    operations a patch pixel for the moments and 512 samples of 64
    multiply-adds for the bits."""
    from slideo_tpu_torch.ops import cuda_orb

    y0, x0 = cuda_orb.level_origins(*args)
    k = y0.shape[0]
    marks = torch.zeros((1, 1, atlas.shape[0] + 62, atlas.shape[1] + 62), device=atlas.device)
    marks[0, 0, (y0 + 62).clamp(0, marks.shape[2] - 1).long(),
          (x0 + 62).clamp(0, marks.shape[3] - 1).long()] = 1.0
    covered = int(torch.nn.functional.max_pool2d(marks, 63, stride=1).sum())
    n_bins = int(torch.unique(cuda_orb.orb_describe_plain(atlas, *args)[1]).numel())
    return bound(covered * 2 + k * (12 + 256 + 4) + n_bins * 512 * 36,
                 k * (4 * 63 * 63 + 512 * 64 * 2), "f32")


def time_orb(torch, label: str, atlas, args, smi: str, describe, plain: bool = True) -> dict:
    """Call ms of ``describe`` (and of the plain version), device ms of
    ``describe``, and the bound, on one input."""
    from slideo_tpu_torch.ops import cuda_orb

    fns = {"kernel": lambda: describe(atlas, *args)}
    if plain:
        fns["plain"] = lambda: cuda_orb.orb_describe_plain(atlas, *args)
    ms = cuda_ms(fns)
    dev = device_ms({"kernel": fns["kernel"]}, ms)
    cost = orb_bound(torch, atlas, args)
    pl = f"; plain {ms['plain']:.4f} ms" if plain else ""
    print(f"[time] orb_describe {label} (K={args[0].shape[0]}): kernel call {ms['kernel']:.4f} ms, "
          f"device {dev['kernel']:.4f} ms{pl}; bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}) "
          f"({smi})")
    return dict(ms=ms, dev=dev, cost=cost)


def orb_tile(text: str) -> tuple:
    """``cuda_orb.TILE`` of a version of csrc/orb.cu, from its PITCH and
    COPY1 constants (no COPY1: an f32 tile of that pitch)."""
    import re

    pitch = int(re.search(r"constexpr int PITCH = (\d+);", text).group(1))
    copy1 = re.search(r"constexpr int COPY1 = PATCH \* PITCH \+ (\d+);", text)
    return ("bf16", pitch, 63 * pitch + int(copy1.group(1))) if copy1 else ("f32", pitch, 0)


# C signature of the describe launcher before the kernel formed its patch
# origins: atlas, h, w, y0, x0, k, a_start, a_w, d_start, d_w, bins,
# out, stream.
_P, _I = "p", "i"
ORIGINS_SIGNATURE = (_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P)


def origins_describe(torch, lib):
    """``orb_describe``'s signature over a library whose launcher takes
    patch origins and the compact f32 tables (``ORIGINS_SIGNATURE``): the
    origins of each input are formed once, outside any timing, as that
    launcher's callers did."""
    from slideo_tpu_torch.ops import cuda_orb

    tables = [torch.from_numpy(t).to("cuda")
              for t in cuda_orb._patch_tables(256, 0x51DE0, 7, 2.0)[2:]]
    origins = {}

    def describe(atlas, y, x, level, table):
        key = (y.data_ptr(), x.data_ptr(), level.data_ptr(), table.data_ptr(), y.shape[0])
        if key not in origins:
            origins[key] = cuda_orb.level_origins(y, x, level, table)
        y0, x0 = origins[key]
        k = y0.shape[0]
        desc = torch.empty((k, 256), dtype=torch.int8, device=atlas.device)
        bins = torch.empty((k,), dtype=torch.int32, device=atlas.device)
        rc = lib.slideo_orb_describe(atlas.data_ptr(), *atlas.shape, y0.data_ptr(), x0.data_ptr(), k,
                                     *(t.data_ptr() for t in tables), bins.data_ptr(),
                                     desc.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the origins-form describe launcher failed: cudaError {rc}")
        return desc, bins

    return describe


def phase_compare_orb(torch, sources: list[str], seed: int, smi: str) -> None:
    """Versions of csrc/orb.cu side by side: each source (exporting
    ``slideo_orb_describe``, in the current C signature or in the earlier
    one that takes patch origins, ``ORIGINS_SIGNATURE``) is built into a
    library of its own; ptxas's registers, spills and shared memory and the
    SASS counts of LDS (and its 64- and 128-bit forms), LDGSTS, UTMALDG,
    FFMA, BAR and SHFL are printed. On a slide and a warped frame of a
    synthetic deck, each version is held to the plain version on every case
    of ``orb_cases`` and timed at the three ``ORB_SHAPES``, in turns,
    forwards then backwards. A version's tables follow its tile
    (``orb_tile``)."""
    import ctypes

    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import cuda_orb, features

    ctype = {_P: ctypes.c_void_p, _I: ctypes.c_int}
    libs = {}
    for src in sources:
        text = Path(src).read_text()
        origins = "const void* y0" in text
        sig = {"slideo_orb_describe": tuple(ctype[c] for c in ORIGINS_SIGNATURE)} if origins else None
        lib, resources, ops = compare_library(src, len(libs), ("slideo_orb_describe",), sig)
        lds = lambda width: sum(n for op, n in ops.items()  # noqa: E731
                                if op.startswith("LDS.") and op.endswith(f".{width}"))
        print(f"[compare] {src}: {resources}; {sass_total(ops)} SASS instructions, LDS "
              f"{ops['LDS']} (64-bit {lds(64)}, 128-bit {lds(128)}), " + ", ".join(
                  f"{op} {ops[op]}" for op in ("LDGSTS", "UTMALDG", "FFMA", "BAR", "SHFL")))
        libs[src] = (lib, None if origins else orb_tile(text))
    rng = np.random.RandomState(seed)
    pyramid = lambda img: features.build_pyramid(  # noqa: E731
        torch.from_numpy(img).to("cuda").float(), DEFAULT_CONFIG.orb)
    deck = make_deck(rng, 2)
    cases, shapes = orb_cases(torch, pyramid(deck[0]),
                              pyramid(with_noise(warp(deck[1], rng), rng, 1.5)), seed)
    times = {src: {label: [] for label in ORB_SHAPES} for src in sources}
    tile = cuda_orb.TILE
    try:
        for turn, names in enumerate((sources, sources[::-1])):
            for src in names:
                lib, src_tile = libs[src]
                if src_tile is None:
                    describe = origins_describe(torch, lib)
                else:
                    _kernels._lib, cuda_orb.TILE, describe = lib, src_tile, cuda_orb.orb_describe
                print(f"[compare] {src}, turn {turn}, tile {src_tile}")
                check_orb(torch, cases, src, describe)
                for label in ORB_SHAPES:
                    t = time_orb(torch, f"{src} {label}", *shapes[label], smi, describe, plain=False)
                    times[src][label].append(t["dev"]["kernel"])
    finally:
        _kernels._lib, cuda_orb.TILE = None, tile
    for src in sources:
        print(f"[compare] {src}: device ms " + "; ".join(
            f"{label} {min(t):.4f}-{max(t):.4f}" for label, t in times[src].items()) + f" ({smi})")


def homography_params(torch, dev, t: int, seed: int = 7):
    """[t, 8] homographies (full-res slide -> frame coords) like the ones
    RANSAC hands the SIFT engine's verification: ``verify_transforms``'
    similarities with a perspective row of up to 2e-5 per px (a corner of a
    1920-wide slide moved by about 4% of the width). The last is shifted
    700 px right, so part of its grid maps outside the frame; the one
    before it has h6 = -1/1000, so its denominator w crosses zero at
    x = 1000, inside the grid."""
    sim = verify_transforms(torch, dev, t, seed)
    rng = np.random.RandomState(seed + 100)
    persp = rng.uniform(-2e-5, 2e-5, (t, 2))
    persp[-2] = (-1e-3, 0.0)
    h = np.stack([
        sim.a.cpu().numpy(), -sim.b.cpu().numpy(), sim.tx.cpu().numpy(),
        sim.b.cpu().numpy(), sim.a.cpu().numpy(), sim.ty.cpu().numpy(),
        persp[:, 0], persp[:, 1],
    ], axis=1).astype(np.float32)
    return torch.from_numpy(h).to(dev)


def k6h_case(torch, small, grid, smi: str) -> dict:
    """K6h (``warp_sample_homography``) against its plain version and
    ``grid_sample`` on 10 homographies at the main path's shapes; returns
    its kernel row."""
    from slideo_tpu_torch.ops import cuda_warp, verify

    hs, ws = small.shape
    hp = homography_params(torch, small.device, 10)
    got = cuda_warp.warp_sample_homography(small, hp, grid)
    want = verify.warp_sample_homography_plain(small, hp, grid)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    sxp, syp = verify.warp_coords_homography(hp, grid, small.device)
    inb = (sxp >= 0) & (sxp <= ws - 1) & (syp >= 0) & (syp <= hs - 1)
    gx = ((torch.arange(grid.out_w, device=small.device) * grid.stride + 0.5) * grid.sx - 0.5)
    w_row = hp[-2, 6] * gx + 1.0
    n_pt = got.numel()
    print(f"[K6h] image {tuple(small.shape)}, {got.shape[0]} homographies x {grid.out_h}x{grid.out_w} "
          f"points: max_abs_err {err}, {int((got != want).sum())} of {n_pt} points differ, "
          f"{int((~inb).sum())} outside (kernel nonzero there: {int((got[~inb] != 0).sum())}, "
          f"plain: {int((want[~inb] != 0).sum())}); candidate 9 has w <= 0 on "
          f"{int((w_row <= 0).sum())} of {grid.out_w} grid columns")
    check(err <= 1e-3, f"K6h warp kernel differs from its plain version by {err} > 1e-3")
    check(bool((got[~inb] == 0).all()) and bool((want[~inb] == 0).all()),
          "K6h: a point outside the image is not 0")
    check(bool((~inb[-1]).any()) and bool(inb[-1].any()),
          "the last K6h candidate does not map partly outside the image")
    check(bool((w_row <= 0).any()) and bool((w_row > 0).any()),
          "the K6h candidate with h6 = -1/1000 does not cross w = 0 inside the grid")
    gs_grid = torch.stack([sxp * (2.0 / (ws - 1)) - 1.0, syp * (2.0 / (hs - 1)) - 1.0],
                          dim=-1).reshape(1, -1, grid.out_w, 2)
    img4 = small[None, None]
    library = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        img4, gs_grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    lib = library().reshape(got.shape)
    print(f"[K6h] grid_sample vs kernel on the {int(inb.sum())} points inside the image: "
          f"max_abs_diff {float((lib - got)[inb].abs().max())}")
    kernel = lambda: cuda_warp.warp_sample_homography(small, hp, grid)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": lambda: verify.warp_sample_homography_plain(small, hp, grid),
                  "library": library})
    dev_ms = device_ms({"kernel": kernel, "library": library}, ms)
    # Reads the thumbnail once and 32 B of homography per candidate, writes
    # one value per point; ~16 f32 operations per point to form it (the
    # divides counted as one each) and ~20 to sample it.
    return kernel_row(
        "warp_sample_homography", "warp.cu", "slideo_tpu/ops/pallas_warp.py:86", err, ms, dev_ms,
        bound(small.numel() * 4 + 32 * got.shape[0] + 4 * n_pt, 36 * n_pt, "f32"),
        call_site="slideo_tpu/ops/verify.py:199")


def table_bound(q: int, n_cols: int, k: int) -> dict:
    """K5 reads the queries and the listed slides' rows once (256 B + a valid
    byte a slot) and writes best + arg; 2 * 256 int8 operations a (query,
    slot) pair."""
    return bound(n_cols * k * (256 + 1) + q * 256 + q * n_cols * 8, 2 * q * n_cols * k * 256, "int8")


def check_table(torch, label: str, query, di, n_slides: int, k: int, slide_ids=None) -> float:
    """Hold K5 bit-equal (best and arg) to its plain version; returns the
    max abs error of best (0)."""
    from slideo_tpu_torch.ops import cuda_table

    best, arg = cuda_table.match_table_scores(query, di.desc, di.valid, n_slides, k, slide_ids)
    pbest, parg = cuda_table.match_table_scores_plain(query, di.desc, di.valid, n_slides, k, slide_ids)
    torch.cuda.synchronize()
    same = torch.equal(best, pbest) and torch.equal(arg, parg)
    cols = n_slides if slide_ids is None else slide_ids.shape[0]
    print(f"[K5] {label}: query {tuple(query.shape)} x {cols} columns of {k} slots: "
          f"best+arg bit-equal {same}")
    check(same, f"K5 table kernel ({label}) is not bit-equal to its plain version")
    return float((best - pbest).abs().max())


def time_table(torch, label: str, query, di, n_slides: int, k: int, slide_ids, smi: str):
    """Call ms of K5 and its plain version, device ms of K5; returns both."""
    from slideo_tpu_torch.ops import cuda_table

    kernel = lambda: cuda_table.match_table_scores(query, di.desc, di.valid, n_slides, k, slide_ids)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": lambda: cuda_table.match_table_scores_plain(
        query, di.desc, di.valid, n_slides, k, slide_ids)})
    dev = device_ms({"kernel": kernel}, ms)
    b = table_bound(query.shape[0], n_slides if slide_ids is None else slide_ids.shape[0], k)
    print(f"[time] match_table {label}: kernel call {ms['kernel']:.4f} ms, device "
          f"{dev['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) ({smi})")
    return ms, dev


def screen_bound(r: int, n_cols: int, n_slots: int, n_read: int, bits: int = 128) -> dict:
    """K5 (b) must read the ``bits``-byte prefix and the valid byte of each
    of ``n_slots`` slots (K / stride in the strided form) of each of the
    ``n_read`` distinct slides it scores once, and the queries once, and
    write [R, n_cols] int32; 2 * bits int8 operations a (query, slot)
    pair."""
    return bound(n_read * n_slots * (bits + 1) + r * bits + r * n_cols * 4,
                 2 * r * n_cols * n_slots * bits, "int8")


def screen_cases(torch, prefixes, per_frame: int, di, n_slides: int, k: int, match) -> list:
    """K5 (b)'s shapes in its three forms: (label, query, index, S, K,
    stride, slide lists, the plain version's result).

    Single stage: ``prefixes`` (a batch of frames' stacked ``per_frame``
    query prefixes) against the index ``di``; one frame; a ragged last batch
    of 37 frames; the 1,000 query prefixes of ``adversarial_table`` (phase
    3's seed; every 7th row zero, slide 1 with no valid slot, slide 2 valid
    only in its second half) at K = 2048 and at K = 1000, which is not a
    multiple of the 64-slot tile. Strided (the pre-vote, stride
    ``match.screen_prevote_k_stride``): each frame's first
    ``screen_prevote_queries`` rows; one frame; 37 frames; the adversarial
    index at K = 2048, and at K = 1000 with stride 8 (125 slots, a ragged
    last tile). Listed (the re-vote): each frame's rows against its own P =
    ``screen_prevote_slides`` slides, listed as the pre-vote picks them from
    the strided case; one frame; 37 frames; groups of 200 rows (not a
    multiple of the 256-query tile) and of 300 (a second, ragged tile a
    group); the adversarial index at K = 2048 and 1000 in 8 groups of 125
    rows, each listing ``adversarial_table``'s slide list (repeated ids,
    the slide without a valid slot) rotated by its group."""
    from slideo_tpu_torch.ops import cuda_screen, hamming, top_k

    dev = prefixes.device
    bits = cuda_screen.SCREEN_BITS
    stride, p = match.screen_prevote_k_stride, match.screen_prevote_slides
    npq = min(match.screen_prevote_queries, per_frame)
    b = prefixes.shape[0] // per_frame
    frames = prefixes.reshape(b, per_frame, bits)
    strong = frames[:, :npq].reshape(-1, bits).contiguous()
    best = cuda_screen.screen_scores_plain(strong, di.desc, di.valid, n_slides, k, stride)
    pre = top_k(hamming._screen_votes(best.reshape(b, npq, n_slides)), p)[1].to(torch.int32)
    deck = (di, n_slides, k)
    cases = [(f"{b} frames", prefixes, *deck, 1, None),
             ("one frame", prefixes[:per_frame], *deck, 1, None),
             ("37 frames", prefixes[:37 * per_frame], *deck, 1, None),
             (f"strided {b} frames", strong, *deck, stride, None),
             ("strided one frame", strong[:npq], *deck, stride, None),
             ("strided 37 frames", strong[:37 * npq], *deck, stride, None),
             (f"listed {b} frames", prefixes, *deck, 1, pre),
             ("listed one frame", prefixes[:per_frame], *deck, 1, pre[:1]),
             ("listed 37 frames", prefixes[:37 * per_frame], *deck, 1, pre[:37]),
             ("listed 200 rows a group", frames[:, :200].reshape(-1, bits).contiguous(), *deck, 1,
              pre),
             ("listed 300 rows a group", prefixes[:16 * 300], *deck, 1, pre[:16])]
    for k_adv, adv_stride in ((2048, stride), (1000, 8)):
        query, desc, valid, cand = adversarial_table(3, k=k_adv)
        adv = (hamming.build_index(torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev)),
               desc.shape[0], k_adv)
        q = torch.from_numpy(query[:, :bits].copy()).to(dev)
        lists = torch.from_numpy(np.stack([np.roll(cand, g) for g in range(8)])).to(dev)
        cases += [(f"adversarial K={k_adv}", q, *adv, 1, None),
                  (f"strided adversarial K={k_adv}, stride {adv_stride}", q, *adv, adv_stride,
                   None),
                  (f"listed adversarial K={k_adv}, 8 groups", q, *adv, 1, lists)]
    return [(*c, cuda_screen.screen_scores_plain(c[1], c[2].desc, c[2].valid, *c[3:]))
            for c in cases]


def check_screen(torch, cases: list, tag: str, single_only: bool = False) -> dict:
    """Hold K5 (b) bit-equal to its plain version on every case of
    ``screen_cases`` (with ``single_only``, on its single-stage cases);
    returns each case's max abs error (0)."""
    from slideo_tpu_torch.ops import cuda_screen

    errs = {}
    for label, query, di, n_slides, k, stride, ids, want in cases:
        if single_only and (stride != 1 or ids is not None):
            continue
        got = cuda_screen.screen_scores(query, di.desc, di.valid, n_slides, k, stride, ids)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        errs[label] = float((got - want).abs().max())
        cols = f"{n_slides} slides" if ids is None else f"{tuple(ids.shape)} listed slides"
        print(f"[K5b] {tag} {label}: query {tuple(query.shape)} x {cols} x {k} slots, stride "
              f"{stride}: bit-equal {same}")
        check(same, f"K5 (b) screening kernel ({tag}) is not bit-equal to its plain version "
                    f"({label})")
    return errs


def time_screen(torch, label: str, query, di, n_slides: int, k: int, smi: str,
                library: bool = False, plain: bool = True, stride: int = 1,
                ids=None) -> tuple[dict, dict, dict]:
    """Call ms of K5 (b) (at ``stride``, over the lists ``ids`` when given)
    and of its plain version, device ms of K5 (b), and its bound; with
    ``library``, also of ``torch._int_mm`` of the product alone ([R, 128] @
    [128, slots]: the slots the call reads, gathered into a contiguous copy
    here, for one group when listed; no mask, no max), which the port never
    calls."""
    from slideo_tpu_torch.ops import cuda_screen

    bits = cuda_screen.SCREEN_BITS
    fns = {"kernel": lambda: cuda_screen.screen_scores(query, di.desc, di.valid, n_slides, k,
                                                       stride, ids)}
    if plain:
        fns["plain"] = lambda: cuda_screen.screen_scores_plain(query, di.desc, di.valid, n_slides,
                                                               k, stride, ids)
    if library:
        check(ids is None or ids.shape[0] == 1, "the library product takes one group's lists")
        d3 = di.desc.view(n_slides, k, -1)
        sel = d3[:, ::stride] if ids is None else d3[ids[0].long(), ::stride]
        pre_t = sel[..., :bits].reshape(-1, bits).contiguous().T
        fns["library"] = lambda: torch._int_mm(query, pre_t)
    ms = cuda_ms(fns, reps=5)
    dev = device_ms({n: f for n, f in fns.items() if n != "plain"}, ms, reps=5)
    n_cols, n_read = ((n_slides, n_slides) if ids is None
                      else (ids.shape[1], torch.unique(ids).numel()))
    b = screen_bound(query.shape[0], n_cols, k // stride, n_read)
    lib = (f"; torch._int_mm call {ms['library']:.4f} ms, device {dev['library']:.4f} ms"
           if library else "")
    pl = f"; plain {ms['plain']:.4f} ms" if plain else ""
    print(f"[time] screen_scores {label}: kernel call {ms['kernel']:.4f} ms, device "
          f"{dev['kernel']:.4f} ms{pl}{lib}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) ({smi})")
    return ms, dev, b


def kernel_name(mangled: str) -> str:
    """The innermost name of a mangled kernel (``_ZN<n>ns<n>name...``), with
    its integer template arguments (``name<128>``)."""
    import re

    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while (m := re.match(r"\d+", mangled[i:])):
        n = int(m.group())
        name, i = mangled[i + m.end():i + m.end() + n], i + m.end() + n
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def compare_library(src: str, index: int, symbols: tuple, signatures: dict | None = None):
    """``src`` built alone into a library of its own with ``-Xptxas -v``
    (headers from csrc/), the C signatures of ``symbols`` bound (from
    ``signatures``, else ``_kernels._SIGNATURES``); returns the library,
    ptxas's resource lines (each kernel's name, then its lines) and the
    counts of the SASS opcodes from ``cuobjdump -sass``: by name (before
    the first dot) and, for an opcode with modifiers, also in full
    (``LDS.U.128``), each kernel's instructions under ``"kernel.NAME"`` and
    its opcodes by name under ``"OP@NAME"``."""
    import collections
    import ctypes
    import re

    from slideo_tpu_torch import _kernels

    so = _kernels._BUILD_DIR / f"compare_{index}_{Path(src).stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels._nvcc(), *_kernels._FLAGS, "-I", str(_kernels._SRC_DIR),
                           "-Xptxas", "-v", "-shared", "-o", str(so), src],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on {src}:\n{proc.stderr}")
    resources = []
    for line in proc.stderr.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            resources.append(kernel_name(entry.group(1)))
        elif "registers" in line or "spill" in line:
            resources.append(line.strip())
    sass = subprocess.run([str(Path(_kernels._nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    ops = collections.Counter()
    for part in re.split(r"Function : (\w+)", sass)[1:]:
        if re.fullmatch(r"\w+", part):
            kernel = f"kernel.{kernel_name(part)}"
            continue
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", part):
            ops[op.split(".")[0]] += 1
            ops[kernel] += 1
            ops[f"{op.split('.')[0]}@{kernel[7:]}"] += 1
            if "." in op:
                ops[op] += 1
    lib = ctypes.CDLL(str(so))
    for name in symbols:
        getattr(lib, name).argtypes = (signatures or _kernels._SIGNATURES)[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, resources, ops


def sass_total(ops) -> int:
    """The instructions counted by ``compare_library``'s opcode names."""
    return sum(n for op, n in ops.items() if "." not in op and "@" not in op)


# (slots, prefix bits) of the per-frame rule's prefix table that phase 10
# and --compare-screen time on one frame and on 64: a 512-slot trim at 128
# bits, 64 bits over full K, and both.
PREFIX_SETTINGS = ((512, 128), (2048, 64), (512, 64))


# C signatures of slideo_screen before its per-frame prefix form: the
# single stage alone (query, nq, desc, valid, n_slides, k_per_slide, best,
# stream) and with the strided and listed forms (no n_slots, no prefix).
EARLIER_SCREEN_SIGNATURES = {
    "single-stage": ("p", "i", "p", "p", "i", "i", "p", "p"),
    "no prefix form": ("p", "i", "p", "p", "i", "i", "p", "i", "i", "p", "p"),
}


def earlier_screen_library(lib, form: str):
    """A library whose ``slideo_screen`` takes the ``form`` signature of
    ``EARLIER_SCREEN_SIGNATURES``, behind the current signature, for the
    calls that form takes only."""
    import types

    def slideo_screen(query, nq, desc, valid, k, stride, n_slots, prefix, ids, n_cols,
                      rows_per_group, best, stream):
        check(n_slots == k // stride and prefix == 128,
              f"a {form} screen.cu takes no slot count or prefix width")
        if form == "no prefix form":
            return lib.slideo_screen(query, nq, desc, valid, k, stride, ids, n_cols,
                                     rows_per_group, best, stream)
        check(stride == 1 and ids is None and rows_per_group == nq,
              "a single-stage screen.cu takes no stride, row groups or slide lists")
        return lib.slideo_screen(query, nq, desc, valid, n_cols, k, best, stream)

    return types.SimpleNamespace(slideo_screen=slideo_screen)


def phase_compare_screen(torch, sources: list[str], seed: int, smi: str) -> None:
    """Versions of csrc/screen.cu side by side: each source (exporting
    ``slideo_screen`` in the current C signature, or in one of
    ``EARLIER_SCREEN_SIGNATURES``, called through
    ``earlier_screen_library``) is built into a library of its own; ptxas's
    registers, spills and shared memory and the SASS counts of IGMMA
    (wgmma), UTMALDG (TMA loads), IMMA (mma.sync), IDP (dp4a), LDSM, LDGSTS
    and LDS are printed, in all and for each kernel. On a random +-1 index of the
    phase-5 shape (500 slides x 2048 slots, 10% of slots and slide 7
    invalid) and 64 frames' worth of random prefixes (every 7th row zero),
    each version is held bit-equal on every case of ``screen_cases`` it
    takes (a single-stage source: those of the single stage) and timed at
    64 frames and one frame (and, where it takes them, at the strided and
    listed 64-frame cases), in turns, forwards then backwards. A source
    with the per-frame prefix form is also held bit-equal and timed on one
    frame's rows and on 64 frames' at each of ``PREFIX_SETTINGS``."""
    import ctypes
    import re

    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import hamming

    ctype = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    forms = {len(_kernels._SIGNATURES["slideo_screen"]): None,
             **{len(sig): form for form, sig in EARLIER_SCREEN_SIGNATURES.items()}}
    libs = {}
    for src in sources:
        # The launcher's C arguments (the stream included) name its form.
        params = re.search(r'extern "C" int slideo_screen\(([^)]*)\)', Path(src).read_text())
        form = forms[params.group(1).count(",") + 1]
        sig = (None if form is None else
               {"slideo_screen": tuple(ctype[c] for c in EARLIER_SCREEN_SIGNATURES[form])})
        lib, resources, ops = compare_library(src, len(libs), ("slideo_screen",), sig)
        sass_ops = ("IGMMA", "UTMALDG", "IMMA", "IDP", "LDSM", "LDGSTS", "LDS")
        by_kernel = ", ".join(
            f"{op[7:]} {n} (" + ", ".join(f"{o} {ops[f'{o}@{op[7:]}']}" for o in sass_ops) + ")"
            for op, n in ops.items() if op.startswith("kernel."))
        print(f"[compare] {src}{f' ({form} signature)' if form else ''}: {resources}; "
              f"{sass_total(ops)} SASS instructions ({by_kernel}), "
              + ", ".join(f"{op} {ops[op]}" for op in sass_ops))
        libs[src] = (lib if form is None else earlier_screen_library(lib, form), form)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pm1 = lambda *shape: (torch.randint(0, 2, shape, generator=gen, device=dev,  # noqa: E731
                                        dtype=torch.int8) * 2 - 1).to(torch.int8)
    n_slides, k = 500, 2048
    valid = torch.rand(n_slides, k, generator=gen, device=dev) > 0.1
    valid[7] = False
    di = hamming.build_index(pm1(n_slides, k, 256), valid)
    prefixes = pm1(64 * 256, 128)
    prefixes[::7] = 0
    cases = screen_cases(torch, prefixes, 256, di, n_slides, k, DEFAULT_CONFIG.match)
    by_label = {c[0]: c for c in cases}
    timed = ("64 frames", "one frame", "strided 64 frames", "listed 64 frames")
    prefix = {f"{frames}, {n} slots, {bits} bits": (rows, n, bits)
              for n, bits in PREFIX_SETTINGS
              for frames, rows in (("one frame", prefixes[:256]), ("64 frames", prefixes))}
    times = {src: {label: [] for label in (*timed, *prefix)} for src in sources}
    try:
        for turn, names in enumerate((sources, sources[::-1])):
            for src in names:
                _kernels._lib, form = libs[src]
                single = form == "single-stage"
                print(f"[compare] {src}, turn {turn}")
                check_screen(torch, cases, src, single_only=single)
                for label in timed[:2] if single else timed:
                    _, query, di_, n_s, k_, stride, ids, _ = by_label[label]
                    _, dev_ms, _ = time_screen(torch, f"{src} {label}", query, di_, n_s, k_, smi,
                                               plain=False, stride=stride, ids=ids)
                    times[src][label].append(dev_ms["kernel"])
                for label, (rows, n, bits) in (prefix.items() if form is None else ()):
                    case = prefix_case(torch, f"{src} {label}", rows, di, n_slides, k, n, bits,
                                       smi, library=False)
                    times[src][label].append(case["dev"]["kernel"])
    finally:
        _kernels._lib = None
    for src in sources:
        print(f"[compare] {src}: device ms " + "; ".join(
            f"{label} {min(t):.4f}-{max(t):.4f}" for label, t in times[src].items() if t)
            + f" ({smi})")


def ransac_inputs(torch, index, frames: list, cfg) -> list:
    """The cascade's RANSAC inputs (src, dst [C, M, 2], valid [C, M]) of
    each frame against a deck's ``SlideIndex``, formed as
    ``orb_matcher.cascade_from_table`` forms them: C = min(top_slides,
    slides), M = max_matches_per_slide."""
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import hamming, select

    dev = torch.device("cuda")
    n_slides, k = index.pts.shape[0], index.pts.shape[1]
    out = []
    for frame in frames:
        feats, _ = orb_matcher._frame_features(torch.from_numpy(frame).to(dev), cfg)
        table = hamming.match_table_frame(feats.desc, feats.score, index.desc_index, n_slides, k,
                                          cfg.match)
        cs = select.select_candidates_table(table, feats.valid, cfg.match)
        cand_pts = index.pts[cs.slide_ids.long()]
        src = torch.gather(cand_pts, 1, cs.train_ids.long()[..., None].expand(-1, -1, 2))
        out.append((src, feats.pts[cs.query_ids.long()], cs.match_valid & cs.cand_valid[:, None]))
    return out


# The main path's RANSAC shapes, timed: 40 candidates of a 64-slide deck,
# 16 survivors of a screened deck; M = 512, H = 512.
RANSAC_TIMED = ("C=40 M=512 H=512", "C=16 M=512 H=512")


def ransac_cases(torch, seed: int) -> list:
    """(label, (src, dst, valid, u)) of the RANSAC comparison: two frames'
    matches at each of ``RANSAC_TIMED`` (a 64-slide ``make_deck`` deck, and
    16 slides of ``make_reveal_deck``'s near-duplicate families, the
    screened path's survivors), the engine's draws; then the edges on the
    first: H = 256 and 1,200, C = 1, a candidate with one valid point and
    one with none, every draw of the first 250 repeated at h + 250 (each
    best count tied with a later copy), and random matches at M = 2,048."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import ransac

    cfg = DEFAULT_CONFIG
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    decks = (make_deck(rng, N_SLIDES), make_reveal_deck(rng, 4)[:16])
    cases = []
    for label, deck in zip(RANSAC_TIMED, decks):
        picks = rng.choice(len(deck), 2, replace=False)
        frames = [with_noise(warp(deck[i], rng), rng, 1.5) for i in picks]
        index = orb_matcher.build_slide_index(deck, cfg, dev)
        for j, (src, dst, valid) in enumerate(ransac_inputs(torch, index, frames, cfg)):
            u = ransac.uniform_draws(src.shape[0], cfg.match, seed + j, dev)
            want = (min(cfg.match.top_slides, len(deck)), cfg.match.max_matches_per_slide)
            check(tuple(src.shape[:2]) == want, f"RANSAC inputs {tuple(src.shape)} are not {label}")
            cases.append((f"{label} frame {j}", (src, dst, valid, u)))
    src, dst, valid, u = cases[0][1]
    c = src.shape[0]
    few = valid.clone()
    few[0] = False
    few[0, 0] = True
    few[1] = False
    tied = u.clone()
    tied[:, 250:500] = u[:, :250]
    big = [torch.from_numpy(x).to(dev) for x in ransac_synthetic(seed, 8, 2048)]
    cases += [
        ("H=256", (src, dst, valid, torch.rand((c, 256, 2), generator=gen, device=dev))),
        ("H=1200", (src, dst, valid, torch.rand((c, 1200, 2), generator=gen, device=dev))),
        ("C=1", (src[:1], dst[:1], valid[:1], u[:1])),
        ("fewer than two valid points", (src, dst, few, u)),
        ("tied best counts", (src, dst, valid, tied)),
        ("M=2048 random", (*big, torch.rand((8, 512, 2), generator=gen, device=dev))),
    ]
    return cases


def check_ransac(torch, label: str, args: tuple, consts: dict, tag: str) -> float:
    """The kernel on one case against the plain version (ok, the winning
    hypothesis and rating equal, the transform within 1e-3) and, bit for
    bit, against ``ransac_replay`` with ``consts``; one launch a call.
    Returns the transform's largest difference from the plain version."""
    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import cuda_ransac, ransac

    mcfg = DEFAULT_CONFIG.match
    before = _kernels.launches["ransac"]
    got, winner = cuda_ransac.ransac_with_winner(*args, mcfg)
    check(_kernels.launches["ransac"] == before + 1, f"{tag} {label}: not one ransac launch")
    routed = ransac.ransac_similarity(*args, mcfg)
    check(_kernels.launches["ransac"] == before + 2, f"{tag} {label}: a CUDA tensor took the plain version")
    want = ransac.ransac_similarity_plain(*args, mcfg)
    best_n, best_h, _ = ransac.score_hypotheses(*args, mcfg)
    torch.cuda.synchronize()
    rep = ransac_replay(*(x.cpu().numpy() for x in args), mcfg.ransac_threshold,
                        mcfg.ransac_refine_iters, consts)
    np_ = lambda x: x.cpu().numpy()  # noqa: E731
    fields = ("a", "b", "tx", "ty")
    err = max(float((g - w).abs().max()) if g.numel() else 0.0
              for g, w in zip(got.transform, want.transform))
    n_inl = int((got.inliers != want.inliers).sum())
    print(f"[ransac] {tag} {label}: C={args[0].shape[0]} M={args[0].shape[1]} H={args[3].shape[1]}; "
          f"ok {int(got.ok.sum())}, winners {np_(winner).tolist()[:8]}..., rating "
          f"{np_(got.rating).tolist()[:8]}...; transform max_abs_err {err:.3g} against plain, "
          f"{n_inl} inlier flags differ")
    check(torch.equal(got.ok, want.ok), f"{tag} {label}: ok differs from the plain version")
    check(np.array_equal(np_(winner), np.where(np_(best_n) >= 0, np_(best_h), -1)),
          f"{tag} {label}: winning hypotheses differ from the plain version")
    check(torch.equal(got.rating, want.rating), f"{tag} {label}: rating differs from the plain version")
    check(err <= 1e-3, f"{tag} {label}: transform differs from the plain version by {err} > 1e-3")
    for name, f in zip((*fields, "rating"), (*got.transform, got.rating)):
        check(np.array_equal(np_(f), rep[name]), f"{tag} {label}: {name} is not the replay's")
    check(np.array_equal(np_(got.inliers), rep["inliers"]) and np.array_equal(np_(winner), rep["winner"]),
          f"{tag} {label}: inliers or winners are not the replay's")
    for g, r in zip((*got.transform, got.rating, got.ok, got.inliers),
                    (*routed.transform, routed.rating, routed.ok, routed.inliers)):
        check(torch.equal(g, r), f"{tag} {label}: a second launch is not bit-identical")
    return err


def ransac_bound(c: int, m: int, n_hyp: int, n_refine: int) -> dict:
    """Bound of one RANSAC call: reads the points (17 B each) and the scored
    draws, writes the inliers and 25 B a candidate; a point test is 15 f32
    operations (two products and two sums a coordinate, the difference,
    two squares, a sum, a compare), a fit ~20, a refinement 34 a point."""
    from slideo_tpu_torch.ops import ransac

    used = ransac.n_scored(n_hyp)
    ops = c * (used * (20 + 15 * m) + (n_refine * 34 + 15) * m)
    return bound(c * m * 17 + c * used * 8 + c * m + 25 * c, ops, "f32")


def time_ransac(torch, label: str, args: tuple, smi: str) -> dict:
    """Call ms of the kernel and of the plain version, device ms of the
    kernel, and the bound, on one case."""
    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.ops import cuda_ransac, ransac

    mcfg = DEFAULT_CONFIG.match
    fns = {"kernel": lambda: cuda_ransac.ransac_similarity(*args, mcfg),
           "plain": lambda: ransac.ransac_similarity_plain(*args, mcfg)}
    ms = cuda_ms(fns)
    dev = device_ms({"kernel": fns["kernel"]}, ms)
    c, m = args[2].shape
    cost = ransac_bound(c, m, args[3].shape[1], mcfg.ransac_refine_iters)
    print(f"[time] ransac_similarity {label}: kernel call {ms['kernel']:.4f} ms, device "
          f"{dev['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; bound {cost['bound_ms']:.4f} ms "
          f"({cost['bound_by']}) ({smi})")
    return dict(ms=ms, dev=dev, cost=cost)


def phase_compare_ransac(torch, sources: list[str], seed: int, smi: str) -> None:
    """Versions of csrc/ransac.cu side by side: each source (exporting
    ``slideo_ransac`` in its C signature) is built into a library of its own,
    ptxas's registers, spills and shared memory and its SASS counts are
    printed; then in turns, forwards then backwards, each is held on every
    case of ``ransac_cases`` to the plain version and bit for bit to
    ``ransac_replay`` with the source's own block shapes, and timed at
    ``RANSAC_TIMED`` (the first frame of each)."""
    from slideo_tpu_torch import _kernels

    libs = {}
    for src in sources:
        lib, resources, ops = compare_library(src, len(libs), ("slideo_ransac",))
        print(f"[compare] {src}: {resources}; {sass_total(ops)} SASS instructions, " + ", ".join(
            f"{op} {ops[op]}" for op in ("FADD", "FMUL", "FFMA", "MUFU", "VOTE", "POPC", "SHFL",
                                         "LDS", "BAR", "ATOMS")))
        libs[src] = (lib, ransac_constants(Path(src).read_text()))
    cases = ransac_cases(torch, seed)
    by_label = dict(cases)
    times = {src: {label: [] for label in RANSAC_TIMED} for src in sources}
    try:
        for turn, names in enumerate((sources, sources[::-1])):
            for src in names:
                _kernels._lib, consts = libs[src]
                print(f"[compare] {src}, turn {turn}")
                for label, args in cases:
                    check_ransac(torch, label, args, consts, src)
                for label in RANSAC_TIMED:
                    timed = time_ransac(torch, f"{src} {label}", by_label[f"{label} frame 0"], smi)
                    times[src][label].append(timed["dev"]["kernel"])
    finally:
        _kernels._lib = None
    for src in sources:
        print(f"[compare] {src}: device ms " + "; ".join(
            f"{label} {min(t):.4f}-{max(t):.4f}" for label, t in times[src].items()) + f" ({smi})")


def phase_profiler_check(torch, smi: str) -> None:
    """K5 at Q=768 x 64 slides x 2048 slots (random +-1 rows): the graph
    replay's device ms against ``torch.profiler``'s kernel durations."""
    from slideo_tpu_torch.ops import cuda_table, hamming

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pm1 = lambda *shape: (torch.randint(0, 2, shape, generator=gen, device=dev,  # noqa: E731
                                        dtype=torch.int8) * 2 - 1).to(torch.int8)
    di = hamming.build_index(pm1(N_SLIDES, 2048, 256),
                             torch.rand(N_SLIDES, 2048, generator=gen, device=dev) > 0.1)
    query = pm1(768, 256)
    kernel = lambda: cuda_table.match_table_scores(query, di.desc, di.valid, N_SLIDES, 2048)  # noqa: E731
    graph = device_ms({"kernel": kernel}, cuda_ms({"kernel": kernel}, reps=3))["kernel"]
    prof = profiler_device_ms(kernel, "match_table_kernel")
    print(f"[time] match_table Q=768 x {N_SLIDES} slides: graph replay {graph:.4f} ms, "
          f"torch.profiler kernel duration {'not recorded' if prof is None else f'{prof:.4f} ms'} "
          f"({smi})")


def phase_compare_fast(torch, sources: list[str], seed: int, smi: str) -> None:
    """Versions of csrc/fast.cu side by side: each source (exporting the two
    FAST launchers with their C signatures) is built into a library of its
    own and the versions take turns, forwards then backwards. Each is held
    bit-equal to the plain version on the scalar-path shapes, then
    ``fast_case`` / ``fast_batch_case`` check and time K1 on a frame's atlas
    and a corner-dense atlas, and K2 on 8 slide and 8 corner-dense atlases."""
    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import features

    libs = {}
    for src in sources:
        lib, resources, ops = compare_library(src, len(libs), ("slideo_fast_nms", "slideo_fast_nms_batch"))
        print(f"[compare] {src}: {resources}; {sass_total(ops)} SASS instructions, " + ", ".join(
            f"{op} {ops[op]}" for op in ("HMNMX2", "VHMNMX", "FMNMX", "F2FP", "LDS", "LDG", "STG")))
        libs[src] = lib
    thr = DEFAULT_CONFIG.orb.fast_threshold
    rng = np.random.RandomState(seed)
    pyramid = lambda img: features.build_pyramid(  # noqa: E731
        torch.from_numpy(img).to("cuda").float(), DEFAULT_CONFIG.orb)
    noise = lambda: rng.randint(0, 256, FRAME_HW).astype(np.uint8)  # noqa: E731
    deck = make_deck(rng, 8)
    atlas = pyramid(with_noise(warp(deck[0], rng), rng, 1.5))
    dense = pyramid(noise())
    slides = torch.stack([pyramid(p) for p in deck])
    dense8 = torch.stack([pyramid(noise()) for _ in range(8)])
    for turn, names in enumerate((sources, sources[::-1])):
        for src in names:
            _kernels._lib = libs[src]
            print(f"[compare] {src}, turn {turn}")
            check_fast_edges(torch, dense, thr, src)
            fast_case(torch, f"{src} frame atlas", atlas, thr, smi)
            fast_case(torch, f"{src} corner-dense atlas", dense, thr, smi)
            fast_batch_case(torch, f"{src} 8 slides", slides, thr, smi)
            fast_batch_case(torch, f"{src} 8 corner-dense", dense8, thr, smi)


def check_fast_edges(torch, dense, threshold: int, tag: str) -> None:
    """Hold K1 bit-equal to its plain version where it takes its scalar
    loads and stores: a width that is not a multiple of 8, a pointer off the
    16-byte grid, an image smaller than a tile (crops of ``dense``)."""
    from slideo_tpu_torch.ops import cuda_fast

    for label, img in (("odd width", dense[:1001, 3:1918].contiguous()),
                       ("unaligned", dense.flatten()[1:1 + 400 * 640].view(400, 640)),
                       ("7 x 9", dense[:7, :9].contiguous())):
        same = torch.equal(cuda_fast.fast_score_map(img, threshold),
                           cuda_fast.fast_score_map_plain(img, threshold))
        print(f"[K1] {tag} {label} {tuple(img.shape)}: bit-equal {same}")
        check(same, f"K1 FAST kernel ({tag}) is not bit-equal to its plain version ({label})")


def print_row(r: dict, smi: str) -> None:
    lib = ("none" if r["library_ms"] is None
           else f"call {r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} ms")
    print(f"[time] {r['name']}: kernel call {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms; "
          f"plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
          f"library {lib} ({smi})")


def make_stream(rng: np.random.RandomState, deck: np.ndarray):
    """Runs of sampled frames: (expected page index or None, frames)."""
    order = rng.permutation(len(deck))[:20].tolist()
    runs: list[tuple[int | None, list[np.ndarray]]] = []
    for i, s in enumerate(order):
        base = warp(deck[s], rng)
        runs.append((s, [with_noise(base, rng, 1.5) for _ in range(RUN_LEN)]))
        if i in (5, 12):   # no slide visible: noise, then a blank screen
            runs.append((None, [rng.randint(0, 256, FRAME_HW).astype(np.uint8) for _ in range(2)]))
            runs.append((None, [np.full(FRAME_HW, 128, np.uint8) for _ in range(2)]))
    return runs


def phase_slice(torch, deck: np.ndarray, runs, seed: int, smi: str, db_dir: Path) -> dict:
    from slideo_tpu_torch import DEFAULT_CONFIG

    out = drive_engine(torch, DEFAULT_CONFIG, deck, runs, seed, smi, "slice", db_dir=db_dir)
    for name in ("fast", "orb", "table", "warp", "ransac"):
        check(out["launches"][name] > 0, f"kernel {name} was never launched by the match path")
    check(out["launches"]["screen_prefix"] == 0, "the exact path launched the per-frame stage 1")
    return out


def drive_engine(torch, cfg, deck: np.ndarray, runs, seed: int, smi: str, tag: str,
                 mesh_devices=None, strict: bool = True, engine=None, db_dir=None,
                 gate: bool = True) -> dict:
    """Index ``deck`` with ``MatchingEngine`` (on a frame-parallel mesh of
    ``mesh_devices`` when given, else on cuda:0 alone, however many cards
    there are), or take ``engine`` as it is, and stream the runs' frames
    through ``match_samples``, with every launch count set to 0 just
    before and read just after; write the timeline through the port's
    ``Db`` (in ``db_dir``, kept, when given), read it back and check it
    against the runs (with ``strict`` False, check only that every changed
    frame got its run's page: dedup may merge runs of near-duplicate
    slides in the timeline; with ``gate`` False, neither). Returns the
    launches, the frame -> page rows of every matched frame (the engine's
    checkpoint rows), the sampled frames by index, the timeline rows, the
    engine, the build's breakdown, the deck's and the video's hashes and
    the sampled frames per second.
    """
    from slideo_tpu_torch import _kernels
    from slideo_tpu_torch.app import pipeline
    from slideo_tpu_torch.app.db import Db
    from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage

    pdf_hash = (hashlib.sha256(f"chip-smoke-deck-{tag}-{seed}".encode()).hexdigest()
                if engine is None else engine.pages[0].pdf_hash)
    video_hash = hashlib.sha256(f"chip-smoke-video-{tag}-{seed}".encode()).hexdigest()
    pages = [PdfPage(Path("deck.pdf"), pdf_hash, Path(f"p-{i + 1}.png"), i + 1) for i in range(len(deck))]
    samples, expected, idx = [], [], 0
    stride = int(FPS * INTERVAL)
    for page, frames in runs:
        expected.append((idx * stride * 1000 // FPS, page))
        for f in frames:
            samples.append((idx * stride, idx * stride / FPS, f))
            idx += 1
    total_frames = idx * stride
    total_ms = total_frames * 1000 // FPS
    matched: list[tuple[int, int | None]] = []

    def checkpoint(rows, _last_frame_idx):
        matched.extend((frame_idx, page) for frame_idx, _ms, _h, page in rows)

    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_device = mesh_devices is None
    built = engine is None
    if built:
        engine = MatchingEngine(cfg, pages, device="cuda:0", page_grays=deck,
                                mesh_devices=["cuda:0"] if one_device else mesh_devices)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    build = dict(pipeline.LAST_BUILD_BREAKDOWN) if built else {}
    check((engine.mesh is None) == one_device, f"{tag}: the engine's mesh is {engine.mesh}")
    t0 = time.perf_counter()
    timeline = engine.match_samples(samples, total_ms=total_ms, total_frames=total_frames,
                                    checkpoint=checkpoint, frames_total=len(samples))
    torch.cuda.synchronize()
    t_match = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    if built:
        print(f"[{tag}] index of {len(deck)} slides {FRAME_HW[0]}x{FRAME_HW[1]} built in "
              f"{t_index:.3f} s ({smi}); mesh {engine.mesh}")
    print(f"[{tag}] {len(samples)} sampled frames ({len(matched)} changed and matched) in "
          f"{t_match:.3f} s: {len(samples) / t_match:.2f} frames/s ({smi}); kernel launches {launches}")

    with tempfile.TemporaryDirectory() as td:
        Path(db_dir or td).mkdir(parents=True, exist_ok=True)
        db = Db(Path(db_dir or td) / "slideo.db")
        db.create_or_reset_video(video_hash, [pdf_hash])
        db.finalize_video_matchings(video_hash, [
            (m.video_ms, m.page.pdf_hash if m.page else None,
             (m.page.page_nr - 1) if m.page else None) for m in timeline
        ])
        rows = db.conn.execute(
            "SELECT video_ms, pdf_hash, page FROM videos_mapping ORDER BY video_ms"
        ).fetchall()
        db.close()

    want = []
    for ms, page in expected:
        if want and want[-1][1] == page:
            continue
        want.append((ms, page))
    want.append((total_ms, None))
    got = [(ms, page if h is not None else None) for ms, h, page in rows]
    print(f"[{tag}] timeline ({len(got)} rows): {got}")
    check(all(h in (pdf_hash, None) for _, h, _ in rows), f"{tag}: rows name a foreign pdf hash")
    if gate and strict:
        check(got == want, f"{tag}: timeline differs from the stream's runs: want {want}")
    elif gate:
        assigned = dict(matched)
        first = 0
        resolved = 0
        for page, frames in runs:
            idx = range(first, first + len(frames))
            first += len(frames)
            resolved += all(assigned.get(i * int(FPS * INTERVAL), page) == page for i in idx)
        print(f"[{tag}] {resolved} of {len(runs)} runs got their page on every changed frame")
        check(resolved == len(runs), f"{tag}: {len(runs) - resolved} runs had a changed frame "
              "matched to another page")
    check(rows[-1][1] is None and rows[-1][0] == total_ms, f"{tag}: the sentinel row is not last")
    return dict(launches=launches, matched=matched, frames={i: f for i, _, f in samples},
                timeline=got, engine=engine, build=build, pdf_hash=pdf_hash,
                video_hash=video_hash, fps=len(samples) / t_match)


def make_reveal_deck(rng: np.random.RandomState, n_pages: int = SCREENED_PAGES) -> np.ndarray:
    """[n_pages * PER_FAMILY, 1080, 1920] uint8 near-duplicate deck: each
    ``make_deck`` page revealed line by line, slide j of a family showing
    the rows above the j-th cut (white below), the last slide the whole
    page. Adjacent family members differ in one band of text lines. The
    first pages do not depend on ``n_pages``: ``make_deck`` draws page by
    page."""
    pages = make_deck(rng, n_pages)
    h = FRAME_HW[0]
    top, bottom = 220, h - 90                     # make_deck's lines lie in between
    cuts = [top + (bottom - top) * (j + 1) // PER_FAMILY for j in range(PER_FAMILY - 1)] + [h]
    deck = np.repeat(pages, PER_FAMILY, axis=0)
    for s in range(len(deck)):
        deck[s, cuts[s % PER_FAMILY]:] = 255
    return deck


def make_screened_stream(rng: np.random.RandomState, deck: np.ndarray, n_families: int = 12):
    """Runs of sampled frames across families: three adjacent members of
    each family in reveal order, two frames each, with a noise and a blank
    run after the 4th and 9th family."""
    runs: list[tuple[int | None, list[np.ndarray]]] = []
    families = rng.permutation(len(deck) // PER_FAMILY)[:n_families]
    for i, fam in enumerate(families):
        first = rng.randint(0, PER_FAMILY - 2)
        for j in range(first, first + 3):
            s = int(fam) * PER_FAMILY + j
            base = warp(deck[s], rng)
            runs.append((s, [with_noise(base, rng, 1.5) for _ in range(2)]))
        if i in (3, 8):
            runs.append((None, [rng.randint(0, 256, FRAME_HW).astype(np.uint8) for _ in range(2)]))
            runs.append((None, [np.full(FRAME_HW, 128, np.uint8) for _ in range(2)]))
    return runs


def phase_screened(torch, seed: int, smi: str) -> tuple[list, list, dict, dict]:
    """The screened path on a 500-slide deck, with and without the
    pre-vote; returns K5 (b)'s kernel rows (single stage, strided, listed),
    the launches of the screened and the pre-vote runs, the exact run and
    the screened run (``drive_engine``'s results; the screened one also
    holds the deck and the runs)."""
    import dataclasses

    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import cuda_screen, features, hamming

    cfg = DEFAULT_CONFIG
    rng = np.random.RandomState(seed + 1)
    t0 = time.perf_counter()
    deck = make_reveal_deck(rng)
    runs = make_screened_stream(rng, deck)
    print(f"[screened] deck {deck.shape} and {sum(len(f) for _, f in runs)} frames made in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    check(len(deck) > cfg.match.screen_above_slides, "the deck does not take the screened path")

    # (c) + (e): the screened run through the engine.
    screened = drive_engine(torch, cfg, deck, runs, seed, smi, "screened")
    for name in ("screen", "table", "fast", "orb", "warp", "ransac"):
        check(screened["launches"][name] > 0, f"kernel {name} was never launched by the screened run")
    check(screened["launches"]["screen_strided"] == screened["launches"]["screen_listed"] == 0,
          "the single-stage screened run went through the pre-vote")
    check(screened["launches"]["screen_prefix"] == 0,
          "the batched screened run went through the per-frame stage 1")

    # (d): the same frames with screening off (the exact table over 500 slides).
    exact_cfg = dataclasses.replace(
        cfg, match=dataclasses.replace(cfg.match, screen_above_slides=len(deck) + 1)
    )
    exact = drive_engine(torch, exact_cfg, deck, runs, seed, smi, "exact500")
    check(exact["launches"]["screen"] == exact["launches"]["screen_prefix"] == 0,
          "the exact run went through stage-1 screening")
    diffs = [(a, b) for a, b in zip(screened["matched"], exact["matched"]) if a != b]
    print(f"[screened] screened vs exact assignments: {len(screened['matched'])} frames, "
          f"{len(diffs)} differences {diffs}")
    check(len(screened["matched"]) == len(exact["matched"]) and not diffs,
          "screened and exact assignments differ")

    # (f): the same frames with the strided pre-vote on (stage 1a strided,
    # stage 1b listed; the single stage must not run).
    pv_cfg = dataclasses.replace(cfg, match=dataclasses.replace(cfg.match, screen_prevote=True))
    prevote = drive_engine(torch, pv_cfg, deck, runs, seed, smi, "prevote")
    for name in ("screen_strided", "screen_listed", "table"):
        check(prevote["launches"][name] > 0,
              f"kernel {name} was never launched by the pre-vote run")
    check(prevote["launches"]["screen"] == prevote["launches"]["screen_prefix"] == 0,
          "the pre-vote run went through the single stage or the per-frame rule")
    diffs = [(a, b) for a, b in zip(prevote["matched"], exact["matched"]) if a != b]
    print(f"[prevote] pre-vote vs exact assignments: {len(prevote['matched'])} frames, "
          f"{len(diffs)} differences {diffs}; frames/s pre-vote on {prevote['fps']:.2f}, off "
          f"{screened['fps']:.2f} ({smi})")
    check(len(prevote["matched"]) == len(exact["matched"]) and not diffs,
          "pre-vote and exact assignments differ")
    prevote_launches = prevote["launches"]
    del prevote

    # (a): K5 (b) in its three forms on 64 frames' stacked query prefixes
    # against the index (every case of ``screen_cases`` checked, then
    # timed), and the pre-vote's candidates of those 64 frames: the kernels'
    # against the plain versions'.
    dev = torch.device("cuda")
    index = screened["engine"].index
    di = index.desc_index
    n_slides, kps_per = index.pts.shape[0], index.pts.shape[1]
    frames = [f for _, fs in runs for f in fs][:cfg.video.batch_size]
    front = [orb_matcher._frame_features(torch.from_numpy(f).to(dev), cfg) for f in frames]
    qdesc = torch.stack([
        hamming.screen_queries(ft.desc, ft.score, ft.valid, cfg.match) for ft, _ in front
    ])
    prefixes = qdesc[..., :cuda_screen.SCREEN_BITS].reshape(-1, cuda_screen.SCREEN_BITS).contiguous()
    print(f"[K5b] prefixes {tuple(prefixes.shape)} x index {n_slides}x{kps_per}")
    per_frame = cfg.match.screen_queries
    cases = screen_cases(torch, prefixes, per_frame, di, n_slides, kps_per, pv_cfg.match)
    errs = check_screen(torch, cases, "csrc/screen.cu")
    pv_cand = hamming.screen_slides_batched(qdesc, di, n_slides, kps_per, pv_cfg.match)
    hamming.screen_scores = cuda_screen.screen_scores_plain
    try:
        plain_cand = hamming.screen_slides_batched(qdesc, di, n_slides, kps_per, pv_cfg.match)
    finally:
        hamming.screen_scores = cuda_screen.screen_scores
    same = torch.equal(pv_cand, plain_cand)
    print(f"[prevote] candidates {tuple(pv_cand.shape)} of {len(frames)} frames: kernels == plain "
          f"versions {same}")
    check(same, "the pre-vote's candidates differ from those of the plain versions")
    forms = ("", "strided ", "listed ")
    row_cases = {f"{form}{n}" for form in forms for n in (f"{len(frames)} frames", "one frame")}
    for label, query, di_, n_s, k_, stride, ids, _ in cases:
        if label not in row_cases:   # the kernel rows below time these
            time_screen(torch, label, query, di_, n_s, k_, smi, plain=False, stride=stride,
                        ids=ids)

    by_label = {c[0]: c for c in cases}
    form_of = {c[0]: "listed " if c[6] is not None else "strided " if c[5] != 1 else ""
               for c in cases}

    def k5b_row(name: str, replaces: str, form: str) -> dict:
        """The kernel row of one form (its 64-frame case, beside the library
        product in the strided form, whose 8.4 GB product fits the card;
        and its one-frame case beside the library product); max_abs_err
        over the form's cases."""
        many, one = by_label[f"{form}{len(frames)} frames"], by_label[f"{form}one frame"]
        ms, dev_ms, cost = time_screen(torch, many[0], *many[1:5], smi,
                                       library=form == "strided ", stride=many[5], ids=many[6])
        o_ms, o_dev, o_cost = time_screen(torch, one[0], *one[1:5], smi, library=True,
                                          stride=one[5], ids=one[6])
        return kernel_row(
            name, "screen.cu", replaces, max(e for lb, e in errs.items() if form_of[lb] == form),
            ms, dev_ms, cost,
            one_frame=dict(max_abs_err=errs[one[0]], ms=o_ms["kernel"], device_ms=o_dev["kernel"],
                           plain_ms=o_ms["plain"], **o_cost, library_ms=o_ms["library"],
                           library_device_ms=o_dev["library"]),
        )

    rows = [k5b_row("screen_scores", "slideo_tpu/ops/pallas_table.py:143", ""),
            k5b_row("screen_prevote_strided", "slideo_tpu/ops/hamming.py:564", "strided "),
            k5b_row("screen_prevote_listed", "slideo_tpu/ops/hamming.py:584", "listed ")]
    for r in rows:
        print_row(r, smi)

    # (b): K5 (a) over the first frame's candidate slides (stage 2), both
    # query buckets, and at Q=2048 over all 500 slides (the exact run's table).
    cand = hamming.screen_slides_batched(qdesc[:1], di, n_slides, kps_per, cfg.match)[0]
    fmeta = features.pyramid_meta(*FRAME_HW, cfg.orb)
    atlas = features.build_pyramid(torch.from_numpy(frames[0]).to(dev).float(), cfg.orb)
    fkps = features.detect_pyramid(atlas, fmeta, cfg.orb)
    for q in (768, cfg.orb.max_keypoints):
        query = features.describe(atlas, fmeta, fkps, q, cfg.orb).desc.contiguous()
        label = f"Q={q} x {cand.shape[0]} listed slides {cand.tolist()}"
        check_table(torch, label, query, di, n_slides, kps_per, cand)
        time_table(torch, label, query, di, n_slides, kps_per, cand, smi)
    check_table(torch, f"Q={q} x {n_slides} slides", query, di, n_slides, kps_per)
    time_table(torch, f"Q={q} x {n_slides} slides", query, di, n_slides, kps_per, None, smi)
    screened.update(deck=deck, runs=runs)
    return rows, [screened["launches"], prevote_launches], exact, screened


def mesh_devices(torch) -> list:
    """Every visible card, or two entries of cuda:0 on a machine with one."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [torch.device("cuda", 0)] * 2


def phase_mesh(torch, deck: np.ndarray, runs, seed: int, smi: str, slice_out: dict,
               exact: dict) -> tuple[dict, dict, dict]:
    """(a) frame DP through the engine, (b) the index-parallel step on the
    500-slide index. Returns K5 (c)'s kernel row and the launches of (a)
    and (b)."""
    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import features, hamming
    from slideo_tpu_torch.parallel import mesh as pmesh

    cfg = DEFAULT_CONFIG
    devs = mesh_devices(torch)

    # (a): frame DP, phase 4's deck and stream.
    dp = drive_engine(torch, cfg, deck, runs, seed, smi, "mesh-dp", mesh_devices=devs)
    check(dp["engine"].mesh is not None and dp["engine"].mesh.size == len(devs),
          "the engine did not take the frame-parallel mesh")
    check(dp["timeline"] == slice_out["timeline"], "the frame-DP timeline differs from phase 4's")
    check(dp["matched"] == slice_out["matched"], "the frame-DP assignments differ from phase 4's")
    for name in ("fast", "orb", "table", "warp", "ransac"):
        check(dp["launches"][name] > 0, f"kernel {name} was never launched by the frame-DP run")

    # (b): the exact run's index over a 1 x 2 ("frames", "index") mesh.
    index = exact["engine"].index
    n_slides, kps_per = index.pts.shape[0], index.pts.shape[1]
    mesh = pmesh.Mesh(np.array(devs[:2], dtype=object).reshape(1, 2), ("frames", "index"))
    shards = pmesh.shard_index(mesh, index)
    idx = [i for i, _ in exact["matched"]]
    want = [-1 if page is None else page for _, page in exact["matched"]]
    frames = torch.from_numpy(np.stack([exact["frames"][i] for i in idx])).to("cuda")
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pmesh.match_frames_mesh(frames, idx, shards, mesh=mesh, slide_hw=FRAME_HW, cfg=cfg)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    ip = dict(_kernels.launches)
    got = res.slide.tolist()
    diffs = [(i, a, b) for i, a, b in zip(idx, got, want) if a != b]
    print(f"[mesh-index] {mesh}: {len(idx)} frames x {n_slides} slides in {t_mesh:.3f} s "
          f"({len(idx) / t_mesh:.2f} frames/s, {smi}); kernel launches {ip}; "
          f"{len(diffs)} differences from the exact run {diffs}")
    check(not diffs, "index-parallel assignments differ from the exact run's")
    check(ip["table"] == 2 * len(idx), f"expected {2 * len(idx)} shard tables, got {ip['table']}")
    for name in ("fast", "orb", "warp"):
        check(ip[name] > 0, f"kernel {name} was never launched by the index-parallel run")

    # The gathered table against table.cu over all 500 slides, and one
    # shard's launch against its plain version, on a matched frame's queries.
    frame = frames[[i for i, w in enumerate(want) if w >= 0][0]].float()
    query = features.extract_features(frame, cfg.orb).desc.contiguous()
    gathered = pmesh.mesh_table(query, list(shards[0]))
    full = hamming.match_table(query, index.desc_index, n_slides, kps_per)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(gathered, f), getattr(full, f))
               for f in ("dist", "train", "valid", "slide_ids"))
    print(f"[mesh-index] gathered table {tuple(gathered.dist.shape)} bit-equal to the "
          f"{n_slides}-slide table: {same}")
    check(same, "the gathered shard tables differ from the table over all slides")
    sdi = shards[0, 0].desc_index
    s_local = sdi.desc.shape[0] // kps_per
    label = f"shard of {s_local} slides"
    err = check_table(torch, label, query, sdi, s_local, kps_per)
    ms, dev_ms = time_table(torch, label, query, sdi, s_local, kps_per, None, smi)
    row = kernel_row("match_table_shard", "table.cu", "slideo_tpu/ops/hamming.py:293", err, ms,
                     dev_ms, table_bound(query.shape[0], s_local, kps_per))
    print_row(row, smi)
    return row, dp["launches"], ip


def fast_batch_case(torch, label: str, atlases, threshold: int, smi: str) -> dict:
    """Hold K2 on a [B, H, W] batch bit-equal to B K1 launches and to its
    plain version, and time the three; returns ``kernel_row``'s keyword
    arguments and the candidate share."""
    from slideo_tpu_torch.ops import cuda_fast

    b = atlases.shape[0]
    k2 = cuda_fast.fast_score_map_batch(atlases, threshold)
    k1 = torch.stack([cuda_fast.fast_score_map(a, threshold) for a in atlases])
    plain = cuda_fast.fast_score_map_batch_plain(atlases, threshold)
    torch.cuda.synchronize()
    err = float((k2 - plain).abs().max())
    cost, share = fast_bound(atlases, threshold)
    print(f"[K2] {label} {tuple(atlases.shape)} {atlases.dtype}: corners {int((k2 > 0).sum())}, "
          f"candidate share {share:.4f}, bit-equal to {b} K1 launches {torch.equal(k2, k1)}, "
          f"to the plain version {torch.equal(k2, plain)}")
    check(torch.equal(k2, k1), f"K2 is not bit-equal to per-frame K1 launches ({label})")
    check(torch.equal(k2, plain), f"K2 is not bit-equal to its plain version ({label})")
    del k1, k2, plain
    kernel = lambda: cuda_fast.fast_score_map_batch(atlases, threshold)  # noqa: E731
    ms = cuda_ms({
        "kernel": kernel,
        "k1": lambda: [cuda_fast.fast_score_map(a, threshold) for a in atlases],
        "plain": lambda: cuda_fast.fast_score_map_batch_plain(atlases, threshold),
    }, reps=3)
    dev_ms = device_ms({"kernel": kernel}, ms, reps=3)
    print(f"[time] fast_nms_batch {label}: K2 call {ms['kernel']:.4f} ms, device "
          f"{dev_ms['kernel']:.4f} ms; {b} K1 launches {ms['k1']:.4f} ms; plain {ms['plain']:.4f} "
          f"ms; bound {cost['bound_ms']:.4f} ms ({cost['bound_by']}) at candidate share "
          f"{share:.4f} ({smi})")
    return dict(err=err, ms=ms, dev=dev_ms, cost=cost, candidate_share=share)


def phase_fast_batch(torch, deck: np.ndarray, runs, seed: int, smi: str) -> tuple[dict, dict]:
    """K2 on the deck's 64 page atlases and on 8 corner-dense atlases (the
    pyramids of uniform-noise frames), then the stage profile. Returns K2's
    kernel row and the profile run's launches."""
    from slideo_tpu_torch import DEFAULT_CONFIG, _kernels
    from slideo_tpu_torch.ops import features
    from slideo_tpu_torch.tools import profile_stages

    cfg = DEFAULT_CONFIG
    thr = cfg.orb.fast_threshold
    dev = torch.device("cuda")
    pyramid = lambda img: features.build_pyramid(torch.from_numpy(img).to(dev).float(), cfg.orb)  # noqa: E731
    atlases = torch.stack([pyramid(p) for p in deck])
    k2 = fast_batch_case(torch, f"deck of {len(deck)}", atlases, thr, smi)
    del atlases
    rng = np.random.RandomState(seed + 3)
    dense = torch.stack([pyramid(rng.randint(0, 256, FRAME_HW).astype(np.uint8)) for _ in range(8)])
    k2["dense"] = regime(fast_batch_case(torch, "8 corner-dense", dense, thr, smi))
    del dense
    row = kernel_row("fast_nms_batch", "fast.cu", "slideo_tpu/ops/pallas_fast.py:340", **k2)
    print_row(row, smi)

    frames = np.stack([f for _, fs in runs for f in fs][:4 * 8])
    _kernels.reset_launches()
    torch.cuda.synchronize()
    profile_stages.profile(deck, frames, 8, cfg, report=lambda line: print(f"{line} ({smi})"))
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    print(f"[profile] kernel launches {launches}")
    for name in ("fast", "fast_batch", "orb", "table", "warp"):
        check(launches[name] > 0, f"kernel {name} was never launched by the stage profile")
    return row, launches


def homography_4pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3 x 3 homography (h8 = 1) taking the 4 points src to dst."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a += [[x, y, 1, 0, 0, 0, -u * x, -u * y], [0, 0, 0, x, y, 1, -v * x, -v * y]]
        b += [u, v]
    return np.append(np.linalg.solve(np.array(a, np.float64), np.array(b, np.float64)), 1.0).reshape(3, 3)


def perspective(torch, page: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The page as an off-axis camera sees it: each corner moved by up to
    4% of the width, sampled bilinearly on the card (float32, 230 outside
    the page, before noise)."""
    h, w = FRAME_HW
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    dst = src + rng.uniform(-0.04 * w, 0.04 * w, (4, 2))
    hi = torch.tensor(np.linalg.inv(homography_4pt(src, dst)), dtype=torch.float64, device="cuda")
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float64),
                            torch.arange(w, device="cuda", dtype=torch.float64), indexing="ij")
    den = hi[2, 0] * xs + hi[2, 1] * ys + hi[2, 2]
    u = (hi[0, 0] * xs + hi[0, 1] * ys + hi[0, 2]) / den
    v = (hi[1, 0] * xs + hi[1, 1] * ys + hi[1, 2]) / den
    inside = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    grid = torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1], dim=-1).float()[None]
    img = torch.from_numpy(page).to("cuda").float()[None, None]
    out = torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=True)[0, 0]
    return torch.where(inside, out, 230.0).cpu().numpy()


def make_sift_stream(torch, rng: np.random.RandomState, deck: np.ndarray, n_runs: int = 12):
    """Runs of 2 sampled frames, each a slide in perspective with noise of
    sigma 1.5, and a noise and a blank run after the 4th and 9th."""
    runs: list[tuple[int | None, list[np.ndarray]]] = []
    for i, s in enumerate(rng.permutation(len(deck))[:n_runs].tolist()):
        runs.append((s, [with_noise(perspective(torch, deck[s], rng), rng, 1.5) for _ in range(2)]))
        if i in (3, 8):
            runs.append((None, [rng.randint(0, 256, FRAME_HW).astype(np.uint8) for _ in range(2)]))
            runs.append((None, [np.full(FRAME_HW, 128, np.uint8) for _ in range(2)]))
    return runs


def make_sift_family_stream(torch, rng: np.random.RandomState, deck: np.ndarray, n_families: int = 8):
    """``make_screened_stream`` in perspective: three adjacent members of
    each of ``n_families`` families, two frames each (each its own camera
    pose), and a noise and a blank run after the 3rd and 6th family."""
    runs: list[tuple[int | None, list[np.ndarray]]] = []
    for i, fam in enumerate(rng.permutation(len(deck) // PER_FAMILY)[:n_families].tolist()):
        first = rng.randint(0, PER_FAMILY - 2)
        for j in range(first, first + 3):
            s = fam * PER_FAMILY + j
            runs.append((s, [with_noise(perspective(torch, deck[s], rng), rng, 1.5) for _ in range(2)]))
        if i in (2, 5):
            runs.append((None, [rng.randint(0, 256, FRAME_HW).astype(np.uint8) for _ in range(2)]))
            runs.append((None, [np.full(FRAME_HW, 128, np.uint8) for _ in range(2)]))
    return runs


def sift_stage_split(torch, engine, frames: list[np.ndarray], cfg, smi: str, tag: str) -> None:
    """Per-frame device-timeline ms of the stages of ``match_frame_sift``
    (features, table with stage 1 when screened, select + RANSAC, verify),
    between CUDA events, medians over ``frames``."""
    from slideo_tpu_torch.models import sift_matcher
    from slideo_tpu_torch.ops import ransac

    names = ("features", "table", "select+ransac", "verify")
    times = {n: [] for n in names}
    for i, f in enumerate(frames):
        fr = torch.from_numpy(f).to("cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        feats, small = sift_matcher.frame_features(fr, cfg)
        ev[1].record()
        table = sift_matcher.sift_table(feats, engine.index, cfg)
        ev[2].record()
        u = ransac.uniform_draws(min(cfg.match.top_slides, table.dist.shape[1]), cfg.match, i,
                                 fr.device, n_points=4)
        rated = sift_matcher.rate_candidates(feats, table, engine.index, u, cfg)
        ev[3].record()
        sift_matcher.verify_winner(small, FRAME_HW, rated, engine.index, engine.slide_hw, cfg)
        ev[4].record()
        ev[4].synchronize()
        for k, n in enumerate(names):
            times[n].append(ev[k].elapsed_time(ev[k + 1]))
    med = {n: float(np.median(t)) for n, t in times.items()}
    print(f"[{tag}] stage split of match_frame_sift, median ms/frame over {len(frames)} frames: "
          + ", ".join(f"{n} {m:.3f}" for n, m in med.items())
          + f"; sum {sum(med.values()):.3f} ({smi})")


def phase_sift(torch, deck: np.ndarray, seed: int, smi: str) -> tuple[list[dict], dict]:
    """(a) the SIFT engine on phase 4's deck, (b) screened == exact on the
    first 250 slides of phase 5's reveal deck (made again from phase 5's
    seed, so no earlier phase holds it); returns the three runs' launches,
    (a)'s first, and (a)'s run with its runs of frames."""
    import dataclasses

    from slideo_tpu_torch import DEFAULT_CONFIG

    cfg = dataclasses.replace(DEFAULT_CONFIG, engine="sift")
    rng = np.random.RandomState(seed + 4)
    t0 = time.perf_counter()
    runs = make_sift_stream(torch, rng, deck)
    print(f"[sift64] {sum(len(f) for _, f in runs)} perspective frames made in "
          f"{time.perf_counter() - t0:.2f} s")
    a = drive_engine(torch, cfg, deck, runs, seed, smi, "sift64")
    check(a["launches"]["warp_homography"] > 0, "K6h was never launched by the SIFT run")
    check(a["launches"]["warp"] == 0, "the SIFT run launched the similarity form of K6")
    sift_stage_split(torch, a["engine"], [f for _, fs in runs[:8] for f in fs[:1]], cfg, smi, "sift64")
    launches = [a["launches"]]
    a["runs"] = runs

    deck250 = make_reveal_deck(np.random.RandomState(seed + 1), SIFT_SLIDES // PER_FAMILY)
    runs = make_sift_family_stream(torch, rng, deck250)
    check(len(deck250) > cfg.match.screen_above_slides, "the 250-slide deck does not take stage 1")
    screened = drive_engine(torch, cfg, deck250, runs, seed, smi, "sift250", strict=False)
    sift_stage_split(torch, screened["engine"], [f for _, fs in runs[:8] for f in fs[:1]], cfg,
                     smi, "sift250")
    screened["engine"] = None
    exact_cfg = dataclasses.replace(
        cfg, match=dataclasses.replace(cfg.match, screen_above_slides=len(deck250) + 1))
    exact = drive_engine(torch, exact_cfg, deck250, runs, seed, smi, "sift250-exact", strict=False)
    exact["engine"] = None
    diffs = [(x, y) for x, y in zip(screened["matched"], exact["matched"]) if x != y]
    print(f"[sift250] screened vs exact assignments: {len(screened['matched'])} frames, "
          f"{len(diffs)} differences {diffs}")
    check(len(screened["matched"]) == len(exact["matched"]) and not diffs,
          "SIFT screened and exact assignments differ")
    for run in (screened, exact):
        check(run["launches"]["warp_homography"] > 0, "K6h was never launched by a 250-slide SIFT run")
    return launches + [screened["launches"], exact["launches"]], a


def write_png(path: Path, gray: np.ndarray) -> None:
    """An 8-bit greyscale PNG of ``gray`` [H, W] uint8, made with zlib and
    struct alone (the card's machine has no image codec): filter 0 on every
    row, zlib level 1."""
    h, w = gray.shape
    raw = np.zeros((h, w + 1), np.uint8)
    raw[:, 1:] = gray

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_pages(deck: np.ndarray, folder: Path, pdf_hash: str) -> list:
    """The deck's pages as PNG files ``p-N.png`` in ``folder`` (in 8
    threads: zlib releases the GIL), as the port's ``PdfPage`` records."""
    from concurrent.futures import ThreadPoolExecutor

    from slideo_tpu_torch.app.pipeline import PdfPage

    folder.mkdir(parents=True)
    paths = [folder / f"p-{i + 1}.png" for i in range(len(deck))]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_png, paths, deck))
    return [PdfPage(folder / "deck.pdf", pdf_hash, p, i + 1) for i, p in enumerate(paths)]


def cache_case(torch, tag: str, cfg, deck: np.ndarray, pages: list, cold: dict, seed: int,
               smi: str, strict: bool = True) -> dict:
    """One deck's index cache round trip: the cold run's index saved under
    the key of ``pages`` (PNG files of ``deck``) by the pipeline's own
    functions, a warm ``MatchingEngine`` from those files that must load
    it and launch no kernel, the two indexes compared, and the cold run's
    frames through the warm engine, which must give the cold run's rows
    exactly. Returns the warm run (``drive_engine``'s result)."""
    from slideo_tpu_torch import _kernels
    from slideo_tpu_torch.app import pipeline
    from slideo_tpu_torch.app.pipeline import MatchingEngine

    sift = cfg.engine == "sift"
    save = pipeline._save_sift_index if sift else pipeline._save_orb_index
    key = pipeline._index_cache_key(pages, cfg, "cuda:0")
    c = cold["engine"]
    pipeline.LAST_BUILD_BREAKDOWN.clear()
    torch.cuda.synchronize()
    save(key, c.index, c.slide_hw)
    saved = dict(pipeline.LAST_BUILD_BREAKDOWN)
    mb = pipeline._index_path(key).stat().st_size / 1e6

    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = MatchingEngine(cfg, pages, device="cuda:0", mesh_devices=["cuda:0"])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launched = {k: v for k, v in _kernels.launches.items() if v}
    loaded = dict(pipeline.LAST_LOAD_BREAKDOWN)
    check(not pipeline.LAST_BUILD_BREAKDOWN and set(loaded) == {"read_s", "upload_assemble_s"},
          f"{tag}: the warm engine did not load its index ({pipeline.LAST_BUILD_BREAKDOWN})")
    check(not launched, f"{tag}: the warm engine launched kernels while it loaded: {launched}")
    check(warm.slide_hw == c.slide_hw, f"{tag}: warm slide_hw {warm.slide_hw} != {c.slide_hw}")

    w = warm.index
    if sift:
        for f in ("valid", "pts", "scale"):
            check(torch.equal(getattr(w, f), getattr(c.index, f)), f"{tag}: warm {f} differs")
        # f16 keeps 11 significant bits: 2^-11 apart in [0.5, 1), the unit
        # descriptors' largest values; a rounding moves a value half that.
        desc_err = (w.desc - c.index.desc).abs().max().item()
        check(desc_err <= 2.0 ** -11, f"{tag}: warm desc off by {desc_err}")
    else:
        for f in ("desc", "valid", "slide_ids", "train_ids"):
            check(torch.equal(getattr(w.desc_index, f), getattr(c.index.desc_index, f)),
                  f"{tag}: warm {f} differs")
        check(torch.equal(w.pts, c.index.pts), f"{tag}: warm pts differ")
        desc_err = 0.0
    small_err = (w.smalls - c.index.smalls).abs().max().item()
    check(small_err <= 0.0625, f"{tag}: warm thumbnails off by {small_err} (> 0.0625)")

    run = drive_engine(torch, cfg, deck, cold["runs"], seed, smi, f"warm-{tag}", engine=warm,
                       strict=strict)
    for name in ("warp_homography",) if sift else ("fast", "orb", "table", "warp", "ransac"):
        check(run["launches"][name] > 0, f"kernel {name} was never launched by the warm {tag} run")
    check(run["matched"] == cold["matched"], f"{tag}: the warm engine's rows differ from the cold run's")
    check(run["timeline"] == cold["timeline"], f"{tag}: the warm timeline differs from the cold one")
    b = cold["build"]
    print(f"[cache] {tag}: {len(deck)} slides, archive {mb:.3f} MB; cold extract_s "
          f"{b['extract_s']:.4f}, save_fetch_s {saved['save_fetch_s']:.4f}, save_write_s "
          f"{saved['save_write_s']:.4f}; warm read_s {loaded['read_s']:.4f}, upload_assemble_s "
          f"{loaded['upload_assemble_s']:.4f}, constructor {t_warm:.4f} s (page hashes included); "
          f"desc err {desc_err:.3g}, thumbnail err {small_err:.4f}; {len(run['matched'])} rows equal "
          f"to the cold run's ({smi})")
    return run


def check_viewer(torch, db_dir: Path, slice_out: dict, page_file: Path) -> None:
    """The viewer's server over phase 4's store: its matchings in the JSON
    shape of the JAX package's ``/pdf-matchings`` (rows computed here from
    the timeline), a byte range of one page file, the port's index.html."""
    import threading
    import urllib.request

    from slideo_tpu_torch.app import web
    from slideo_tpu_torch.app.db import Db
    from slideo_tpu_torch.app.hashing import hash_file

    pdf_hash, video_hash = slice_out["pdf_hash"], slice_out["video_hash"]
    db_path = db_dir / "slideo.db"
    file_hash = hash_file(page_file)
    with Db(db_path) as db:
        db.update_hashes([(str(page_file), file_hash)])
    rows = slice_out["timeline"]
    want = [dict(video_offset_ms=ms, pdf_hash=pdf_hash, video_hash=video_hash, page_idx=page,
                 duration_ms=rows[i + 1][0] - ms if i + 1 < len(rows) else 5000)
            for i, (ms, page) in enumerate(rows) if page is not None]
    srv = web.make_server(db_path, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/pdf-matchings/{pdf_hash}", timeout=30) as r:
            got = json.loads(r.read())
        check(got == want, f"viewer: /pdf-matchings rows {got} != {want}")
        req = urllib.request.Request(f"{base}/files/{file_hash}", headers={"Range": "bytes=100-199"})
        with urllib.request.urlopen(req, timeout=30) as r:
            status, body, crange = r.status, r.read(), r.headers["Content-Range"]
        size = page_file.stat().st_size
        check(status == 206 and body == page_file.read_bytes()[100:200]
              and crange == f"bytes 100-199/{size}", f"viewer: /files range {status} {crange}")
        with urllib.request.urlopen(f"{base}/", timeout=30) as r:
            index_html = r.read()
        check(index_html == (web.STATIC_DIR / "index.html").read_bytes()
              and web.STATIC_DIR.parent.parent.name == "slideo_tpu_torch",
              "viewer: / does not serve the port's index.html")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    print(f"[viewer] /pdf-matchings/{pdf_hash[:12]}..: {len(got)} rows as the JAX package's JSON; "
          f"/files range 100-199 of {size} bytes: 206; /: the port's index.html")


def phase_cache(torch, seed: int, smi: str, work: Path, slice_deck: np.ndarray, slice_runs,
                slice_out: dict, screened: dict, sift64: dict, db_dir: Path) -> list[dict]:
    """Phase 9: the index cache of phases 4, 5 and 8 (a)'s decks and the
    viewer over phase 4's store; returns the warm runs' launches."""
    import dataclasses
    import tempfile

    from slideo_tpu_torch import DEFAULT_CONFIG

    old_tmp = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(work / "tmp")   # the pipeline's archives go here
    (work / "tmp").mkdir()
    tempfile.tempdir = None
    try:
        t0 = time.perf_counter()
        pages64 = write_pages(slice_deck, work / "deck64", slice_out["pdf_hash"])
        pages500 = write_pages(screened["deck"], work / "deck500", screened["pdf_hash"])
        print(f"[cache] {len(pages64) + len(pages500)} page PNGs written in "
              f"{time.perf_counter() - t0:.2f} s (host)")
        runs = [
            cache_case(torch, "orb64", DEFAULT_CONFIG, slice_deck, pages64,
                       dict(slice_out, runs=slice_runs), seed, smi),
            cache_case(torch, "orb500", DEFAULT_CONFIG, screened["deck"], pages500, screened, seed,
                       smi),
            cache_case(torch, "sift64", dataclasses.replace(DEFAULT_CONFIG, engine="sift"),
                       slice_deck, pages64, sift64, seed, smi),
        ]
        check_viewer(torch, db_dir, slice_out, pages64[0].image_path)
    finally:
        if old_tmp is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = old_tmp
        tempfile.tempdir = None
    return [r["launches"] for r in runs]


def prefix_case(torch, label: str, query, di, n_slides: int, k: int, n_slots: int, bits: int,
                smi: str, library: bool = True) -> dict:
    """One case of the per-frame rule's prefix table: the kernel that
    ``hamming.screen_slides_frame`` launches at ``bits`` (K5 (b)'s prefix
    form up to 128 bits; K5 (a) over the first ``n_slots`` slots above, the
    query zero past the prefix, ``best`` only) held bit-equal to its plain
    version on ``query[:, :bits]`` over the first ``n_slots`` slots of each
    of the ``n_slides`` slides, then timed: call ms of both, device ms of
    the kernel and, with ``library``, call and device ms of
    ``torch._int_mm`` of the product alone (the query zero-padded to the
    kernel's width, the slots' prefixes gathered into a contiguous copy
    outside the timing; no mask, no max), which the port never calls.
    Returns the case's numbers (``ms``, ``dev``, ``cost``, ``err``, a
    summary)."""
    import torch.nn.functional as F

    from slideo_tpu_torch.ops import cuda_screen, cuda_table

    q = query[:, :bits].contiguous()
    if bits <= cuda_screen.SCREEN_BITS:
        source, width = "screen.cu", 64 if bits <= 64 else 128
        kernel = lambda: cuda_screen.screen_scores(  # noqa: E731
            q, di.desc, di.valid, n_slides, k, n_slots=n_slots)
        plain = lambda: cuda_screen.screen_scores_plain(  # noqa: E731
            q, di.desc, di.valid, n_slides, k, n_slots=n_slots)
    else:
        source, width = "table.cu", 256
        qp = F.pad(q, (0, width - bits))
        kernel = lambda: cuda_table.match_table_scores(  # noqa: E731
            qp, di.desc, di.valid, n_slides, k, n_slots=n_slots)[0]
        plain = lambda: cuda_table.match_table_scores_plain(  # noqa: E731
            qp, di.desc, di.valid, n_slides, k, n_slots=n_slots)[0]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    print(f"[K5 prefix] {label}: {source}, query {tuple(q.shape)} x {n_slides} slides x the "
          f"first {n_slots} of {k} slots: bit-equal {same}")
    check(same, f"the per-frame prefix table ({source}, {label}) is not bit-equal to its plain "
                "version")
    fns = {"kernel": kernel, "plain": plain}
    if library:
        lq = F.pad(q, (0, width - bits))
        pre_t = di.desc.view(n_slides, k, -1)[:, :n_slots, :width].reshape(-1, width).contiguous().T
        fns["library"] = lambda: torch._int_mm(lq, pre_t)
    ms = cuda_ms(fns, reps=5)
    dev = device_ms({n: f for n, f in fns.items() if n != "plain"}, ms, reps=5)
    cost = screen_bound(q.shape[0], n_slides, n_slots, n_slides, bits)
    lib = (f"; torch._int_mm call {ms['library']:.4f} ms, device {dev['library']:.4f} ms"
           if library else "")
    print(f"[time] prefix table {label}: kernel call {ms['kernel']:.4f} ms, device "
          f"{dev['kernel']:.4f} ms; plain {ms['plain']:.4f} ms{lib}; bound {cost['bound_ms']:.4f} "
          f"ms ({cost['bound_by']}) ({smi})")
    summary = dict(case=label, source=f"slideo_tpu_torch/csrc/{source}", rows=q.shape[0],
                   n_slots=n_slots, prefix_bits=bits, max_abs_err=err, ms=ms["kernel"],
                   device_ms=dev["kernel"], plain_ms=ms["plain"], **cost,
                   library_ms=ms.get("library"), library_device_ms=dev.get("library"))
    return dict(ms=ms, dev=dev, cost=cost, err=err, summary=summary)


def frame_queries(torch, frame, cfg):
    """A frame's per-frame stage-1 query rows, as ``screen_slides_frame``
    picks them: its features at its query bucket, the ``screen_queries``
    rows of highest raw score, full width."""
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import top_k

    feats, _ = orb_matcher._frame_features(torch.from_numpy(frame).to("cuda"), cfg)
    return feats.desc[top_k(feats.score, min(cfg.match.screen_queries, feats.desc.shape[0]))[1]]


def phase_frame_screen(torch, seed: int, smi: str, screened: dict,
                       exact_matched: list) -> tuple[dict, list[dict]]:
    """Phase 10: the per-frame stage-1 rule. (a) Its prefix table against
    the plain version on phase 5's index and on the adversarial index at K =
    1000; (b) the engine on phase 5's deck and frames at 64-bit prefixes and
    at K = 2000 trimmed to 512 slots. Returns the kernel row of the prefix
    form and the two runs' launches."""
    import dataclasses

    from slideo_tpu_torch import DEFAULT_CONFIG
    from slideo_tpu_torch.models import orb_matcher
    from slideo_tpu_torch.ops import cuda_screen, cuda_table, hamming

    cfg = DEFAULT_CONFIG
    dev = torch.device("cuda")
    deck, runs = screened["deck"], screened["runs"]
    index = screened["engine"].index
    di = index.desc_index
    n_slides, kps_per = index.pts.shape[0], index.pts.shape[1]
    frames = [f for _, fs in runs for f in fs]
    many = torch.cat([frame_queries(torch, f, cfg) for f in frames[:cfg.video.batch_size]])
    one = many[:cfg.match.screen_queries]
    n_many = many.shape[0] // cfg.match.screen_queries
    cases = {}
    for n_slots, bits in PREFIX_SETTINGS:
        for label, q in (("one frame", one), (f"{n_many} frames", many)):
            cases[f"{label}, {n_slots} slots, {bits} bits"] = prefix_case(
                torch, f"{label}, {n_slots} slots, {bits} bits", q, di, n_slides, kps_per,
                n_slots, bits, smi, library=q is one)
    query, desc, valid, _ = adversarial_table(3, k=1000)
    adv = hamming.build_index(torch.from_numpy(desc).to(dev), torch.from_numpy(valid).to(dev))
    aq = torch.from_numpy(query).to(dev)
    for n_slots, bits in ((512, 128), (1000, 64), (333, 100), (512, 200)):
        label = f"adversarial K=1000, {n_slots} slots, {bits} bits"
        cases[label] = prefix_case(torch, label, aq, adv, desc.shape[0], 1000, n_slots, bits, smi)
    main_case = cases["one frame, 512 slots, 128 bits"]
    row = kernel_row("screen_prefix", "screen.cu", "slideo_tpu/ops/hamming.py:288",
                     max(c["err"] for c in cases.values()), main_case["ms"], main_case["dev"],
                     main_case["cost"], cases=[c["summary"] for c in cases.values()])
    print_row(row, smi)
    del many, adv

    exact = dict(exact_matched)
    settings = {
        "frame64": dataclasses.replace(
            cfg, match=dataclasses.replace(cfg.match, screen_bits=64)),
        "frame2000": dataclasses.replace(
            cfg, orb=dataclasses.replace(cfg.orb, max_keypoints=2000),
            match=dataclasses.replace(cfg.match, screen_k_per_slide=512)),
    }
    launches = []
    for tag, run_cfg in settings.items():
        out = drive_engine(torch, run_cfg, deck, runs, seed, smi, tag, gate=False)
        got = out["launches"]
        check(got["screen_prefix"] > 0 and got["table"] > 0,
              f"{tag}: the per-frame rule's kernels were not launched")
        check(got["screen"] == got["screen_strided"] == got["screen_listed"] == 0,
              f"{tag}: the run went through the batched rule")
        index = out["engine"].index
        k = index.pts.shape[1]
        check(k == run_cfg.orb.max_keypoints, f"{tag}: K = {k}")
        same = 0
        for f in frames:
            feats, _ = orb_matcher._frame_features(torch.from_numpy(f).to(dev), run_cfg)
            args = (feats.desc, feats.score, index.desc_index, n_slides, k, run_cfg.match)
            cand = hamming.screen_slides_frame(*args)
            hamming.screen_scores = cuda_screen.screen_scores_plain
            hamming.match_table_scores = cuda_table.match_table_scores_plain
            try:
                plain = hamming.screen_slides_frame(*args)
            finally:
                hamming.screen_scores = cuda_screen.screen_scores
                hamming.match_table_scores = cuda_table.match_table_scores
            same += torch.equal(cand, plain)
        diffs = [(i, page, exact.get(i)) for i, page in out["matched"] if exact.get(i) != page]
        print(f"[{tag}] per-frame candidates, kernels == plain versions on {same} of "
              f"{len(frames)} frames; {out['fps']:.2f} frames/s; {len(diffs)} of "
              f"{len(out['matched'])} assignments differ from phase 5's exact run {diffs} ({smi})")
        check(same == len(frames), f"{tag}: the kernels' candidates differ from the plain "
                                   "versions'")
        launches.append(got)
        del out, index
    return row, launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic deck and stream")
    ap.add_argument("--profiler-check", action="store_true",
                    help="only cross-check K5's device ms with torch.profiler, then exit")
    ap.add_argument("--compare-fast", nargs="+", metavar="SOURCE",
                    help="only time these versions of csrc/fast.cu against each other, then exit")
    ap.add_argument("--compare-screen", nargs="+", metavar="SOURCE",
                    help="only check and time these versions of csrc/screen.cu against each "
                         "other, then exit")
    ap.add_argument("--compare-orb", nargs="+", metavar="SOURCE",
                    help="only check and time these versions of csrc/orb.cu against each "
                         "other, then exit")
    ap.add_argument("--compare-ransac", nargs="+", metavar="SOURCE",
                    help="only check and time these versions of csrc/ransac.cu against the "
                         "plain version and each other, then exit")
    args = ap.parse_args()

    import torch

    t_start = time.perf_counter()
    smi = phase_environment(torch)
    phase_build()
    if args.profiler_check:
        phase_profiler_check(torch, smi)
        return
    if args.compare_fast:
        phase_compare_fast(torch, args.compare_fast, args.seed, smi)
        return
    if args.compare_screen:
        phase_compare_screen(torch, args.compare_screen, args.seed, smi)
        return
    if args.compare_orb:
        phase_compare_orb(torch, args.compare_orb, args.seed, smi)
        return
    if args.compare_ransac:
        phase_compare_ransac(torch, args.compare_ransac, args.seed, smi)
        return
    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    deck = make_deck(rng, N_SLIDES)
    runs = make_stream(rng, deck)
    print(f"[data] deck {deck.shape} and {sum(len(f) for _, f in runs)} frames made in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        rows = phase_kernels(torch, deck, runs[0][1][0], args.seed, smi)
        slice_out = phase_slice(torch, deck, runs, args.seed, smi, work / "db")
        screen_rows, screened_launches, exact, screened = phase_screened(torch, args.seed, smi)
        shard_row, dp_launches, ip_launches = phase_mesh(
            torch, deck, runs, args.seed, smi, slice_out, exact)
        exact_matched = exact["matched"]
        del exact
        k2_row, profile_launches = phase_fast_batch(torch, deck, runs, args.seed, smi)
        sift_launches, sift64 = phase_sift(torch, deck, args.seed, smi)
        cache_launches = phase_cache(torch, args.seed, smi, work, deck, runs, slice_out, screened,
                                     sift64, work / "db")
        prefix_row, frame_launches = phase_frame_screen(torch, args.seed, smi, screened,
                                                        exact_matched)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rows += [*screen_rows, shard_row, k2_row, prefix_row]
    # Each kernel's launches over every path of this run; the table
    # launches of the index-parallel step are K5 (c)'s.
    paths = [slice_out["launches"], *screened_launches, dp_launches, ip_launches, profile_launches,
             *sift_launches, *cache_launches, *frame_launches]
    counted = {name: sum(p[name] for p in paths) for name in paths[0]}
    counted["table"] -= ip_launches["table"]
    by_name = {"fast_nms": "fast", "orb_describe": "orb", "match_table": "table",
               "warp_sample": "warp", "screen_scores": "screen", "fast_nms_batch": "fast_batch",
               "warp_sample_homography": "warp_homography",
               "screen_prevote_strided": "screen_strided", "screen_prevote_listed": "screen_listed",
               "screen_prefix": "screen_prefix", "ransac_similarity": "ransac"}
    for r in rows:
        r["launches"] = (ip_launches["table"] if r["name"] == "match_table_shard"
                         else counted[by_name[r["name"]]])
        check(r["launches"] > 0, f"kernel {r['name']} was launched by no path of this run")
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s ({smi})")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
