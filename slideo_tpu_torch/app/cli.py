"""The ``slideo`` command line of the port: ``python -m slideo_tpu_torch``.

Port of ``slideo_tpu/app/cli.py`` (reference crates/app/src/main.rs):
positional FILES (pdfs and videos mixed), the same flags, the cache-driven
skip logic with its prompts (main.rs:177-234), and the viewer's start when
exactly one PDF is given (main.rs:97-100).

The engine runs on the CUDA card. ``SLIDEO_PLATFORM=cpu``, the JAX
package's switch, runs it on the CPU instead; any other value is refused.
Without a visible card and without that switch the command exits
non-zero: it never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import torch

from ..config import DEFAULT_CONFIG
from ..parallel.mesh import initialize_distributed
from ..utils.trace import StageTracer
from .checked_path import CheckedPath, Kind
from .db import Db
from .hashing import hash_files
from .pipeline import pdfs_to_images, sync
from .progress import TerminalProgress
from .web import start_server

__all__ = ["build_parser", "main"]


def _confirm(prompt: str) -> bool:
    reply = input(f"{prompt} [y/N] ").strip().lower()
    return reply in ("y", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slideo",
        description="Synchronize PDF slides with videos (CUDA engine). "
        "If only a single pdf is passed, opens a viewer.",
    )
    p.add_argument("files", nargs="+", type=Path, metavar="FILES",
                   help="videos and pdfs to process")
    p.add_argument("--invalidate-video-cache", action="store_true",
                   help="invalidate cached mapping entries for the given files")
    p.add_argument("--non-interactive", "-n", action="store_true",
                   help="do not wait for user input")
    p.add_argument("--no-server", action="store_true",
                   help="never start the viewer server")
    p.add_argument("--port", type=int, default=63944)
    p.add_argument("--interval", type=float, default=None,
                   help="frame sampling interval in seconds (default 5)")
    p.add_argument("--decode-mode", choices=["grab", "chunk", "seek"], default=None,
                   help="video decode strategy (grab=reference-exact; chunk="
                        "parallel segmented grab, same frames; seek=per-"
                        "sample seeking, needs dense keyframes)")
    p.add_argument("--trace", action="store_true",
                   help="print per-stage timing after processing")
    p.add_argument("--exact", action="store_true",
                   help="full fidelity mode: exact Hamming matching against "
                        "every slide (no screening), dense verification "
                        "grid, and the reference's full RANSAC hypothesis "
                        "budget; slower on decks beyond ~100 slides")
    p.add_argument("--engine", choices=["orb", "sift"], default=None,
                   help="feature engine: orb (reference-faithful, default) or "
                        "sift (scale-invariant + homography, for camera "
                        "recordings with perspective)")
    return p


def _device() -> str:
    """"cpu" under ``SLIDEO_PLATFORM=cpu``, else "cuda"; raises
    RuntimeError for another value or when no card is visible."""
    platform = os.environ.get("SLIDEO_PLATFORM")
    if platform == "cpu":
        return "cpu"
    if platform:
        raise RuntimeError(
            f"SLIDEO_PLATFORM={platform!r}: this engine runs on a CUDA card, or on the "
            "CPU with SLIDEO_PLATFORM=cpu"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; set SLIDEO_PLATFORM=cpu to run on the CPU"
        )
    return "cuda"


def _config(args: argparse.Namespace):
    cfg = DEFAULT_CONFIG
    if args.interval is not None:
        cfg = dataclasses.replace(
            cfg, video=dataclasses.replace(cfg.video, interval_s=args.interval)
        )
    if args.decode_mode is not None:
        cfg = dataclasses.replace(
            cfg, video=dataclasses.replace(cfg.video, decode_mode=args.decode_mode)
        )
    if args.engine is not None:
        cfg = dataclasses.replace(cfg, engine=args.engine)
    if args.exact:
        # No screening, the reference's dense verification grid and its
        # RANSAC budget (image_utils.rs:52 max_iters=2000).
        cfg = dataclasses.replace(
            cfg,
            match=dataclasses.replace(
                cfg.match, screen_above_slides=1 << 30, verify_stride=1, ransac_iters=2048,
            ),
        )
    return cfg


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = _device()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    # Multi-host runs: a no-op unless torchrun's WORLD_SIZE > 1.
    initialize_distributed()
    cfg = _config(args)

    try:
        checked = [CheckedPath.from_path(f) for f in args.files]
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for c in checked:
        if not c.path.exists():
            print(f"error: file '{c.path}' does not exist", file=sys.stderr)
            return 1

    for c, h in zip(checked, hash_files([c.path for c in checked])):
        c.hash = h
    with Db() as db:
        return _run(args, cfg, device, checked, db)


def _run(args: argparse.Namespace, cfg, device: str, checked: list[CheckedPath], db: Db) -> int:
    """Sync the videos that need it, then serve the viewer when one PDF is
    given and the run is interactive."""
    db.update_hashes([(str(c.path.resolve()), c.hash) for c in checked])
    pdfs = [c for c in checked if c.kind == Kind.PDF]
    videos = [c for c in checked if c.kind == Kind.VIDEO]

    # Decide which videos need (re)processing (main.rs:177-234).
    videos_to_process = []
    pdf_hashes = {c.hash for c in pdfs}
    for v in videos:
        existing = db.find_mapping_info(v.hash)
        if existing is not None and not args.invalidate_video_cache:
            if not existing.finished:
                if args.non_interactive or _confirm(
                    f"Video '{v.path}' is currently being processed. Recompute?"
                ):
                    videos_to_process.append(v)
                else:
                    print("Skipping Video.")
            elif not pdf_hashes.issubset(set(existing.pdf_hashes)):
                if args.non_interactive:
                    print(
                        f"Recomputing Video '{v.path}', as it has been analyzed "
                        "with different pdfs."
                    )
                    videos_to_process.append(v)
                elif _confirm(
                    f"Video '{v.path}' has been cached, but different pdfs are "
                    "provided now. Recompute?"
                ):
                    videos_to_process.append(v)
                else:
                    print("Skipping Video.")
            else:
                print(f"Video '{v.path}' has already been cached, skipping.")
        else:
            videos_to_process.append(v)

    if videos_to_process:
        bar = TerminalProgress()
        pages = pdfs_to_images([(c.path, c.hash) for c in pdfs], db, bar.get_reporter())
        bar.finish()
        if not pages:
            print("error: no slide pages — pass at least one pdf", file=sys.stderr)
            return 1
        for v in videos_to_process:
            db.create_or_reset_video(v.hash, sorted(pdf_hashes))
        bar = TerminalProgress()
        tracer = StageTracer(enabled=args.trace)
        sync(
            pages, [(v.path, v.hash) for v in videos_to_process], db, cfg,
            bar.get_reporter(), tracer, device=device,
        )
        bar.finish()
        if args.trace:
            print(tracer.summary())

    if not args.non_interactive and not args.no_server and len(pdfs) == 1:
        # Viewer-only flow (`slideo lecture.pdf`): extract the pages up front
        # (cached; near-instant when already extracted). The server also
        # extracts on demand for a known PDF dropped on the viewer.
        from ..io.pdf import have_poppler

        pdf = pdfs[0]
        rec = db.get_pdf_extracted_pages_dir(pdf.hash)
        if (rec is None or not rec.finished) and have_poppler():
            bar = TerminalProgress()
            pdfs_to_images([(pdf.path, pdf.hash)], db, bar.get_reporter())
            bar.finish()
        start_server(pdf.hash, db.path, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
