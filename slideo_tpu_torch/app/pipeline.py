"""End-to-end sync: slide deck + videos -> (video_ms -> page) timelines.

Port of ``slideo_tpu/app/pipeline.py`` for both engines: ORB (the
default) and SIFT (``SlideoConfig(engine="sift")``, for camera-recorded
talks seen in perspective). The deck is indexed on the device once;
sampled frames stream through in ``VideoConfig.batch_size`` batches, a
dedup pass on thumbnails drops frames that did not change (reference
lib.rs:205-209), and the changed ones are matched, on one device or over a frame-parallel mesh of several
(``parallel/mesh.py``). The output keeps the reference's contract: a
sentinel no-match record at the video end (lib.rs:182-189), sorted by time,
consecutive duplicates dropped (lib.rs:229-244). Rows are written through
``app.db.Db``, whose schema and file are the JAX package's.

In a multi-host run (``mesh.initialize_distributed``; or one process with
``SLIDEO_MULTIHOST=1``) each host decodes and matches one contiguous block
of the sampled frames, the hosts' records are gathered before the timeline
is cleaned, and only rank 0 writes the database.

``match_video`` decodes the video (OpenCV, imported only there) and hands
its samples to ``match_samples``, which takes any iterator of
``(frame_idx, time_s, gray uint8 [H, W])`` — a machine without a video
decoder can drive the engine through it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import string
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..config import SlideoConfig
from ..io import pdf as pdf_io
from ..models import orb_matcher, sift_matcher
from ..ops import image as image_ops
from ..parallel import mesh as mesh_mod
from .db import Db, PdfExtractedPagesDir
from .hashing import get_temp_path_key
from .progress import ComposedProgressReporter, ProgressReporter, null_reporter

__all__ = ["PdfPage", "Matching", "pdfs_to_images", "MatchingEngine", "sync"]


@dataclass(frozen=True)
class PdfPage:
    """One rasterized page (reference: pdf_to_images.rs:18-31)."""

    pdf_path: Path
    pdf_hash: str
    image_path: Path
    page_nr: int  # 1-based

    def get_path(self) -> Path:
        return self.image_path


@dataclass
class Matching:
    """Result record (reference: crates/matching/src/lib.rs:35-40)."""

    video_ms: int
    video_frame_idx: int
    page: PdfPage | None


class _Sample(NamedTuple):
    frame_idx: int
    time_s: float
    gray: np.ndarray


def pdfs_to_images(
    pdfs: list[tuple[Path, str]],
    db: Db,
    reporter: ProgressReporter = null_reporter,
) -> list[PdfPage]:
    """Rasterize PDFs through the two-phase extraction cache
    (reference: pdf_to_images.rs:33-111)."""
    pages: list[PdfPage] = []
    for pdf_path, pdf_hash in pdfs:
        cached = db.get_pdf_extracted_pages_dir(pdf_hash)
        if cached is not None and cached.finished and cached.dir.exists():
            target = cached.dir
        else:
            if not pdf_io.have_poppler():
                raise RuntimeError(
                    "poppler (pdftocairo/pdfinfo) not found on PATH and no "
                    f"finished extraction cached for {pdf_path}"
                )
            info = pdf_io.pdf_info(pdf_path)
            rand = "".join(random.choices(string.ascii_lowercase, k=8))
            target = get_temp_path_key("pdf", f"{pdf_hash}-{rand}")
            target.mkdir(parents=True, exist_ok=True)
            db.set_pdf_extracted_pages_dir(
                PdfExtractedPagesDir(pdf_hash, target, finished=False)
            )
            pdf_io.pdftocairo(
                pdf_path, target, progress=reporter, total_pages=info.pages
            )
            db.set_pdf_extracted_pages_dir(
                PdfExtractedPagesDir(pdf_hash, target, finished=True)
            )
        for page in pdf_io._scan_pages(target):
            pages.append(PdfPage(pdf_path, pdf_hash, page.image_path, page.page_nr))
    return pages


def _load_page_grays(pages: list[PdfPage]) -> np.ndarray:
    """Decode the page images as grayscale, letterboxed (top-left anchored,
    zero fill) into one [S, H, W] uint8 batch."""
    import cv2

    grays = []
    for p in pages:
        img = cv2.imread(str(p.get_path()), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"Could not read file '{p.get_path()}'")
        grays.append(img)
    h = max(g.shape[0] for g in grays)
    w = max(g.shape[1] for g in grays)
    batch = np.zeros((len(grays), h, w), np.uint8)
    for i, g in enumerate(grays):
        batch[i, : g.shape[0], : g.shape[1]] = g
    return batch


class MatchingEngine:
    """Device-resident matcher for one deck of slides, with the engine
    ``cfg.engine`` names ("orb" or "sift")."""

    # Pages per upload during the index build (bounds device memory).
    _BUILD_CHUNK = 32

    def __init__(
        self,
        cfg: SlideoConfig,
        pages: list[PdfPage],
        device: torch.device | str = "cuda",
        page_grays: np.ndarray | None = None,
        mesh_devices: list[torch.device | str] | None = None,
    ):
        """Index the deck on ``device``.

        page_grays: the pages as a letterboxed [S, H, W] uint8 array, in
        page order; when None the page images are decoded from disk.
        mesh_devices: the entries of a frame-parallel mesh (they may
        repeat); two or more turn the mesh on and replicate the index on
        each device. When None the engine runs on ``device`` alone, unless
        the environment's ``SLIDEO_MESH`` is ``on``, ``device`` is CUDA and
        more than one card is visible: then every visible card forms the
        mesh (``pipeline.py:483-501``). The switch is off by default, where
        the JAX package's is on, because this threaded mesh is slower than
        one card on every workload measured so far (PERF.md).
        """
        if cfg.engine not in ("orb", "sift"):
            raise ValueError(f"engine {cfg.engine!r}: expected 'orb' or 'sift'")
        # The resizes, similarities, SIFT's blurs and its float table are f32
        # products and convolutions: TF32 would move them off the
        # reference's numbers.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.pages = pages
        self.device = torch.device(device)
        grays = _load_page_grays(pages) if page_grays is None else page_grays
        if grays.ndim != 3 or grays.shape[0] != len(pages) or grays.dtype != np.uint8:
            raise ValueError(
                f"page images: expected [{len(pages)}, H, W] uint8, got "
                f"{grays.shape} {grays.dtype}"
            )
        self.slide_hw = (int(grays.shape[1]), int(grays.shape[2]))
        chunks = (
            grays[c:c + self._BUILD_CHUNK] for c in range(0, len(pages), self._BUILD_CHUNK)
        )
        if cfg.engine == "sift":
            self.index = sift_matcher.build_slide_index_sift_from_chunks(chunks, cfg, self.device)
            self._match_frames = sift_matcher.match_frames_sift
        else:
            self.index = orb_matcher.build_slide_index_from_chunks(chunks, cfg, self.device)
            self._match_frames = orb_matcher.match_frames
        self.mesh = _frame_mesh(self.device, mesh_devices)
        self._replicas = (
            None if self.mesh is None else mesh_mod.replicate_index(self.mesh, self.index)
        )

    def match_batch(
        self, frames: torch.Tensor, frame_seeds: list[int]
    ) -> orb_matcher.FrameMatch:
        """Match a [n, H, W] batch on the engine's devices; fields come back
        [n]. On a mesh the batch is padded to a multiple of the mesh size
        with copies of the last frame under seed 0 (``pipeline.py:707-712``),
        and their results are dropped."""
        if self.mesh is None:
            return self._match_frames(frames, frame_seeds, self.index, self.slide_hw, self.cfg)
        n = frames.shape[0]
        pad = -n % self.mesh.size
        if pad:
            frames = torch.cat([frames, frames[-1:].expand(pad, -1, -1)])
            frame_seeds = list(frame_seeds) + [0] * pad
        res = mesh_mod.match_frames_sharded(
            self.mesh, frames, frame_seeds, self._replicas, self.slide_hw, self.cfg,
            match_frames=self._match_frames,
        )
        return orb_matcher.FrameMatch(*(f[:n] for f in res))

    def _dedup(
        self, frames: torch.Tensor, prev_small: torch.Tensor | None
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Thumbnails of a [B, H, W] batch and which frames changed against
        their predecessor (the first frame of a run always counts changed)."""
        cfg = self.cfg
        small_hw = image_ops.small_size(*frames.shape[1:], cfg.video.small_image_area)
        smalls = image_ops.resize(frames, small_hw, area=True)
        prev = torch.zeros_like(smalls[:1]) if prev_small is None else prev_small[None]
        sims = image_ops.compute_similarity(
            smalls, torch.cat([prev, smalls[:-1]]), channels=1
        )
        if prev_small is None:
            sims[0] = 0.0
        return smalls, (sims < cfg.video.dedup_similarity).cpu().numpy()

    def match_samples(
        self,
        samples: Iterable[tuple[int, float, np.ndarray]],
        total_ms: int,
        total_frames: int,
        reporter: ProgressReporter = null_reporter,
        checkpoint=None,
        resume_state: tuple[list, int] | None = None,
        frames_total: int = 0,
    ) -> list[Matching]:
        """Match a stream of sampled frames; returns the cleaned timeline.

        samples: (frame_idx, time_s, gray [H, W] uint8) in frame order.
        total_ms / total_frames: the video's length (the sentinel record).
        checkpoint: callable(rows, last_frame_idx), rows = (frame_idx,
        video_ms, pdf_hash, page_idx 0-based), called after each batch with
        the newly decided frames. resume_state: (rows, last_frame_idx) from
        Db.load_partial_matchings; the caller's samples start after it.
        frames_total: the expected number of samples, for progress reports.
        """
        return _clean_timeline(self._match_records(
            samples, total_ms, total_frames, reporter, checkpoint, resume_state,
            frames_total,
        ))

    def _match_records(
        self,
        samples: Iterable[tuple[int, float, np.ndarray]],
        total_ms: int,
        total_frames: int,
        reporter: ProgressReporter,
        checkpoint,
        resume_state: tuple[list, int] | None,
        frames_total: int,
    ) -> list[Matching]:
        """``match_samples`` before the timeline is cleaned: the sentinel
        record first, then every matched frame's record in match order."""
        cfg = self.cfg
        results: list[Matching] = [
            Matching(video_ms=total_ms, video_frame_idx=total_frames, page=None)
        ]
        last_deduped = -1
        if resume_state is not None:
            by_key = {(p.pdf_hash, p.page_nr): p for p in self.pages}
            rows, last_deduped = resume_state
            for frame_idx, video_ms, pdf_hash, page_idx in rows:
                page = (
                    by_key.get((pdf_hash, page_idx + 1))
                    if pdf_hash is not None and page_idx is not None
                    else None
                )
                results.append(Matching(video_ms, frame_idx, page))

        bs = cfg.video.batch_size
        batch: list[_Sample] = []
        pending: list[tuple[_Sample, torch.Tensor]] = []  # changed, awaiting match
        prev_small: torch.Tensor | None = None
        processed = 0
        ckpt_cursor = len(results)

        def save_checkpoint():
            nonlocal ckpt_cursor
            if checkpoint is None:
                return
            # A frame is decided once deduped and, if it changed, matched.
            frontier = pending[0][0].frame_idx - 1 if pending else last_deduped
            new_rows = [
                (
                    m.video_frame_idx,
                    m.video_ms,
                    m.page.pdf_hash if m.page else None,
                    (m.page.page_nr - 1) if m.page else None,
                )
                for m in results[ckpt_cursor:]
                if m.video_frame_idx <= frontier
            ]
            ckpt_cursor = len(results)
            checkpoint(new_rows, frontier)

        def flush_matches(force: bool = False):
            nonlocal pending
            while pending and (len(pending) >= bs or force):
                chunk, pending = pending[:bs], pending[bs:]
                res = self.match_batch(
                    torch.stack([f for _, f in chunk]), [s.frame_idx for s, _ in chunk]
                )
                slides = res.slide.cpu().numpy()
                for (s, _), slide in zip(chunk, slides):
                    page = self.pages[slide] if slide >= 0 else None
                    results.append(Matching(int(s.time_s * 1000), s.frame_idx, page))

        def flush_dedup(force: bool = False):
            nonlocal batch, prev_small, processed, last_deduped
            if not batch or (len(batch) < bs and not force):
                return
            frames = torch.from_numpy(np.stack([b.gray for b in batch])).to(self.device)
            smalls, changed = self._dedup(frames, prev_small)
            prev_small = smalls[-1]
            for i in np.nonzero(changed)[0]:
                pending.append((batch[i], frames[i]))
            processed += len(batch)
            last_deduped = batch[-1].frame_idx
            reporter(processed, max(frames_total, processed), "Processing frames...")
            batch = []
            flush_matches()
            save_checkpoint()

        for sample in samples:
            batch.append(_Sample(*sample))
            flush_dedup()
        flush_dedup(force=True)
        flush_matches(force=True)
        save_checkpoint()
        reporter(processed, max(frames_total, processed), "Finished!")
        return results

    def match_video(
        self,
        video_path: Path,
        reporter: ProgressReporter = null_reporter,
        checkpoint=None,
        resume_state: tuple[list, int] | None = None,
    ) -> list[Matching]:
        """Decode and match one video (see ``match_samples``).

        In a multi-host run (world size > 1, or ``SLIDEO_MULTIHOST=1``) this
        host decodes only its block of the sampled frames
        (``mesh.host_frame_shard``), without checkpoint or resume (hosts
        would race on the DB), and every host's records are gathered before
        the timeline is sorted and its consecutive duplicates dropped, so
        every host returns the one-host timeline (``pipeline.py:595-613``,
        ``:779-808``).
        """
        from ..io.video import open_video_info, sampled_frames

        cfg = self.cfg
        info = open_video_info(video_path)
        frames_total = info.frames_to_process(cfg.video.interval_s)
        start_after = resume_state[1] if resume_state is not None else -1
        stop_after = None
        multihost = mesh_mod.world_size() > 1 or os.environ.get("SLIDEO_MULTIHOST") == "1"
        if multihost:
            checkpoint = resume_state = None
            stride = info.sample_stride(cfg.video.interval_s)
            mine = mesh_mod.host_frame_shard(list(range(0, info.total_frames, stride)))
            start_after = mine[0] - 1 if mine else info.total_frames
            stop_after = mine[-1] if mine else -1
            frames_total = max(len(mine), 1)
        frames = sampled_frames(
            video_path, cfg.video.interval_s, mode=cfg.video.decode_mode,
            start_after_frame=start_after,
        )
        with contextlib.closing(frames):
            samples = (
                (sf.frame_idx, sf.time_s, sf.gray)
                for sf in itertools.takewhile(
                    lambda sf: stop_after is None or sf.frame_idx <= stop_after, frames
                )
            )
            results = self._match_records(
                samples, int(info.total_time_s * 1000), info.total_frames, reporter,
                checkpoint, resume_state, frames_total,
            )
        if multihost:
            results[1:] = self._gather_hosts(results[1:])
        return _clean_timeline(results)

    def _gather_hosts(self, records: list[Matching]) -> list[Matching]:
        """Every host's records (all but the sentinel), host by host
        (``mesh.gather_host_matchings``); pages travel as their index."""
        pos = {id(p): i for i, p in enumerate(self.pages)}
        rows = [
            (m.video_frame_idx, m.video_ms, pos[id(m.page)] if m.page is not None else -1)
            for m in records
        ]
        return [
            Matching(ms, frame_idx, self.pages[page] if page >= 0 else None)
            for frame_idx, ms, page in mesh_mod.gather_host_matchings(rows)
        ]


def _frame_mesh(
    device: torch.device, mesh_devices: list[torch.device | str] | None
) -> mesh_mod.Mesh | None:
    """The engine's frame-parallel mesh, or None for one device."""
    if mesh_devices is None:
        if (
            device.type != "cuda"
            or torch.cuda.device_count() <= 1
            or os.environ.get("SLIDEO_MESH", "off") != "on"
        ):
            return None
        return mesh_mod.make_mesh()
    return mesh_mod.make_mesh(mesh_devices) if len(mesh_devices) >= 2 else None


def _clean_timeline(results: list[Matching]) -> list[Matching]:
    """Sort by time; drop consecutive duplicates (lib.rs:229-244)."""
    results = sorted(results, key=lambda m: m.video_ms)
    cleaned: list[Matching] = []
    for m in results:
        if cleaned and cleaned[-1].page == m.page:
            continue
        cleaned.append(m)
    return cleaned


def sync(
    pages: list[PdfPage],
    videos: list[tuple[Path, str]],
    db: Db,
    cfg: SlideoConfig,
    reporter: ProgressReporter = null_reporter,
    device: torch.device | str = "cuda",
    mesh_devices: list[torch.device | str] | None = None,
) -> None:
    """Match every video against the deck and persist the timelines,
    resuming a video from its checkpoint rows where it has them. In a
    multi-host run every host holds the merged timeline and only rank 0
    writes it (``pipeline.py:849-852``)."""
    engine = MatchingEngine(cfg, pages, device=device, mesh_devices=mesh_devices)
    composed = ComposedProgressReporter(reporter)
    nested = [composed.create_nested() for _ in videos]
    for (video_path, video_hash), video_reporter in zip(videos, nested):
        resume_state = db.load_partial_matchings(video_hash)

        def checkpoint(rows, last_frame_idx, _vh=video_hash):
            db.save_partial_matchings(_vh, rows, last_frame_idx)

        matchings = engine.match_video(
            video_path, video_reporter, checkpoint=checkpoint, resume_state=resume_state,
        )
        rows = [
            (
                m.video_ms,
                m.page.pdf_hash if m.page else None,
                (m.page.page_nr - 1) if m.page else None,
            )
            for m in matchings
        ]
        if mesh_mod.rank() == 0:
            db.finalize_video_matchings(video_hash, rows)
