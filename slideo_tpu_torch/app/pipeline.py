"""End-to-end sync: slide deck + videos -> (video_ms -> page) timelines.

Port of ``slideo_tpu/app/pipeline.py`` for both engines: ORB (the
default) and SIFT (``SlideoConfig(engine="sift")``, for camera-recorded
talks seen in perspective). The deck is indexed on the device once: page
images decode in a worker thread one chunk of 32 pages ahead of the
device build, so the whole deck never sits in host memory, and the built
index is kept in an npz archive under the temporary directory
(``_index_cache_key``), so the next run on the same pages loads it instead
of building. Sampled frames stream through in ``VideoConfig.batch_size`` batches, a
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
import os
import random
import string
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..config import DEFAULT_CONFIG, SlideoConfig
from ..io import pdf as pdf_io
from ..models import orb_matcher, sift_matcher
from ..ops import hamming
from ..ops import image as image_ops
from ..parallel import mesh as mesh_mod
from ..utils.trace import DISABLED, StageTracer
from .db import Db, PdfExtractedPagesDir
from .hashing import get_temp_path_key, hash_files, hash_str
from .progress import ComposedProgressReporter, ProgressReporter, null_reporter

__all__ = [
    "PdfPage", "Matching", "pdfs_to_images", "MatchingEngine", "CudaImageVideoMatcher", "sync",
    "LAST_BUILD_BREAKDOWN", "LAST_LOAD_BREAKDOWN",
]


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


def _png_size(path: Path) -> tuple[int, int] | None:
    """(h, w) from a PNG's IHDR header without decoding the image, or None."""
    try:
        with open(path, "rb") as f:
            head = f.read(26)
    except OSError:
        return None
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        w = int.from_bytes(head[16:20], "big")
        h = int.from_bytes(head[20:24], "big")
        if h > 0 and w > 0:
            return h, w
    return None


def _read_gray(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"Could not read file '{path}'")
    return img


def _letterbox_hw(paths: list[Path]) -> tuple[int, int]:
    """The common letterbox size of a deck's pages: from PNG headers
    (pdftocairo writes PNGs), decoding a page only when it is no PNG."""
    if not paths:
        raise ValueError("a deck needs at least one page")
    h = w = 0
    for path in paths:
        size = _png_size(path) or _read_gray(path).shape
        h, w = max(h, size[0]), max(w, size[1])
    return h, w


def _iter_page_chunks(paths: list[Path], hw: tuple[int, int], chunk: int):
    """The pages as letterboxed [c, h, w] uint8 batches of ``chunk`` pages
    (top-left, zero fill), each decoded in a worker thread while the
    caller builds the previous one on the device (OpenCV releases the GIL
    while it decodes)."""
    h, w = hw

    def load(c0: int) -> np.ndarray:
        sub = paths[c0:c0 + chunk]
        batch = np.zeros((len(sub), h, w), np.uint8)
        for i, path in enumerate(sub):
            img = _read_gray(path)
            batch[i, :img.shape[0], :img.shape[1]] = img
        return batch

    starts = list(range(0, len(paths), chunk))
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load, starts[0])
        for nxt in starts[1:] + [None]:
            batch = fut.result()
            if nxt is not None:
                fut = pool.submit(load, nxt)
            yield batch


# Bump when a change invalidates persisted slide indexes (the features,
# the descriptors, the archive's layout).
_INDEX_FORMAT_VERSION = 2

# The archive's arrays, by engine: those of the JAX package's archives.
_ORB_ARRAYS = ("desc_bits", "valid", "pts", "smalls_f16", "slide_hw", "k_per_slide")
_SIFT_ARRAYS = ("desc_f16", "valid", "pts", "scale", "smalls_f16", "slide_hw")

# Wall-clock seconds of the newest engine construction (bench diagnostics,
# the JAX package's keys), cleared by every construction. A build fills
# LAST_BUILD_BREAKDOWN: "extract_s" (page decode, upload and feature
# extraction, which overlap), and when it read the pages from files
# "hash_key_s", "letterbox_s", "save_s" and, from the save,
# "save_fetch_s" (pack and fetch) and "save_write_s". A load fills
# LAST_LOAD_BREAKDOWN: "read_s" and "upload_assemble_s". On CUDA each
# clock is read after a synchronize, so a time covers its device work.
LAST_BUILD_BREAKDOWN: dict[str, float] = {}
LAST_LOAD_BREAKDOWN: dict[str, float] = {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _index_cache_key(pages: list, cfg: SlideoConfig, device: torch.device | str) -> str:
    """Content key of a persisted slide index (``pipeline.py:205-225``):
    the format version, this package, the device type, on CUDA the digest
    of the kernel sources, the engine, its config, the thumbnail area and
    the pages' content hashes. The describe kernel K3+K4 agrees with its
    plain CPU version on 99.98% of bits, not all, and a kernel change moves
    bits too: an index is served only to the device type and the kernel
    sources that built it. The package name keeps every key apart from the
    JAX package's. The letterbox size follows from the pages; the archive
    stores it."""
    device = torch.device(device)
    backend = [device.type] + ([_kernels.source_digest()] if device.type == "cuda" else [])
    parts = [
        f"v{_INDEX_FORMAT_VERSION}",
        "slideo_tpu_torch",
        *backend,
        cfg.engine,
        repr(cfg.sift if cfg.engine == "sift" else cfg.orb),
        str(cfg.video.small_image_area),
        *hash_files([p.get_path() for p in pages]),
    ]
    return hash_str("|".join(parts))


def _index_path(key: str) -> Path:
    return get_temp_path_key("index", key) / "index.npz"


def _write_archive(key: str, arrays: dict[str, np.ndarray]) -> float:
    """Write the archive under a name of this process, then rename it into
    place (atomic: a reader sees the old file or the whole new one, and
    concurrent writers of one key never share an inode). Returns the
    seconds taken."""
    t0 = time.perf_counter()
    target = _index_path(key)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"index.npz.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(target)
    return time.perf_counter() - t0


def _read_archive(key: str, names: tuple[str, ...], check) -> dict[str, np.ndarray] | None:
    """The archive's arrays, or None when there is none or it is bad: one
    that raises what a truncated, foreign or inconsistent file raises
    (``check`` raises ValueError on shapes that do not fit). Nothing else
    is caught: an error of the device after the read is raised."""
    path = _index_path(key)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            arrays = {name: np.ascontiguousarray(z[name]) for name in names}
        check(arrays)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
    return arrays


def _fit(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"index archive: {what}")


def _save_orb_index(key: str, index: orb_matcher.SlideIndex, slide_hw: tuple[int, int]) -> None:
    """Persist an ORB index (``pipeline.py:228-286``): descriptors and
    validity as bits packed on the device (32 MB for 500 slides against
    262 MB raw), thumbnails as float16 (within 0.0625 on the 0..255
    scale), pts as float32 (subpixel coordinates up to ~2048 px exceed
    f16's mantissa)."""
    t0 = time.perf_counter()
    di = index.desc_index
    s, k = index.pts.shape[:2]
    desc_bits, valid_bits = hamming.pack_descriptor_bits(di.desc, di.valid, s, k)
    arrays = dict(
        desc_bits=desc_bits.cpu().numpy(),
        valid=valid_bits.cpu().numpy(),
        pts=index.pts.cpu().numpy(),
        smalls_f16=index.smalls.to(torch.float16).cpu().numpy(),
        slide_hw=np.asarray(slide_hw, np.int32),
        k_per_slide=np.asarray([k], np.int32),
    )
    t_fetch = time.perf_counter() - t0
    LAST_BUILD_BREAKDOWN.update(save_fetch_s=t_fetch, save_write_s=_write_archive(key, arrays))


def _load_orb_index(
    key: str, device: torch.device
) -> tuple[orb_matcher.SlideIndex, tuple[int, int]] | None:
    """A persisted ORB index on ``device``, or None (``pipeline.py:353-405``).
    Only the packed bits, the f16 thumbnails and pts cross to the device;
    the bits unpack there and ``hamming.build_index`` assembles the index."""

    def check(a: dict) -> None:
        db, pts = a["desc_bits"], a["pts"]
        _fit(db.ndim == 3 and pts.ndim == 3 and db.shape[:2] == pts.shape[:2], "desc_bits / pts")
        s, k = pts.shape[:2]
        _fit(a["k_per_slide"].shape == (1,) and int(a["k_per_slide"][0]) == k, "k_per_slide")
        _fit(a["valid"].shape == (s, -(-k // 8)) and a["smalls_f16"].shape[0] == s, "valid / smalls")
        _fit(a["slide_hw"].shape == (2,), "slide_hw")

    t0 = time.perf_counter()
    a = _read_archive(key, _ORB_ARRAYS, check)
    if a is None:
        return None
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = lambda name: torch.from_numpy(a[name]).to(device)  # noqa: E731
    desc, valid = hamming.unpack_descriptor_bits(up("desc_bits"), up("valid"), a["pts"].shape[1])
    index = orb_matcher.SlideIndex(
        desc_index=hamming.build_index(desc, valid), pts=up("pts"),
        smalls=up("smalls_f16").to(torch.float32),
    )
    _sync(device)
    LAST_LOAD_BREAKDOWN.update(read_s=t_read, upload_assemble_s=time.perf_counter() - t0)
    return index, tuple(int(v) for v in a["slide_hw"])


def _save_sift_index(key: str, index: sift_matcher.SiftSlideIndex, slide_hw: tuple[int, int]) -> None:
    """Persist a SIFT index (``pipeline.py:289-314``): descriptors and
    thumbnails as float16 (unit descriptors lose ~1e-3 relative; matching
    ranks dot products), validity packed to bits on the device."""
    t0 = time.perf_counter()
    arrays = dict(
        desc_f16=index.desc.to(torch.float16).cpu().numpy(),
        valid=hamming.pack_bits(index.valid).cpu().numpy(),
        pts=index.pts.cpu().numpy(),
        scale=index.scale.cpu().numpy(),
        smalls_f16=index.smalls.to(torch.float16).cpu().numpy(),
        slide_hw=np.asarray(slide_hw, np.int32),
    )
    t_fetch = time.perf_counter() - t0
    LAST_BUILD_BREAKDOWN.update(save_fetch_s=t_fetch, save_write_s=_write_archive(key, arrays))


def _load_sift_index(
    key: str, device: torch.device
) -> tuple[sift_matcher.SiftSlideIndex, tuple[int, int]] | None:
    """A persisted SIFT index on ``device``, or None (``pipeline.py:317-339``);
    the f16 arrays cast to float32 on the device."""

    def check(a: dict) -> None:
        pts, desc = a["pts"], a["desc_f16"]
        _fit(pts.ndim == 3 and desc.ndim == 2, "pts / desc_f16")
        n = pts.shape[0] * pts.shape[1]
        _fit(desc.shape[0] == n and a["valid"].shape == (-(-n // 8),), "desc_f16 / valid")
        _fit(a["scale"].shape == pts.shape[:2] and a["smalls_f16"].shape[0] == pts.shape[0],
             "scale / smalls")
        _fit(a["slide_hw"].shape == (2,), "slide_hw")

    t0 = time.perf_counter()
    a = _read_archive(key, _SIFT_ARRAYS, check)
    if a is None:
        return None
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = lambda name: torch.from_numpy(a[name]).to(device)  # noqa: E731
    index = sift_matcher.SiftSlideIndex(
        desc=up("desc_f16").to(torch.float32),
        valid=hamming.unpack_bits(up("valid"), a["desc_f16"].shape[0]).to(torch.bool),
        pts=up("pts"), scale=up("scale"), smalls=up("smalls_f16").to(torch.float32),
    )
    _sync(device)
    LAST_LOAD_BREAKDOWN.update(read_s=t_read, upload_assemble_s=time.perf_counter() - t0)
    return index, tuple(int(v) for v in a["slide_hw"])


class MatchingEngine:
    """Device-resident matcher for one deck of slides, with the engine
    ``cfg.engine`` names ("orb" or "sift")."""

    # Pages per decoded chunk and upload of the index build (bounds host
    # and device memory).
    _BUILD_CHUNK = 32
    # The tracer of the running ``_match_records``, which ``match_batch``
    # hands to the ORB matcher.
    _tracer: StageTracer = DISABLED

    def __init__(
        self,
        cfg: SlideoConfig,
        pages: list[PdfPage],
        device: torch.device | str = "cuda",
        page_grays: np.ndarray | None = None,
        mesh_devices: list[torch.device | str] | None = None,
    ):
        """Index the deck on ``device``.

        Without ``page_grays`` the engine loads the deck's index from the
        archive of an earlier run on the same page files, config and device
        type (``_index_cache_key``), or else builds it from the page files,
        decoded 32 at a time, and saves it for the next run (rank 0 only;
        best effort: an ``OSError`` leaves the built index in use).
        page_grays: the pages as a letterboxed [S, H, W] uint8 array in page
        order; the engine builds from it and neither reads nor writes the
        archive, as a key would name files it did not read.
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
        LAST_BUILD_BREAKDOWN.clear()
        LAST_LOAD_BREAKDOWN.clear()
        # The resizes, similarities, SIFT's blurs and its float table are f32
        # products and convolutions: TF32 would move them off the
        # reference's numbers.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.pages = pages
        self.device = torch.device(device)
        sift = cfg.engine == "sift"
        self._match_frames = sift_matcher.match_frames_sift if sift else orb_matcher.match_frames
        if page_grays is None:
            self.index, self.slide_hw = self._load_or_build()
        else:
            if page_grays.ndim != 3 or page_grays.shape[0] != len(pages) or page_grays.dtype != np.uint8:
                raise ValueError(
                    f"page images: expected [{len(pages)}, H, W] uint8, got "
                    f"{page_grays.shape} {page_grays.dtype}"
                )
            self.slide_hw = (int(page_grays.shape[1]), int(page_grays.shape[2]))
            t0 = time.perf_counter()
            self.index = self._build(
                page_grays[c:c + self._BUILD_CHUNK] for c in range(0, len(pages), self._BUILD_CHUNK)
            )
            _sync(self.device)
            LAST_BUILD_BREAKDOWN.update(extract_s=time.perf_counter() - t0)
        self.mesh = _frame_mesh(self.device, mesh_devices)
        self._replicas = (
            None if self.mesh is None else mesh_mod.replicate_index(self.mesh, self.index)
        )

    def _build(self, chunks):
        if self.cfg.engine == "sift":
            return sift_matcher.build_slide_index_sift_from_chunks(chunks, self.cfg, self.device)
        return orb_matcher.build_slide_index_from_chunks(chunks, self.cfg, self.device)

    def _load_or_build(self):
        """(index, slide_hw) from the archive, or built from the page files
        and saved (``pipeline.py:420-481``)."""
        sift = self.cfg.engine == "sift"
        load, save = (_load_sift_index, _save_sift_index) if sift else (_load_orb_index, _save_orb_index)
        t0 = time.perf_counter()
        key = _index_cache_key(self.pages, self.cfg, self.device)
        t_key = time.perf_counter() - t0
        cached = load(key, self.device)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        paths = [p.get_path() for p in self.pages]
        slide_hw = _letterbox_hw(paths)
        t_box = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = self._build(_iter_page_chunks(paths, slide_hw, self._BUILD_CHUNK))
        _sync(self.device)
        t_extract = time.perf_counter() - t0
        t0 = time.perf_counter()
        if mesh_mod.rank() == 0:  # hosts on one disk would write the same file
            try:
                save(key, index, slide_hw)
            except OSError:
                pass
        LAST_BUILD_BREAKDOWN.update(
            hash_key_s=t_key, letterbox_s=t_box, extract_s=t_extract,
            save_s=time.perf_counter() - t0,
        )
        return index, slide_hw

    def match_batch(
        self, frames: torch.Tensor, frame_seeds: list[int]
    ) -> orb_matcher.FrameMatch:
        """Match a [n, H, W] batch on the engine's devices; fields come back
        [n]. On a mesh the batch is padded to a multiple of the mesh size
        with copies of the last frame under seed 0 (``pipeline.py:707-712``),
        and their results are dropped. On one device either matcher times
        its stages on the tracer of the running ``match_samples``; the mesh
        is timed as a whole."""
        if self.mesh is None:
            return self._match_frames(
                frames, frame_seeds, self.index, self.slide_hw, self.cfg, self._tracer
            )
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

    def match_images_with_video(
        self, video_path: Path, reporter: ProgressReporter = null_reporter
    ) -> "_VideoMatcherTask":
        """The ``VideoMatcher`` protocol: bind a video to this deck."""
        return _VideoMatcherTask(self, video_path, reporter)

    def _dedup(
        self, frames: torch.Tensor, prev_small: torch.Tensor | None,
        tracer: StageTracer = DISABLED,
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Thumbnails of a [B, H, W] batch and which frames changed against
        their predecessor (the first frame of a run always counts changed);
        ``tracer`` times "dedup.compare" (in a run's first batch with
        "sync.first", the host's write of the first similarity) and the read
        of the verdicts, "sync.verdict"."""
        cfg = self.cfg
        with tracer.stage("dedup.compare"):
            small_hw = image_ops.small_size(*frames.shape[1:], cfg.video.small_image_area)
            smalls = image_ops.resize(frames, small_hw, area=True)
            prev = torch.zeros_like(smalls[:1]) if prev_small is None else prev_small[None]
            sims = image_ops.compute_similarity(
                smalls, torch.cat([prev, smalls[:-1]]), channels=1
            )
            if prev_small is None:
                with tracer.stage("sync.first"):
                    sims[0] = 0.0
            changed = sims < cfg.video.dedup_similarity
        with tracer.stage("sync.verdict"):
            return smalls, changed.cpu().numpy()

    def match_samples(
        self,
        samples: Iterable[tuple[int, float, np.ndarray]],
        total_ms: int,
        total_frames: int,
        reporter: ProgressReporter = null_reporter,
        checkpoint=None,
        resume_state: tuple[list, int] | None = None,
        frames_total: int = 0,
        tracer: StageTracer | None = None,
    ) -> list[Matching]:
        """Match a stream of sampled frames; returns the cleaned timeline.

        samples: (frame_idx, time_s, gray [H, W] uint8) in frame order.
        total_ms / total_frames: the video's length (the sentinel record).
        checkpoint: callable(rows, last_frame_idx), rows = (frame_idx,
        video_ms, pdf_hash, page_idx 0-based), called after each batch with
        the newly decided frames. resume_state: (rows, last_frame_idx) from
        Db.load_partial_matchings; the caller's samples start after it.
        frames_total: the expected number of samples, for progress reports.
        tracer: times the engine's stages (see ``_match_records``); the
        program calls nothing on it but ``stage(name)``.
        """
        return _clean_timeline(self._match_records(
            samples, total_ms, total_frames, reporter, checkpoint, resume_state,
            frames_total, tracer,
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
        tracer: StageTracer | None,
    ) -> list[Matching]:
        """``match_samples`` before the timeline is cleaned: the sentinel
        record first, then every matched frame's record in match order.
        ``tracer`` times the stages "dedup" (with its children "dedup.stack",
        "sync.upload", "dedup.compare", itself holding "sync.first" in the
        first batch, and "sync.verdict"), "match.dispatch"
        (with the matcher's stages as children) and "match.fetch"
        (``pipeline.py:671-766``); the "sync.*" stages (the matcher's
        "sync.count" and "sync.pick" among them) and "match.fetch" are the
        host's reads of device results."""
        cfg = self.cfg
        tracer = tracer or DISABLED
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
                with tracer.stage("match.dispatch"):
                    res = self.match_batch(
                        torch.stack([f for _, f in chunk]), [s.frame_idx for s, _ in chunk]
                    )
                with tracer.stage("match.fetch"):
                    slides = res.slide.cpu().numpy()
                for (s, _), slide in zip(chunk, slides):
                    page = self.pages[slide] if slide >= 0 else None
                    results.append(Matching(int(s.time_s * 1000), s.frame_idx, page))

        def flush_dedup(force: bool = False):
            nonlocal batch, prev_small, processed, last_deduped
            if not batch or (len(batch) < bs and not force):
                return
            with tracer.stage("dedup"):
                with tracer.stage("dedup.stack"):
                    grays = torch.from_numpy(np.stack([b.gray for b in batch]))
                with tracer.stage("sync.upload"):   # pageable: returns once copied
                    frames = grays.to(self.device)
                smalls, changed = self._dedup(frames, prev_small, tracer)
            prev_small = smalls[-1]
            for i in np.nonzero(changed)[0]:
                pending.append((batch[i], frames[i]))
            processed += len(batch)
            last_deduped = batch[-1].frame_idx
            reporter(processed, max(frames_total, processed), "Processing frames...")
            batch = []
            flush_matches()
            save_checkpoint()

        self._tracer = tracer
        try:
            for sample in samples:
                batch.append(_Sample(*sample))
                flush_dedup()
            flush_dedup(force=True)
            flush_matches(force=True)
        finally:
            self._tracer = DISABLED
        save_checkpoint()
        reporter(processed, max(frames_total, processed), "Finished!")
        return results

    def match_video(
        self,
        video_path: Path,
        reporter: ProgressReporter = null_reporter,
        tracer: StageTracer | None = None,
        checkpoint=None,
        resume_state: tuple[list, int] | None = None,
    ) -> list[Matching]:
        """Decode and match one video (see ``match_samples``), in
        ``cfg.video.decode_mode`` over ``decode_workers`` threads; ``tracer``
        also times each frame's "decode".

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
        tracer = tracer or StageTracer(enabled=False)
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
            workers=cfg.video.decode_workers, start_after_frame=start_after,
        )

        def samples():
            while True:
                with tracer.stage("decode"):
                    sf = next(frames, None)
                if sf is None or (stop_after is not None and sf.frame_idx > stop_after):
                    return
                yield sf.frame_idx, sf.time_s, sf.gray

        with contextlib.closing(frames):
            results = self._match_records(
                samples(), int(info.total_time_s * 1000), info.total_frames, reporter,
                checkpoint, resume_state, frames_total, tracer,
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
    tracer: StageTracer | None = None,
    device: torch.device | str = "cuda",
    mesh_devices: list[torch.device | str] | None = None,
) -> None:
    """Match every video against the deck and persist the timelines,
    resuming a video from its checkpoint rows where it has them; progress
    over all videos goes to one ``reporter`` (progress.rs:5-36), stage
    times to ``tracer``. In a multi-host run every host holds the merged
    timeline and only rank 0 writes it (``pipeline.py:849-852``)."""
    engine = MatchingEngine(cfg, pages, device=device, mesh_devices=mesh_devices)
    composed = ComposedProgressReporter(reporter)
    nested = [composed.create_nested() for _ in videos]
    for (video_path, video_hash), video_reporter in zip(videos, nested):
        resume_state = db.load_partial_matchings(video_hash)

        def checkpoint(rows, last_frame_idx, _vh=video_hash):
            db.save_partial_matchings(_vh, rows, last_frame_idx)

        matchings = engine.match_video(
            video_path, video_reporter, tracer, checkpoint=checkpoint, resume_state=resume_state,
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


class _VideoMatcherTask:
    """One bound (deck x video) unit of work (reference: lib.rs:26-29)."""

    def __init__(self, engine: MatchingEngine, video_path: Path, reporter: ProgressReporter):
        self._engine = engine
        self._video_path = Path(video_path)
        self._reporter = reporter

    def process(self) -> list[Matching]:
        return self._engine.match_video(self._video_path, self._reporter)


class CudaImageVideoMatcher:
    """The port's engine behind the engine-neutral interface
    (``slideo_tpu_torch.matching``), the counterpart of the JAX package's
    ``TpuImageVideoMatcher`` (reference OpenCVImageVideoMatcher,
    crates/matching-opencv/src/lib.rs:34-75); on ``device``, a CUDA card
    unless the caller names the CPU."""

    def __init__(self, cfg: SlideoConfig | None = None, device: torch.device | str = "cuda"):
        self.cfg = cfg or DEFAULT_CONFIG
        self.device = device

    def create_video_matcher(self, images, reporter: ProgressReporter = null_reporter) -> MatchingEngine:
        reporter(0, len(images), "Analyzing PDF pages...")
        engine = MatchingEngine(self.cfg, list(images), device=self.device)
        reporter(len(images), len(images), "PDF page analysis successful.")
        return engine
