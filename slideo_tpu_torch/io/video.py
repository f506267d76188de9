"""Host-side video decoding: one decoded frame per sampling interval.

Port of ``open_video_info`` and ``sampled_frames`` from
``slideo_tpu/io/video.py`` (reference crates/matching-opencv/src/
video_capture.rs): grab every frame header, decode only the frames where
``frame_idx % floor(fps * interval) == 0`` (video_capture.rs:52). Three
decode modes: "grab", the reference's sequential loop; "chunk", the same
frames from several segments decoded at once, one seek each; "seek", one
seek per sampled frame. Decoding runs in background threads, so it
overlaps the engine's device work. OpenCV is imported here and, lazily,
where page images are decoded.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from pathlib import Path
from queue import Full, Queue
from typing import Iterable, Iterator, NamedTuple

import cv2
import numpy as np

__all__ = ["VideoInfo", "SampledFrame", "open_video_info", "sampled_frames"]


@dataclass(frozen=True)
class VideoInfo:
    path: Path
    fps: float
    total_frames: int
    width: int
    height: int

    @property
    def total_time_s(self) -> float:
        return self.total_frames / self.fps if self.fps > 0 else 0.0

    def frames_to_process(self, interval_s: float) -> int:
        return int(self.total_time_s / interval_s)

    def sample_stride(self, interval_s: float) -> int:
        """floor(fps * interval): a frame is sampled iff idx % stride == 0."""
        return max(int(self.fps * interval_s), 1)


@dataclass
class SampledFrame:
    """One decoded sampled frame: gray [H, W] uint8 (OpenCV BGR weights)."""

    gray: np.ndarray
    time_s: float
    frame_idx: int


def open_video_info(path: Path) -> VideoInfo:
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"Could not open video '{path}'")
    info = VideoInfo(
        path=Path(path),
        fps=cap.get(cv2.CAP_PROP_FPS) or 0.0,
        total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
    )
    cap.release()
    return info


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 3:
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    return np.ascontiguousarray(frame)


def _sampled_frames_grab(
    path: Path, interval_s: float, start_after_frame: int
) -> Iterator[SampledFrame]:
    """The reference's loop (video_capture.rs:39-58): grab every frame,
    retrieve one per interval; frames <= start_after_frame are skipped
    (the checkpoint/resume path)."""
    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    stride = max(int(fps * interval_s), 1)
    if start_after_frame >= 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start_after_frame + 1)
    try:
        while True:
            frame_idx = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
            if not cap.grab():
                return
            if frame_idx % stride == 0 and frame_idx > start_after_frame:
                ok, frame = cap.retrieve()
                if not ok:
                    return
                yield SampledFrame(_to_gray(frame), frame_idx / fps, frame_idx)
    finally:
        cap.release()


class _Failed(NamedTuple):
    """The exception that ended a decode worker's iterator."""

    error: Exception


# Per-worker in-flight frames of "seek" and "chunk": at most workers x depth
# decoded frames (~2 MB each at 1080p) wait, however long the video is.
_SEEK_QUEUE_DEPTH = 8
_CHUNK_QUEUE_DEPTH = 32


def _sampled_indices(info: VideoInfo, interval_s: float, start_after_frame: int) -> list[int]:
    stride = info.sample_stride(interval_s)
    return [i for i in range(0, info.total_frames, stride) if i > start_after_frame]


def _in_order(jobs: list, order: Iterable[int], depth: int) -> Iterator[SampledFrame]:
    """Run each job (an iterator of frames) in its own thread behind a
    bounded queue, and yield the frames by taking one from job ``w``'s
    queue for each ``w`` of ``order``. A job that ends before its share
    (a failed read, as "grab" ends on one) ends the stream there. An
    exception a job raises reaches the consumer, raised where the stream
    would have ended: a decode error never passes for a normal end of the
    video."""
    stop = threading.Event()
    queues = [Queue(maxsize=depth) for _ in jobs]

    def put(q: Queue, item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except Full:
                continue

    def work(job, q: Queue) -> None:
        last = None
        try:
            for item in job:
                put(q, item)
                if stop.is_set():
                    return
        except Exception as e:  # handed to the consumer, which re-raises it
            last = _Failed(e)
        finally:
            if hasattr(job, "close"):  # a generator releases its capture
                job.close()
        put(q, last)

    for job, q in zip(jobs, queues):
        threading.Thread(target=work, args=(job, q), daemon=True).start()
    try:
        for w in order:
            item = queues[w].get()
            if item is None:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        stop.set()


def _prefetched(it: Iterator[SampledFrame], depth: int = 16) -> Iterator[SampledFrame]:
    """Run an iterator in a background thread behind a bounded queue."""
    return _in_order([it], itertools.repeat(0), depth)


def _sampled_frames_seek(
    path: Path, interval_s: float, workers: int, start_after_frame: int
) -> Iterator[SampledFrame]:
    """Seek to each sampled index, decoding in ``workers`` threads (OpenCV
    releases the GIL in ffmpeg): indices are dealt round-robin, and frames
    stream in index order. Fast only where keyframes are dense: on a
    long-GOP file every seek decodes again from a keyframe."""
    info = open_video_info(path)
    indices = _sampled_indices(info, interval_s, start_after_frame)
    if not indices:
        return _in_order([], (), 1)
    workers = max(1, min(workers, len(indices)))

    def job(mine: list[int]) -> Iterator[SampledFrame]:
        cap = cv2.VideoCapture(str(path))
        try:
            for idx in mine:
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if not ok:
                    return
                yield SampledFrame(_to_gray(frame), idx / info.fps, idx)
        finally:
            cap.release()

    jobs = [job(indices[w::workers]) for w in range(workers)]
    return _in_order(jobs, (i % workers for i in range(len(indices))), _SEEK_QUEUE_DEPTH)


def _sampled_frames_chunk(
    path: Path, interval_s: float, workers: int, start_after_frame: int
) -> Iterator[SampledFrame]:
    """Segmented sequential decode: each of ``workers`` threads seeks once
    to its contiguous segment of the sampled indices, then grabs forward
    and decodes its indices, as the reference loop does. The same indices
    and bytes as "grab", in order, with one seek per worker instead of one
    per sample."""
    info = open_video_info(path)
    indices = _sampled_indices(info, interval_s, start_after_frame)
    if not indices:
        return _in_order([], (), 1)
    workers = max(1, min(workers, len(indices)))
    per = -(-len(indices) // workers)
    segments = [indices[i:i + per] for i in range(0, len(indices), per)]

    def job(seg: list[int]) -> Iterator[SampledFrame]:
        cap = cv2.VideoCapture(str(path))
        try:
            if seg[0] > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, seg[0])
            pos = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
            if pos > seg[0] or pos < 0:
                # The seek overshot, or the position cannot be trusted (a
                # variable frame rate, a broken index): the grab loop below
                # only corrects an undershoot, so decode this segment from
                # frame 0, slowly but with "grab"'s bytes.
                cap.release()
                cap = cv2.VideoCapture(str(path))
                pos = 0
            for idx in seg:
                while pos < idx:
                    if not cap.grab():
                        return
                    pos += 1
                ok, frame = cap.read()
                pos += 1
                if not ok:
                    return
                yield SampledFrame(_to_gray(frame), idx / info.fps, idx)
        finally:
            cap.release()

    order = (w for w, seg in enumerate(segments) for _ in seg)
    return _in_order([job(seg) for seg in segments], order, _CHUNK_QUEUE_DEPTH)


def sampled_frames(
    path: Path,
    interval_s: float = 5.0,
    mode: str = "grab",
    workers: int = 4,
    start_after_frame: int = -1,
) -> Iterator[SampledFrame]:
    """The sampled frames of a video with index > ``start_after_frame``, in
    order, decoded in the background. ``mode``: "grab" (the reference's
    loop, one thread), "chunk" ("grab"'s frames from ``workers`` segments
    decoded at once) or "seek" (one seek per sample over ``workers``
    threads)."""
    if mode == "seek":
        return _sampled_frames_seek(path, interval_s, workers, start_after_frame)
    if mode == "chunk":
        return _sampled_frames_chunk(path, interval_s, workers, start_after_frame)
    if mode != "grab":
        raise ValueError(f"decode_mode={mode!r}: expected 'grab', 'chunk' or 'seek'")
    return _prefetched(_sampled_frames_grab(path, interval_s, start_after_frame))
