"""Host-side video decoding: one decoded frame per sampling interval.

Port of ``open_video_info`` and ``sampled_frames`` from
``slideo_tpu/io/video.py`` (reference crates/matching-opencv/src/
video_capture.rs): grab every frame header, decode only the frames where
``frame_idx % floor(fps * interval) == 0`` (video_capture.rs:52). Only the
reference-exact "grab" decode mode is ported; decoding runs in a background
thread so it overlaps the engine's device work. OpenCV is imported here and
nowhere else in the port.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from queue import Full, Queue
from typing import Iterator, NamedTuple

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
    """The exception that ended a prefetched iterator."""

    error: Exception


def _prefetched(it: Iterator[SampledFrame], depth: int = 16) -> Iterator[SampledFrame]:
    """Run an iterator in a background thread behind a bounded queue. An
    exception raised by the iterator reaches the consumer, raised where the
    stream would have ended: a decode error never passes for a normal end
    of the video."""
    q: Queue = Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except Full:
                continue

    def work() -> None:
        last = end
        try:
            for item in it:
                put(item)
                if stop.is_set():
                    return
        except Exception as e:  # handed to the consumer, which re-raises it
            last = _Failed(e)
        finally:
            put(last)

    threading.Thread(target=work, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        stop.set()


def sampled_frames(
    path: Path,
    interval_s: float = 5.0,
    mode: str = "grab",
    start_after_frame: int = -1,
) -> Iterator[SampledFrame]:
    """The sampled frames of a video, in order."""
    if mode != "grab":
        raise NotImplementedError(
            f"decode_mode={mode!r}: only 'grab' is ported to slideo_tpu_torch"
        )
    return _prefetched(_sampled_frames_grab(path, interval_s, start_after_frame))
