"""Engine-neutral matching interfaces (the reference's ``matching`` crate).

Port of ``slideo_tpu/matching.py`` (reference crates/matching/src/lib.rs:
1-40): structural protocols of the three-stage lifecycle

    ImageVideoMatcher.create_video_matcher(images)  -> VideoMatcher
    VideoMatcher.match_images_with_video(video)     -> VideoMatcherTask
    VideoMatcherTask.process()                      -> list[Matching]

plus the ``MatchableImage`` duck type (``get_path()``) and the result
record. ``app.pipeline.CudaImageVideoMatcher`` and ``MatchingEngine``
implement them.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Protocol, Sequence, runtime_checkable

from .app.progress import ProgressReporter, null_reporter

__all__ = [
    "MatchableImage",
    "Matching",
    "ImageVideoMatcher",
    "VideoMatcher",
    "VideoMatcherTask",
]


@runtime_checkable
class MatchableImage(Protocol):
    """An image on disk (reference: lib.rs:31-33)."""

    def get_path(self) -> Path: ...


@dataclass
class Matching:
    """Result record (reference: lib.rs:35-40): image=None = no slide visible."""

    video_ms: int
    video_frame_idx: int
    image: object | None


@runtime_checkable
class VideoMatcherTask(Protocol):
    """A bound (images x video) unit of work (reference: lib.rs:26-29)."""

    def process(self) -> list[Matching]: ...


@runtime_checkable
class VideoMatcher(Protocol):
    """Images prepared; bind videos to it (reference: lib.rs:16-24)."""

    def match_images_with_video(
        self, video_path: Path, reporter: ProgressReporter = null_reporter
    ) -> VideoMatcherTask: ...


@runtime_checkable
class ImageVideoMatcher(Protocol):
    """Engine entry point (reference: lib.rs:7-14)."""

    def create_video_matcher(
        self,
        images: Sequence[MatchableImage],
        reporter: ProgressReporter = null_reporter,
    ) -> VideoMatcher: ...
