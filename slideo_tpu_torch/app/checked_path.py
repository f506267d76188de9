"""Input path classification: a PDF or a video, by extension.

The port's copy of ``slideo_tpu/app/checked_path.py`` (reference
crates/app/src/checked_path.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from pathlib import Path

from .video_exts import is_video_ext

__all__ = ["Kind", "CheckedPath"]


class Kind(Enum):
    PDF = "pdf"
    VIDEO = "video"


@dataclass
class CheckedPath:
    path: Path
    kind: Kind
    hash: str | None = None

    @staticmethod
    def from_path(path: Path) -> "CheckedPath":
        if path.is_dir():
            raise ValueError(f"The path '{path}' is a directory, but a file was expected!")
        ext = path.suffix.lstrip(".")
        if not ext:
            raise ValueError(f"Unsupported file extension in path '{path}'!")
        if ext.lower() == "pdf":
            return CheckedPath(path, Kind.PDF)
        if is_video_ext(ext):
            return CheckedPath(path, Kind.VIDEO)
        raise ValueError(f"Unsupported file extension '{ext}' in path '{path}'!")
