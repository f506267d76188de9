"""Content hashes and the cache paths keyed by them.

Port of ``slideo_tpu/app/hashing.py`` (reference crates/app/src/utils.rs):
the SHA-256 of a file's bytes is its identity, so a moved or renamed file
keeps its cache entries. Files hash in a thread pool (file reads release
the GIL), with hashlib only.
"""

from __future__ import annotations

import hashlib
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["hash_file", "hash_files", "hash_str", "get_temp_path", "get_temp_path_key"]

_CHUNK = 1 << 20


def hash_file(path: Path) -> str:
    """Hex SHA-256 of a file's bytes (utils.rs:28-33)."""
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            sha.update(chunk)
    return sha.hexdigest()


def hash_files(paths: list[Path], workers: int = 8) -> list[str]:
    """``hash_file`` of each path, in order."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(hash_file, paths))


def hash_str(value: str) -> str:
    return hashlib.sha256(value.encode()).hexdigest()


def get_temp_path() -> Path:
    """$TMP/pdf-video-sync (utils.rs:10-14)."""
    return Path(tempfile.gettempdir()) / "pdf-video-sync"


def get_temp_path_key(category: str, key: str) -> Path:
    """$TMP/pdf-video-sync/{category}-{sha256(key)[0..20]} (utils.rs:24-26)."""
    return get_temp_path() / f"{category}-{hash_str(key)[:20]}"
