"""Cache paths keyed by content hashes.

Port of ``get_temp_path_key`` from ``slideo_tpu/app/hashing.py``
(reference crates/app/src/utils.rs:10-26), with hashlib only.
"""

from __future__ import annotations

import hashlib
import tempfile
from pathlib import Path

__all__ = ["get_temp_path_key"]


def get_temp_path_key(category: str, key: str) -> Path:
    """$TMP/pdf-video-sync/{category}-{sha256(key)[0..20]} (utils.rs:24-26)."""
    digest = hashlib.sha256(key.encode()).hexdigest()
    return Path(tempfile.gettempdir()) / "pdf-video-sync" / f"{category}-{digest[:20]}"
