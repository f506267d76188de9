"""slideo-tpu on PyTorch + CUDA: both match engines (ORB, and SIFT for
slides filmed in perspective) for one NVIDIA H100.

A port of the JAX package ``slideo_tpu`` that stands on its own: it imports
``torch`` and never ``jax``, and nothing of ``slideo_tpu``. It keeps its own
copy of the configuration (``config.py``, the same fields and defaults).
"""

from .config import (  # noqa: F401
    DEFAULT_CONFIG,
    MatchConfig,
    OrbConfig,
    SiftConfig,
    SlideoConfig,
    VideoConfig,
)

__all__ = [
    "DEFAULT_CONFIG", "MatchConfig", "OrbConfig", "SiftConfig", "SlideoConfig", "VideoConfig",
]
