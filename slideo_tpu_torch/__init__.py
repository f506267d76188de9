"""slideo-tpu on PyTorch + CUDA: the ORB match path for one NVIDIA H100.

The configuration is shared with the JAX package: ``slideo_tpu.config`` is
framework-free (``slideo_tpu/__init__.py`` imports nothing else), so both
implementations read every constant from one place. This package imports
``torch`` and never ``jax``.
"""

from slideo_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    MatchConfig,
    OrbConfig,
    SlideoConfig,
    VideoConfig,
)

__all__ = ["DEFAULT_CONFIG", "MatchConfig", "OrbConfig", "SlideoConfig", "VideoConfig"]
