"""Typed configuration of the matching engine.

Port of ``slideo_tpu/config.py``: the same dataclasses, field names and
defaults, so a configuration means the same thing to both packages (a test
holds them equal field by field). Every algorithmic constant keeps the
reference's value, because the frame -> page assignments depend on them
(reference locations in crates/matching-opencv/src: ORB feature_extractor.rs:
13-23, ratio 1.05 lib.rs:275, top-40 lib.rs:295, RANSAC image_utils.rs:52,
rating cascade lib.rs:333, similarity lib.rs:381, dedup video_capture.rs:98,
5 s sampling lib.rs:145, thumbnail area image_utils.rs:11).

Both engines of the JAX package are ported: ``engine="orb"`` (the
default) and ``engine="sift"``. Fields that only tune the JAX package's TPU
kernels (``fast_polarity_fused``, ``fast_chunk_w``, ``fast_sparse_skip``,
``fast_min_first``, ``describe_pass2``, ``cascade_viable_prefix``,
``knn_chunk``) are kept for the equal field set; the port reads none of
them (no ``fast_sparse_skip``: kernel K1's compass pretest is exact and
always runs). Every option of the JAX package runs: ``screen_bits`` other
than 128 and ``screen_k_per_slide`` below the deck's keypoints per slide
take the per-frame stage-1 rule, as in the JAX package
(``models/orb_matcher.match_frames``). ``MatchConfig``
refuses ``screen_prevote`` with more ``screen_slides`` than
``screen_prevote_slides`` (a ``ValueError``): the re-vote cannot return
more candidates than the pre-vote kept, and the JAX package fails there
inside its trace (``slideo_tpu/ops/hamming.py:589-590``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB-style feature extraction (reference: feature_extractor.rs:13-23)."""

    n_features: int = 2000          # max keypoints per image
    scale_factor: float = 1.2       # pyramid scale between levels
    n_levels: int = 8               # pyramid levels
    edge_threshold: int = 62        # border (px, per level) where no keypoints live
    fast_threshold: int = 20        # FAST-9/16 intensity threshold
    patch_size: int = 62            # orientation patch diameter
    max_keypoints: int = 2048       # fixed keypoint slot count (>= n_features)
    # Frame-side query-count buckets: a frame is described and matched at the
    # smallest bucket holding all its valid keypoints; max_keypoints is always
    # the last bucket.
    query_buckets: tuple[int, ...] = (768,)
    fast_polarity_fused: bool = True
    fast_chunk_w: int = 640
    fast_sparse_skip: bool = True
    fast_min_first: bool = False
    atlas_bf16: bool = True         # store the pyramid atlas as bfloat16
    describe_pass2: str = "sublanes_loop"
    descriptor_bits: int = 256      # rBRIEF descriptor length in bits
    blur_ksize: int = 7             # Gaussian blur before description (OpenCV ORB)
    blur_sigma: float = 2.0
    pattern_seed: int = 0x51DE0     # seed of the deterministic BRIEF point pattern

    @cached_property
    def per_level_quota(self) -> tuple[int, ...]:
        """Keypoints allocated per pyramid level, geometric decay like OpenCV ORB.

        n_l proportional to (1/scale_factor)^l, summing to n_features.
        """
        inv = 1.0 / self.scale_factor
        factor = (1 - inv) / (1 - inv ** self.n_levels)
        quotas = []
        remaining = self.n_features
        desired = self.n_features * factor
        for _ in range(self.n_levels - 1):
            q = min(int(round(desired)), remaining)
            quotas.append(q)
            remaining -= q
            desired *= inv
        quotas.append(remaining)
        return tuple(quotas)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching + verification cascade (reference: lib.rs:249-414)."""

    knn_k: int = 30                 # per-query fan-out cap of slides (lib.rs:266)
    ratio: float = 1.05             # keep match iff dist < best*1.05 (lib.rs:275)
    top_slides: int = 40            # candidate slides by match count (lib.rs:295)
    max_matches_per_slide: int = 512  # static cap of match slots per candidate
    ransac_threshold: float = 3.0   # inlier reprojection threshold (px)
    ransac_iters: int = 512         # hypothesis count (reference: 2000 with
                                    # OpenCV's 0.99-confidence early exit)
    ransac_refine_iters: int = 10   # least-squares refinement iterations
    ransac_seed: int = 0xA5AC       # base seed of the hypothesis draws
    top_rated: int = 10             # candidates kept after RANSAC rating
    cascade_viable_prefix: int = 0
    min_rating: float = 50.0        # required inlier count
    min_rating_ratio: float = 0.2   # required rating / best rating
    min_similarity: float = 0.5     # required warped-image similarity
    verify_stride: int = 2          # verification sampling stride over the
                                    # thumbnail grid (1 = dense)
    # Two-stage screening of large decks (the FLANN-LSH analogue,
    # flann.rs:14-26): stage 1 votes with the strongest frame descriptors'
    # screen_bits-bit prefixes over every index slot; stage 2 runs the exact
    # table over the screen_slides survivors.
    screen_above_slides: int = 96   # screen when the deck has more slides than this
    screen_slides: int = 16         # candidate slides surviving stage 1
    screen_bits: int = 128          # descriptor prefix bits of the stage-1 vote
                                    # (the batched rule reads 128 whatever this
                                    # says; another value takes the per-frame rule)
    screen_queries: int = 256       # strongest frame keypoints used for screening
    screen_k_per_slide: int = 2048  # index slots per slide the per-frame vote
                                    # reads (full K; a 512-slot trim loses recall,
                                    # slideo_tpu/config.py:215-222)
    # Strided pre-vote before the full-K vote (off by default): the
    # strongest screen_prevote_queries prefixes vote over every
    # screen_prevote_k_stride-th slot and keep screen_prevote_slides slides,
    # then the full-K vote runs over those slides only.
    screen_prevote: bool = False
    screen_prevote_slides: int = 64
    screen_prevote_k_stride: int = 4
    screen_prevote_queries: int = 128
    knn_chunk: int = 65536

    def __post_init__(self) -> None:
        if self.screen_prevote and self.screen_slides > self.screen_prevote_slides:
            raise ValueError(
                f"screen_prevote=True with screen_slides={self.screen_slides} > "
                f"screen_prevote_slides={self.screen_prevote_slides}: the re-vote keeps at "
                "most the pre-vote's slides"
            )


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT-family features of the second engine (``engine="sift"``): DoG
    keypoints over ``n_octaves`` octaves, 128-d descriptors, Lowe's ratio
    per slide and homography verification."""

    max_keypoints: int = 2048
    n_octaves: int = 5
    octave_quota_decay: float = 0.5
    sigma0: float = 1.6
    blur_ksize: int = 9
    contrast_threshold: float = 8.0
    edge_ratio: float = 10.0
    border: int = 40
    descriptor_radius: float = 12.0
    lowe_ratio: float = 0.8
    min_rating: float = 10.0


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Frame sampling and dedup (reference: video_capture.rs, lib.rs:145)."""

    interval_s: float = 5.0         # sample one frame per interval
    dedup_similarity: float = 0.98  # frame changed iff similarity < this
    small_image_area: int = 300 * 400  # max area of the comparison thumbnails
    batch_size: int = 64            # frames per device batch
    decode_mode: str = "grab"       # "grab" (reference-exact sequential),
                                    # "chunk" (grab's frames, segments in
                                    # parallel) or "seek" (one seek a frame)
    decode_workers: int = 8         # parallel decode segments ("chunk"/"seek")


@dataclasses.dataclass(frozen=True)
class SlideoConfig:
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)
    engine: str = "orb"             # feature engine: "orb" or "sift"


DEFAULT_CONFIG = SlideoConfig()
