"""Multi-device scaling: frame-data-parallel and index-parallel matching.

Port of ``slideo_tpu/parallel/mesh.py``. A JAX mesh is one process driving
many devices; the port keeps that model. A ``Mesh`` is an array of
``torch.device``s with axis names, each device holds its own tensors, and
one worker thread per mesh entry (or per frame row) drives its device on a
CUDA stream of its own, so the host syncs of one device's path (the query
bucket read) do not hold up the others. Inside a host no
``torch.distributed`` is used; across hosts only per-frame int records
travel, over gloo.

- **Frame DP** (``match_frames_sharded``): the batch is split into
  contiguous shards, one per mesh entry, each matched against that
  device's replica of the deck index.
- **Index parallel** (``match_frames_mesh``): on a 2-D ("frames", "index")
  mesh each device holds a contiguous block of slides; a frame's per-shard
  tables (``csrc/table.cu`` over the shard's rows: the counterpart of the
  TPU table kernel's non-transposed mode) are concatenated on the frame
  row's first device, where the cascade runs.

Entries may repeat: ``[cpu] * 8`` is the tests' counterpart of the JAX
package's 8 virtual CPU devices, ``[cuda:0] * 2`` drives the path on one
card. ``knn_index_sharded`` is not ported (nothing on a production path
uses it). Frame DP serves both engines: ``match_frames_sharded`` takes the
engine's match function (``match_frames_sift`` for the SIFT engine, the
counterpart of ``match_frames_sift_sharded``, ``mesh.py:175-198``) and
``replicate_index`` moves either index.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from ..config import SlideoConfig
from ..models import orb_matcher
from ..models.orb_matcher import FrameMatch, SlideIndex
from ..models.sift_matcher import SiftSlideIndex
from ..ops import hamming, image
from ..ops.features import extract_features

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate_index",
    "match_frames_sharded",
    "shard_index",
    "mesh_table",
    "match_frames_mesh",
    "initialize_distributed",
    "rank",
    "world_size",
    "host_frame_shard",
    "gather_host_matchings",
]

T = TypeVar("T")

# How long a process waits for the others at init and at each collective.
_DIST_TIMEOUT = datetime.timedelta(seconds=300)


def _device(d) -> torch.device:
    """A torch.device with an explicit index for CUDA."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices on named axes (the counterpart of ``jax.sharding.Mesh``).

    devices: an object ndarray of ``torch.device`` with one dimension per
    name in ``axis_names``.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_device(d) for d in arr.flat]
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not fit axes {tuple(axis_names)}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(devices=None, axis: str = "frames") -> Mesh:
    """1-D frame-DP mesh over ``devices``, by default every CUDA card this
    process sees (in a multi-host run, this host's cards only: each host
    drives its own frame shard, ``mesh.py:131-141``). Raises when there is
    no card: the mesh never falls back to the CPU."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(list(devices), (axis,))


def _index_to(index: SlideIndex | SiftSlideIndex, device: torch.device):
    if isinstance(index, SiftSlideIndex):
        return SiftSlideIndex(*(t.to(device) for t in index))
    di = index.desc_index
    return SlideIndex(
        desc_index=hamming.DescriptorIndex(*(None if t is None else t.to(device) for t in di)),
        pts=index.pts.to(device),
        smalls=index.smalls.to(device),
    )


def replicate_index(mesh: Mesh, index: SlideIndex | SiftSlideIndex) -> list:
    """One replica of the deck index (ORB or SIFT) per mesh entry, in
    ``mesh.devices.flat`` order; entries on the same device share one
    copy."""
    placed: dict[torch.device, SlideIndex | SiftSlideIndex] = {}
    for d in mesh.devices.flat:
        if d not in placed:
            placed[d] = _index_to(index, d)
    return [placed[d] for d in mesh.devices.flat]


def _run_threads(jobs: list[tuple[list[torch.device], Callable[[], T]]]) -> list[T]:
    """Run each job on a thread of its own and return the results in job
    order; the first failure is raised.

    A job names the devices it uses. On each CUDA one it gets a stream of
    its own, ordered after the caller's current stream there (which produced
    its inputs); each kernel wrapper makes its operands' card current for
    its launch (``_kernels.launch``). The job's streams are synchronized
    before it returns, so its results are complete when the caller reads
    them."""
    parents = {
        d: torch.cuda.current_stream(d) for devs, _ in jobs for d in devs if d.type == "cuda"
    }

    def run(devs: list[torch.device], fn: Callable[[], T]) -> T:
        streams = []
        with contextlib.ExitStack() as stack:
            for d in dict.fromkeys(d for d in devs if d.type == "cuda"):
                s = torch.cuda.Stream(d)
                s.wait_stream(parents[d])
                stack.enter_context(torch.cuda.stream(s))
                streams.append(s)
            out = fn()
            for s in streams:
                s.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(run, devs, fn) for devs, fn in jobs]
        return [f.result() for f in futures]


def _concat_matches(parts: list[FrameMatch], device: torch.device) -> FrameMatch:
    """The per-shard results concatenated in shard order on ``device``."""
    out = FrameMatch(*(torch.cat([f.to(device) for f in field]) for field in zip(*parts)))
    if device.type == "cuda":
        # The parts were allocated on the workers' streams: finish the copies
        # before they go back to those streams' memory pools.
        torch.cuda.current_stream(device).synchronize()
    return out


def match_frames_sharded(
    mesh: Mesh,
    frames: torch.Tensor,
    frame_seeds: Sequence[int],
    replicas: Sequence[SlideIndex | SiftSlideIndex],
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
    match_frames: Callable[..., FrameMatch] = orb_matcher.match_frames,
) -> FrameMatch:
    """Frame-data-parallel matching over a 1-D mesh (``mesh.py:144-198``).

    frames [B, H, W] with B divisible by the mesh size; replicas from
    ``replicate_index``. Mesh entry i matches frames [i*B/n, (i+1)*B/n) with
    ``match_frames`` (the ORB engine's by default, or
    ``sift_matcher.match_frames_sift``) against its replica on its own
    thread; the fields come back [B], in frame order, on the first mesh
    device."""
    devices = list(mesh.devices.flat)
    b, n = frames.shape[0], len(devices)
    if b % n:
        raise ValueError(f"match_frames_sharded: batch {b} is not divisible by the mesh size {n}")
    per = b // n
    seeds = [int(s) for s in frame_seeds]

    def job(i: int) -> Callable[[], FrameMatch]:
        rows = slice(i * per, (i + 1) * per)
        return lambda: match_frames(
            frames[rows].to(devices[i]), seeds[rows], replicas[i], slide_hw, cfg
        )

    parts = _run_threads([([d], job(i)) for i, d in enumerate(devices)])
    return _concat_matches(parts, devices[0])


def shard_index(mesh: Mesh, index: SlideIndex, axis: str = "index") -> np.ndarray:
    """Place the deck index on the mesh, its slides split over ``axis``
    (``mesh.py:201-219``).

    Returns an object ndarray shaped like ``mesh.devices``: entry p is the
    SlideIndex on device ``mesh.devices[p]`` holding, for position i of p
    on ``axis``, the contiguous slides [i*S/n, (i+1)*S/n) (their rows of
    desc / valid / slide_ids / train_ids; slide_ids stay global). pts and
    smalls are replicated. Raises if S does not split evenly, as JAX's
    ``P("index")`` does."""
    ax = mesh.axis_names.index(axis)
    n = mesh.devices.shape[ax]
    s, k = index.pts.shape[0], index.pts.shape[1]
    if s % n:
        raise ValueError(f"shard_index: {s} slides do not split evenly over {n} {axis!r} devices")
    per = s // n * k
    di = index.desc_index
    replicated: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
    placed: dict[tuple[torch.device, int], SlideIndex] = {}
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos, d in np.ndenumerate(mesh.devices):
        i = pos[ax]
        if d not in replicated:
            replicated[d] = (index.pts.to(d), index.smalls.to(d))
        if (d, i) not in placed:
            rows = slice(i * per, (i + 1) * per)
            placed[(d, i)] = SlideIndex(
                desc_index=hamming.DescriptorIndex(
                    di.desc[rows].to(d), di.slide_ids[rows].to(d),
                    di.train_ids[rows].to(d), di.valid[rows].to(d),
                ),
                pts=replicated[d][0],
                smalls=replicated[d][1],
            )
        out[pos] = placed[(d, i)]
    return out


def mesh_table(query: torch.Tensor, row_shards: Sequence[SlideIndex]) -> hamming.MatchTable:
    """The exact table of ``query`` [Q, 256] over a frame row's index shards,
    in index-axis order (the "all_gather" of ``mesh.py:257-263``).

    Each shard's [Q, S_local] table is ``hamming.match_table`` over its
    [S_local*K, 256] rows on its own device (``csrc/table.cu`` on CUDA);
    dist, train and valid are concatenated along the slides on ``query``'s
    device, with each column's global slide id."""
    parts = []
    for shard in row_shards:
        d = shard.pts.device
        k = shard.pts.shape[1]
        di = shard.desc_index
        t = hamming.match_table(query.to(d), di, di.desc.shape[0] // k, k)
        parts.append(t._replace(slide_ids=di.slide_ids[::k]))
    cat = lambda name, dim: torch.cat([getattr(t, name).to(query.device) for t in parts], dim=dim)
    return hamming.MatchTable(
        dist=cat("dist", 1), train=cat("train", 1), slide_ids=cat("slide_ids", 0),
        valid=cat("valid", 1),
    )


def _mesh_frame(
    frame: torch.Tensor,
    seed: int,
    row_shards: Sequence[SlideIndex],
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
) -> FrameMatch:
    """One frame of ``match_frames_mesh`` on its row's first device:
    features at max_keypoints (no query bucket), the gathered exact table
    over every shard (no screening, whatever the deck size), the cascade
    with the frame's RANSAC draws."""
    frame = frame.to(torch.float32)
    feats = extract_features(frame, cfg.orb)
    table = mesh_table(feats.desc, row_shards)
    small = image.to_small_image(frame, cfg.video.small_image_area)
    return orb_matcher._cascade(
        small, tuple(frame.shape), seed, feats, table, row_shards[0], slide_hw, cfg
    )


def match_frames_mesh(
    frames: torch.Tensor,
    frame_seeds: Sequence[int],
    index_shards: np.ndarray,
    *,
    mesh: Mesh,
    slide_hw: tuple[int, int],
    cfg: SlideoConfig,
) -> FrameMatch:
    """Full match step over a 2-D ("frames", "index") mesh
    (``mesh.py:222-298``).

    frames [B, H, W], B divisible by the "frames" axis; index_shards from
    ``shard_index(mesh, index)``. Frame row r matches frames
    [r*B/F, (r+1)*B/F) one by one on its own thread (``_mesh_frame``); the
    fields come back [B], in frame order, on the first mesh device."""
    f_ax, i_ax = mesh.axis_names.index("frames"), mesh.axis_names.index("index")
    devices = np.moveaxis(mesh.devices, (f_ax, i_ax), (0, 1))
    shards = np.moveaxis(index_shards, (f_ax, i_ax), (0, 1))
    b, n_rows = frames.shape[0], devices.shape[0]
    if b % n_rows:
        raise ValueError(f"match_frames_mesh: batch {b} is not divisible by {n_rows} frame rows")
    per = b // n_rows
    seeds = [int(s) for s in frame_seeds]

    def job(r: int) -> Callable[[], FrameMatch]:
        d0, row = devices[r, 0], list(shards[r])

        def run() -> FrameMatch:
            results = [
                _mesh_frame(frames[i].to(d0), seeds[i], row, slide_hw, cfg)
                for i in range(r * per, (r + 1) * per)
            ]
            return FrameMatch(*(torch.stack(field) for field in zip(*results)))

        return run

    parts = _run_threads([(list(devices[r]), job(r)) for r in range(n_rows)])
    return _concat_matches(parts, devices[0, 0])


# --- multiple hosts -----------------------------------------------------


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the processes of a multi-host run (``mesh.py:48-76``): a gloo
    group over ``tcp://coordinator_address`` ("host:port") when given, over
    torchrun's environment when ``WORLD_SIZE`` > 1, else nothing (one
    host). Only per-frame int records cross hosts, so gloo on the CPU
    carries them. Each wait is bounded by ``_DIST_TIMEOUT``."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=_DIST_TIMEOUT,
        )
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://", timeout=_DIST_TIMEOUT)


def _dist_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the run (0 on one host)."""
    return dist.get_rank() if _dist_initialized() else 0


def world_size() -> int:
    """The number of processes (hosts) in the run (1 on one host)."""
    return dist.get_world_size() if _dist_initialized() else 1


def host_frame_shard(
    frame_indices: list[int],
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[int]:
    """The contiguous block of sampled-frame indices this host decodes
    (``mesh.py:79-97``). Contiguous blocks keep the dedup chain local; the
    final consecutive-duplicate drop restores the one-host timeline."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = -(-len(frame_indices) // pc)
    return frame_indices[pi * per:(pi + 1) * per]


def gather_host_matchings(
    rows: list[tuple[int, int, int]], process_count: int | None = None
) -> list[tuple[int, int, int]]:
    """All-gather the hosts' (frame_idx, video_ms, page index or -1) records
    (``mesh.py:100-128``): every host gets every host's rows, host by host,
    in each host's order. Counts first, then the rows padded to the
    largest count, as int64 [m, 3] CPU tensors over gloo."""
    pc = world_size() if process_count is None else process_count
    if pc == 1:
        return list(rows)
    arr = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(pc)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64))
    m = max(1, max(int(c) for c in counts))
    padded = torch.cat([arr, torch.full((m - arr.shape[0], 3), -1, dtype=torch.int64)])
    gathered = [torch.empty((m, 3), dtype=torch.int64) for _ in range(pc)]
    dist.all_gather(gathered, padded)
    return [
        tuple(r) for g, c in zip(gathered, counts) for r in g[: int(c)].tolist()
    ]
