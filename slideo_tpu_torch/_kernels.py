"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The counterpart of ``slideo_tpu/native.py``: every ``csrc/*.cu`` file is
compiled by its own ``nvcc``, all in parallel, and linked into ONE shared
library with a plain C interface, loaded with ctypes. No PyTorch headers
are included, so a build takes seconds. The library lands in ``_build/``
under a name carrying a hash of the flags, the sources and the
``csrc/*.cuh`` headers they include, so an edited source or header is
rebuilt on first use and a stale library is never loaded. The build happens on the first call that needs a
kernel, never at import: the CPU tests import every module.

Each kernel's wrapper launches through ``launch``, which puts the operands'
card current around the call and adds one to ``launches[name]`` right after
the kernel launched, and nowhere else, so a run can prove which kernels its
main path went through. The mesh (``parallel/mesh.py``) launches from several
threads at once, so the counts and the first build are taken under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "library", "launches", "reset_launches", "launch", "check_launch",
    "require_cuda", "plain_or_raise",
]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported launcher; each returns cudaGetLastError().
_SIGNATURES = {
    # img, out, h, w, threshold, stream
    "slideo_fast_nms": (_P, _P, _I, _I, _F, _P),
    # imgs, out, b, h, w, threshold, stream
    "slideo_fast_nms_batch": (_P, _P, _I, _I, _I, _F, _P),
    # atlas, h, w, y, x, level, level_table, n_levels, k, heads, weights, bins,
    # out, stream
    "slideo_orb_describe": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    # query, q, desc, valid, n_slides, n_cols, k_per_slide, n_slots, slide_list, best,
    # arg, stream
    "slideo_match_table": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # query, q, desc, valid, k_per_slide, stride, n_slots, prefix, slide_ids,
    # n_cols, rows_per_group, best, stream
    "slideo_screen": (_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P),
    # img, h, w, a, b, tx, ty, n_t, sx, sy, inv_fx, inv_fy, out_h, out_w,
    # stride, out, stream
    "slideo_warp_sample": (_P, _I, _I, _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _I, _P, _P),
    # img, h, w, hparams, n_t, sx, sy, inv_fx, inv_fy, out_h, out_w, stride,
    # out, stream
    "slideo_warp_sample_homography": (_P, _I, _I, _P, _I, _F, _F, _F, _F, _I, _I, _I, _P, _P),
    # src, dst, valid, u, n_cand, m, n_hyp, n_used, thr2, n_refine, keys, out,
    # inliers, ok, winner, stream
    "slideo_ransac": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P),
}

launches: dict[str, int] = {
    "fast": 0, "fast_batch": 0, "orb": 0, "table": 0, "screen": 0, "screen_strided": 0,
    "screen_listed": 0, "screen_prefix": 0, "warp": 0, "warp_homography": 0, "ransac": 0,
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of slideo_tpu_torch are built from csrc/*.cu on first "
        "use and need the CUDA toolkit"
    )


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any that fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def source_digest(src_dir: Path = _SRC_DIR) -> str:
    """Hash of the build flags and of every file a build reads: the
    ``*.cu`` sources and the ``*.cuh`` headers they include."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _build() -> Path:
    sources = sorted(_SRC_DIR.glob("*.cu"))
    digest = source_digest(_SRC_DIR)
    target = _BUILD_DIR / f"libslideo_kernels_{digest}.so"
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    # One nvcc per source, all at once, then one link.
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    _run_all([[nvcc, *_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)])
    tmp = target.with_suffix(f".so.tmp.{os.getpid()}")
    _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    tmp.replace(target)  # atomic: a concurrent build never loads a partial file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/ on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, symbol: str, on: torch.Tensor, *args) -> None:
    """Call the launcher ``symbol`` with ``args`` and the current stream of
    ``on``'s device, with that device current: a launcher launches on the
    calling thread's current device, whatever device its pointers live on.
    Raises if it reported a CUDA error, else counts the launch under
    ``name``."""
    fn = getattr(library(), symbol)
    with torch.cuda.device(on.device):
        rc = fn(*args, torch.cuda.current_stream(on.device).cuda_stream)
    check_launch(rc, name)


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error; else count the launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {rc}")
    with _lock:
        launches[name] += 1


def require_cuda(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def plain_or_raise(t: torch.Tensor) -> bool:
    """Dispatch rule of every wrapper: True for a CPU tensor (take the plain
    version), False for a CUDA tensor (launch the kernel); anything else
    raises. There is no fallback from a CUDA tensor to the plain version."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cpu or cuda")
