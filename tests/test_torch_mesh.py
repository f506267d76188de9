"""The port's multi-device path against the JAX package, on CPU meshes.

``[cpu] * 8`` is the port's counterpart of the JAX package's 8 virtual CPU
devices (``tests/conftest.py``): the same threads and gathers, without
cross-device copies. On the small configuration and scene of
``tests/test_sharding.py``:

1. Frame DP (``match_frames_sharded``) equals the port's one-device
   ``match_frames`` and JAX's ``match_frames_sharded``.
2. The shard table, the counterpart of the TPU table kernel's
   non-transposed mode (K5 (c)): the port's table over each index shard
   against ``match_table_scores_pallas`` in interpret mode, and the
   gathered table against the full one.
3. The 2-D ("frames", "index") mesh step equals JAX's.
4. Sizes, the default mesh, replicas, the launch counters under threads,
   the card a launch runs on, and when the engine takes a mesh.
5. ``host_frame_shard`` equals JAX's; one host gathers nothing.
6. The engine: a mesh and the multi-host branch at world size 1 give the
   one-device timeline (the fixture of ``tests/test_pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from slideo_tpu.config import DEFAULT_CONFIG
from slideo_tpu.models import orb_matcher as jom
from slideo_tpu.ops import hamming as jham
from slideo_tpu.ops.pallas_table import match_table_scores_pallas
from slideo_tpu.parallel import mesh as jmesh
from slideo_tpu_torch import _kernels
from slideo_tpu_torch.app import db as tdb
from slideo_tpu_torch.app import pipeline as tpipeline
from slideo_tpu_torch.models import orb_matcher as tom
from slideo_tpu_torch.ops import hamming as tham
from slideo_tpu_torch.parallel import mesh as tmesh
from test_pipeline import fixture_dir, small_cfg  # noqa: F401  (shared fixtures)
from test_sharding import _synthetic
from test_torch_config import port_cfg

torch.set_num_threads(1)

SEEDS = list(range(8))


@pytest.fixture(scope="module")
def scene():
    """test_sharding's configuration, 4 slides and 8 frames, the JAX index
    and the same index carried into the port on the CPU."""
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        orb=dataclasses.replace(
            DEFAULT_CONFIG.orb, n_features=128, max_keypoints=128, n_levels=3, edge_threshold=32,
        ),
        match=dataclasses.replace(
            DEFAULT_CONFIG.match, ransac_iters=128, max_matches_per_slide=64, min_rating=15.0,
            knn_chunk=1024,
        ),
    )
    slides, frames = _synthetic(np.random.RandomState(0))
    ji = jom.build_slide_index(jnp.asarray(slides), cfg)
    di = ji.desc_index
    ti = tom.slide_index_from_numpy(
        np.asarray(di.desc), np.asarray(di.valid), np.asarray(ji.pts), np.asarray(ji.smalls),
        device="cpu",
    )
    return cfg, port_cfg(cfg), slides, frames, ji, ti


def _mesh2d(rows: int, cols: int) -> tmesh.Mesh:
    return tmesh.Mesh(np.array(["cpu"] * (rows * cols), dtype=object).reshape(rows, cols),
                      ("frames", "index"))


def test_frame_dp_matches_single_device_and_jax(scene):
    cfg, tcfg, slides, frames, ji, ti = scene
    hw = slides.shape[1:]
    ft = torch.from_numpy(frames)
    single = tom.match_frames(ft, SEEDS, ti, hw, tcfg)
    mesh = tmesh.make_mesh(["cpu"] * 8)
    sharded = tmesh.match_frames_sharded(mesh, ft, SEEDS, tmesh.replicate_index(mesh, ti), hw, tcfg)
    assert sharded.slide.tolist() == single.slide.tolist()
    np.testing.assert_allclose(sharded.similarity.numpy(), single.similarity.numpy(), rtol=1e-5)
    assert torch.equal(sharded.rating, single.rating)

    want = jmesh.match_frames_sharded(
        jmesh.make_mesh(jax.devices()[:8]), jnp.asarray(frames),
        jnp.arange(8, dtype=jnp.int32), ji, hw, cfg,
    )
    assert sharded.slide.tolist() == np.asarray(want.slide).tolist() == [0, 1, 2, 3] * 2


@pytest.mark.parametrize("n_index", [1, 2, 3])
def test_shard_table_equals_pallas_non_transposed_mode(n_index):
    """Over each shard: dist bit-equal on valid columns, valid and train
    equal to the interpret-mode kernel (bias -1e6 on invalid slots, where
    the port scores -2^30: only a slide without a valid slot has another
    dist). The gathered table is bit-equal to the full table."""
    rng = np.random.RandomState(n_index)
    q_n, s, k = 40, 6, 128
    q = rng.choice(np.array([-1, 1], np.int8), size=(q_n, 256))
    q[5] = 0                                  # an invalid keypoint's row
    d = rng.choice(np.array([-1, 1], np.int8), size=(s, k, 256))
    valid = rng.rand(s, k) > 0.3
    valid[4, :] = False                       # a slide with no valid slot
    d[2, 17], valid[2, 17] = q[0], True
    ti = tham.build_index(torch.from_numpy(d), torch.from_numpy(valid))
    index = tom.SlideIndex(ti, pts=torch.zeros(s, k, 2), smalls=torch.zeros(s, 4, 4))
    shards = tmesh.shard_index(_mesh2d(1, n_index), index)
    per = s // n_index
    tq = torch.from_numpy(q)
    for i in range(n_index):
        sl = slice(i * per, (i + 1) * per)
        t = tham.match_table(tq, shards[0, i].desc_index, per, k)
        ji = jham.build_index(jnp.asarray(d[sl]), jnp.asarray(valid[sl]))  # invalid rows zeroed
        ref = jham.match_table(jnp.asarray(q), ji, per, k)
        bias = jnp.where(ji.valid, 0.0, -1e6).astype(jnp.float32)
        best, arg = match_table_scores_pallas(
            jnp.asarray(q, jnp.float32), ji.desc, bias, per, k, interpret=True,
        )
        cols = np.asarray(ref.valid)
        assert np.array_equal(t.valid.numpy(), cols)
        assert np.array_equal(t.dist.numpy()[cols], ((256.0 - np.asarray(best)) * 0.5)[cols])
        assert np.array_equal(t.train.numpy(), np.asarray(arg))
        assert shards[0, i].desc_index.slide_ids[::k].tolist() == list(range(sl.start, sl.stop))
    full = tham.match_table(tq, ti, s, k)
    gathered = tmesh.mesh_table(tq, list(shards[0]))
    for name in ("dist", "train", "slide_ids", "valid"):
        assert torch.equal(getattr(gathered, name), getattr(full, name)), name
    assert int(full.train[0, 2]) == 17 and float(full.dist[0, 2]) == 0.0


def test_full_mesh_step_matches_jax(scene):
    cfg, tcfg, slides, frames, ji, ti = scene
    hw = slides.shape[1:]
    mesh = _mesh2d(4, 2)
    got = tmesh.match_frames_mesh(
        torch.from_numpy(frames), SEEDS, tmesh.shard_index(mesh, ti),
        mesh=mesh, slide_hw=hw, cfg=tcfg,
    )
    jm = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("frames", "index"))
    want = jmesh.match_frames_mesh(
        jax.device_put(jnp.asarray(frames), NamedSharding(jm, P("frames", None, None))),
        jax.device_put(jnp.arange(8, dtype=jnp.int32), NamedSharding(jm, P("frames"))),
        jmesh.shard_index(jm, ji), mesh=jm, slide_hw=hw, cfg=cfg,
    )
    assert got.slide.tolist() == (np.arange(8) % 4).tolist()
    assert got.slide.tolist() == np.asarray(want.slide).tolist()


def test_sizes(scene):
    """A deck that does not split over the index axis and a batch that does
    not split over the mesh raise; the engine pads a batch of 5 on a mesh
    of 4 and returns 5 results, those of one device."""
    _, tcfg, slides, frames, _, ti = scene
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.shard_index(_mesh2d(1, 3), ti)
    mesh = tmesh.make_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.match_frames_sharded(
            mesh, torch.from_numpy(frames[:5]), SEEDS[:5], tmesh.replicate_index(mesh, ti),
            slides.shape[1:], tcfg,
        )
    pages = [tpipeline.PdfPage("deck.pdf", "h", f"p-{i + 1}.png", i + 1) for i in range(4)]
    grays = slides.astype(np.uint8)
    one = tpipeline.MatchingEngine(tcfg, pages, device="cpu", page_grays=grays)
    four = tpipeline.MatchingEngine(tcfg, pages, device="cpu", page_grays=grays,
                                    mesh_devices=["cpu"] * 4)
    assert one.mesh is None and four.mesh.size == 4
    want = one.match_batch(torch.from_numpy(frames[:5]), SEEDS[:5])
    got = four.match_batch(torch.from_numpy(frames[:5]), SEEDS[:5])
    assert got.slide.shape == (5,)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_replicas_share_one_copy_per_device(scene):
    ti = scene[-1]
    reps = tmesh.replicate_index(tmesh.make_mesh(["cpu"] * 3), ti)
    assert reps[0] is reps[1] is reps[2]
    assert reps[0].desc_index.desc.data_ptr() == ti.desc_index.desc.data_ptr()


def test_launch_counts_survive_concurrent_threads():
    """Every wrapper counts through check_launch; 16 threads counting at a
    tiny switch interval must lose no update."""
    n_threads, per = 16, 2000
    _kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            for _ in range(per):
                _kernels.check_launch(0, "table")

        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _kernels.launches["table"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        _kernels.reset_launches()


def test_launch_makes_the_operands_card_current(monkeypatch):
    """A launcher launches on the calling thread's current card, so
    ``_kernels.launch`` makes the operand's card current around the call,
    whatever card was current, hands it that card's current stream, and
    counts the launch only when it succeeded."""
    seen = []
    current = ["cuda:0"]

    class Entered:
        def __init__(self, device):
            self.device, self.prev = str(device), None

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        @staticmethod
        def slideo_match_table(*args):
            seen.append((current[0], args))
            return 0 if args[0] == "ok" else 7

    monkeypatch.setattr(_kernels, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", Entered)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": f"stream of {d}"}))
    operand = type("T", (), {"device": torch.device("cuda", 1)})
    _kernels.reset_launches()
    try:
        _kernels.launch("table", "slideo_match_table", operand, "ok", 3)
        assert seen == [("cuda:1", ("ok", 3, "stream of cuda:1"))]
        assert current[0] == "cuda:0" and _kernels.launches["table"] == 1
        with pytest.raises(RuntimeError, match="cudaError 7"):
            _kernels.launch("table", "slideo_match_table", operand, "bad")
        assert _kernels.launches["table"] == 1
    finally:
        _kernels.reset_launches()


def test_engine_mesh_is_opt_in(monkeypatch):
    """Without ``mesh_devices`` the engine takes every card only when
    ``SLIDEO_MESH=on``; a one-entry list is one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    monkeypatch.delenv("SLIDEO_MESH", raising=False)
    assert tpipeline._frame_mesh(cuda, None) is None
    monkeypatch.setenv("SLIDEO_MESH", "off")
    assert tpipeline._frame_mesh(cuda, None) is None
    monkeypatch.setenv("SLIDEO_MESH", "on")
    mesh = tpipeline._frame_mesh(cuda, None)
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i}" for i in range(4)]
    assert tpipeline._frame_mesh(torch.device("cpu"), None) is None
    assert tpipeline._frame_mesh(cuda, ["cuda:0"]) is None


@pytest.mark.parametrize("pc", [1, 2, 3, 8])
def test_host_frame_shard_equals_jax(pc):
    idx = list(range(0, 97, 3))
    shards = [tmesh.host_frame_shard(idx, pi, pc) for pi in range(pc)]
    assert shards == [jmesh.host_frame_shard(idx, pi, pc) for pi in range(pc)]
    assert [i for s in shards for i in s] == idx


def test_one_host_gathers_nothing():
    rows = [(0, 0, 1), (25, 5000, -1), (50, 10000, 0)]
    assert tmesh.world_size() == 1 and tmesh.rank() == 0
    assert tmesh.gather_host_matchings(rows) == rows
    assert tmesh.host_frame_shard([0, 25, 50]) == [0, 25, 50]


@pytest.fixture(scope="module")
def fixture_pages(fixture_dir, tmp_path_factory):  # noqa: F811
    with tdb.Db(tmp_path_factory.mktemp("db") / "slideo.db") as db:
        db.set_pdf_extracted_pages_dir(
            tdb.PdfExtractedPagesDir(fixture_dir["pdf_hash"], fixture_dir["pages_dir"], True)
        )
        return tpipeline.pdfs_to_images([(fixture_dir["pdf_path"], fixture_dir["pdf_hash"])], db)


@pytest.fixture
def isolated_tmp(tmp_path, monkeypatch):
    """An engine built from page files keeps its index under TMPDIR: keep
    it in this test's own directory."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    yield tmp_path
    tempfile.tempdir = None


def _timeline(engine, video):
    return [
        (m.video_ms, m.video_frame_idx, m.page.page_nr if m.page else None)
        for m in engine.match_video(video)
    ]


def test_engine_mesh_gives_the_one_device_timeline(fixture_dir, small_cfg, fixture_pages,  # noqa: F811
                                                    isolated_tmp):
    cfg = port_cfg(small_cfg)
    single = tpipeline.MatchingEngine(cfg, fixture_pages, device="cpu")
    meshed = tpipeline.MatchingEngine(cfg, fixture_pages, device="cpu", mesh_devices=["cpu", "cpu"])
    assert single.mesh is None and meshed.mesh.size == 2
    want = _timeline(single, fixture_dir["vid_path"])
    assert _timeline(meshed, fixture_dir["vid_path"]) == want
    assert [p for _, _, p in want] == [1, 3, None]


def test_multihost_branch_at_world_size_1(fixture_dir, small_cfg, fixture_pages, monkeypatch,  # noqa: F811
                                          isolated_tmp):
    engine = tpipeline.MatchingEngine(port_cfg(small_cfg), fixture_pages, device="cpu")
    base = _timeline(engine, fixture_dir["vid_path"])
    monkeypatch.setenv("SLIDEO_MULTIHOST", "1")
    assert _timeline(engine, fixture_dir["vid_path"]) == base
