"""The port's command line against the JAX package's, end to end on the CPU.

``slideo_tpu_torch.app.cli.main`` (``python -m slideo_tpu_torch``) and
``slideo_tpu.app.cli.main`` run ``deck.pdf talk.avi -n --no-server`` on
tests/test_pipeline.py's fixture, each with its own database
(``SLIDEO_DB_DIR``) and the pages injected through the extraction cache
(``Db.set_pdf_extracted_pages_dir(..., finished=True)``), and the small
test config set on each CLI module's ``DEFAULT_CONFIG`` name. The
``videos_mapping`` rows must be equal, exactly:

1. ORB, "grab" decode; then "chunk" and "seek" give grab's rows, a second
   run skips the cached video, ``--invalidate-video-cache --trace``
   recomputes it from the warm index and prints the stage summary;
2. ``--engine sift`` gives the JAX package's SIFT rows;
3. ``--exact`` sets the three fields the JAX CLI sets and gives its rows;
4. without ``SLIDEO_PLATFORM=cpu`` on a machine with no card, or with
   another value, the command exits non-zero and says why;
5. ``CudaImageVideoMatcher`` and ``MatchingEngine`` satisfy the port's
   engine-neutral protocols.

Both packages' index caches go to one isolated ``TMPDIR`` (their keys
never collide).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import slideo_tpu.app.cli as jcli
import slideo_tpu.app.db as jdb
import slideo_tpu_torch.app.cli as tcli
import slideo_tpu_torch.app.db as tdb
from slideo_tpu_torch import matching as M
from slideo_tpu_torch.app import pipeline as tpipeline
from test_pipeline import fixture_dir, small_cfg  # noqa: F401  (shared fixtures)
from test_torch_config import port_cfg
from test_torch_sift_engine import FAST_CFG as SIFT_CFG

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One TMPDIR for the module's index caches; the JAX engine on one
    device (its 8-device CPU mesh gives the same rows, test_pipeline.py)."""
    tmp = tmp_path_factory.mktemp("tmpdir")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(tmp))
        mp.setenv("SLIDEO_MESH", "off")
        mp.setenv("SLIDEO_PLATFORM", "cpu")
        tempfile.tempdir = None
        yield tmp_path_factory
    tempfile.tempdir = None


def _run(cli, db_mod, cfg, fixture, db_dir: Path, *args, capsys=None):
    """Run ``cli.main`` on the fixture with ``cfg``; returns (rc, rows, out)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "DEFAULT_CONFIG", cfg)
        mp.setenv("SLIDEO_DB_DIR", str(db_dir))
        with db_mod.Db() as db:
            db.set_pdf_extracted_pages_dir(
                db_mod.PdfExtractedPagesDir(fixture["pdf_hash"], fixture["pages_dir"], True)
            )
        rc = cli.main([str(fixture["pdf_path"]), str(fixture["vid_path"]), "-n", "--no-server",
                       *args])
        with db_mod.Db() as db:
            rows = db.conn.execute(
                "SELECT video_ms, pdf_hash, page FROM videos_mapping ORDER BY video_ms"
            ).fetchall()
            info = db.find_mapping_info(fixture["video_hash"])
    out = capsys.readouterr().out if capsys is not None else ""
    assert rc == 0 and info is not None and info.finished, (rc, out)
    return rows, out


@pytest.fixture(scope="module")
def jax_rows(env, fixture_dir, small_cfg):  # noqa: F811
    rows, _ = _run(jcli, jdb, small_cfg, fixture_dir, env.mktemp("jaxdb"))
    assert rows[0][2] == 0 and rows[-1][1] is None and any(r[2] == 2 for r in rows), rows
    return rows


def test_cli_orb_rows_equal_jax(env, fixture_dir, small_cfg, jax_rows, capsys):  # noqa: F811
    cfg = port_cfg(small_cfg)
    db_dir = env.mktemp("portdb")
    rows, _ = _run(tcli, tdb, cfg, fixture_dir, db_dir, capsys=capsys)
    assert rows == jax_rows
    assert "extract_s" in tpipeline.LAST_BUILD_BREAKDOWN  # the first port run built

    _, out = _run(tcli, tdb, cfg, fixture_dir, db_dir, capsys=capsys)
    assert "has already been cached, skipping." in out

    rows, out = _run(tcli, tdb, cfg, fixture_dir, db_dir, "--invalidate-video-cache", "--trace",
                     capsys=capsys)
    assert rows == jax_rows
    assert "read_s" in tpipeline.LAST_LOAD_BREAKDOWN  # the recompute loaded the index
    assert "per-stage timing:" in out
    for stage in ("decode", "dedup", "match.dispatch", "match.fetch"):
        assert f"  {stage} " in out, stage


@pytest.mark.parametrize("mode", ["chunk", "seek"])
def test_cli_decode_modes_give_grabs_rows(env, fixture_dir, small_cfg, jax_rows, mode):  # noqa: F811
    rows, _ = _run(tcli, tdb, port_cfg(small_cfg), fixture_dir, env.mktemp(f"db-{mode}"),
                   "--decode-mode", mode)
    assert rows == jax_rows


def test_cli_sift_rows_equal_jax(env, fixture_dir):  # noqa: F811
    want, _ = _run(jcli, jdb, SIFT_CFG, fixture_dir, env.mktemp("jaxdb-sift"), "--engine", "sift")
    got, _ = _run(tcli, tdb, port_cfg(SIFT_CFG), fixture_dir, env.mktemp("portdb-sift"),
                  "--engine", "sift")
    assert got == want
    assert got[0][2] == 0 and got[-1][1] is None


def test_cli_exact_mode(env, fixture_dir, small_cfg):  # noqa: F811
    args = tcli.build_parser().parse_args(["d.pdf", "--exact", "--interval", "2.5"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "DEFAULT_CONFIG", port_cfg(small_cfg))
        cfg = tcli._config(args)
    m = small_cfg.match
    want = dataclasses.replace(
        small_cfg,
        match=dataclasses.replace(m, screen_above_slides=1 << 30, verify_stride=1, ransac_iters=2048),
        video=dataclasses.replace(small_cfg.video, interval_s=2.5),
    )
    assert cfg == port_cfg(want)
    jrows, _ = _run(jcli, jdb, small_cfg, fixture_dir, env.mktemp("jaxdb-exact"), "--exact")
    rows, _ = _run(tcli, tdb, port_cfg(small_cfg), fixture_dir, env.mktemp("portdb-exact"),
                   "--exact")
    assert rows == jrows


def test_cli_refuses_to_leave_the_card(fixture_dir, tmp_path, monkeypatch, capsys):  # noqa: F811
    monkeypatch.setenv("SLIDEO_DB_DIR", str(tmp_path))
    files = [str(fixture_dir["pdf_path"]), str(fixture_dir["vid_path"]), "-n", "--no-server"]
    monkeypatch.delenv("SLIDEO_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(files) != 0
    assert "no CUDA device is visible" in capsys.readouterr().err
    monkeypatch.setenv("SLIDEO_PLATFORM", "tpu")
    assert tcli.main(files) != 0
    assert "SLIDEO_PLATFORM='tpu'" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []  # nothing was written


def test_python_m_entry_point(fixture_dir, tmp_path):  # noqa: F811
    """``python -m slideo_tpu_torch`` on a machine with no card, in a child
    process that imports neither jax nor cv2 before the decision."""
    env = dict(os.environ, PYTHONPATH=str(REPO), SLIDEO_DB_DIR=str(tmp_path), HOME=str(tmp_path))
    env.pop("SLIDEO_PLATFORM", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "slideo_tpu_torch", str(fixture_dir["pdf_path"]),
         str(fixture_dir["vid_path"]), "-n"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 1 and "no CUDA device is visible" in proc.stderr, proc.stderr


def test_engine_satisfies_matching_protocols(env, fixture_dir, small_cfg, tmp_path):  # noqa: F811
    with tdb.Db(tmp_path / "slideo.db") as db:
        db.set_pdf_extracted_pages_dir(
            tdb.PdfExtractedPagesDir(fixture_dir["pdf_hash"], fixture_dir["pages_dir"], True)
        )
        pages = tpipeline.pdfs_to_images([(fixture_dir["pdf_path"], fixture_dir["pdf_hash"])], db)
    assert isinstance(pages[0], M.MatchableImage)
    assert pages[0].get_path().exists()
    factory = tpipeline.CudaImageVideoMatcher(port_cfg(small_cfg), device="cpu")
    assert isinstance(factory, M.ImageVideoMatcher)
    seen = []
    matcher = factory.create_video_matcher(pages, lambda p, t, m: seen.append((p, t)))
    assert seen == [(0, 3), (3, 3)]
    assert isinstance(matcher, M.VideoMatcher)
    task = matcher.match_images_with_video(fixture_dir["vid_path"])
    assert isinstance(task, M.VideoMatcherTask)
    results = task.process()
    assert [m.page.page_nr if m.page else None for m in results] == [1, 3, None]
