"""Two-process multi-host run of the port over gloo on the CPU.

The counterpart of ``tests/test_multiprocess.py``: two processes join one
gloo group (``mesh.initialize_distributed`` on a free localhost port), each
runs the port's ``sync`` with a frame-parallel mesh of two CPU entries,
decodes and matches only its block of the sampled frames
(``host_frame_shard``), and the records cross in ``gather_host_matchings``.
Process 0 alone writes the database.

The fixture video shows page 1 for 10 s, then page 3 for 10 s (sampled
frames 0, 25, 50, 75): host 0's block sees only page 1 and host 1's only
page 3, so rank 0's rows hold both pages only if the gather ran.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 180  # for both processes together


def _small_cfg():
    """``test_multiprocess._small_cfg`` in the port's own config."""
    import dataclasses

    from slideo_tpu_torch import DEFAULT_CONFIG

    return dataclasses.replace(
        DEFAULT_CONFIG,
        orb=dataclasses.replace(
            DEFAULT_CONFIG.orb, n_features=256, max_keypoints=256, n_levels=3, edge_threshold=32,
        ),
        match=dataclasses.replace(
            DEFAULT_CONFIG.match, ransac_iters=256, max_matches_per_slide=128, min_rating=20.0,
            knn_chunk=2048,
        ),
        video=dataclasses.replace(DEFAULT_CONFIG.video, batch_size=4),
    )


def _worker_main(pid: int, port: int, root: Path) -> None:
    import torch
    import torch.distributed as dist

    from slideo_tpu_torch.app import pipeline
    from slideo_tpu_torch.app.db import Db, PdfExtractedPagesDir
    from slideo_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.initialize_distributed(f"localhost:{port}", 2, pid)
    assert mesh.world_size() == 2 and mesh.rank() == pid
    meta = json.loads((root / "meta.json").read_text())
    (root / f"db{pid}").mkdir(exist_ok=True)
    with Db(root / f"db{pid}" / "slideo.db") as db:
        db.set_pdf_extracted_pages_dir(PdfExtractedPagesDir(meta["pdf_hash"], root / "pages", True))
        pages = pipeline.pdfs_to_images([(root / "deck.pdf", meta["pdf_hash"])], db)
        db.create_or_reset_video(meta["video_hash"], [meta["pdf_hash"]])
        pipeline.sync(
            pages, [(root / "talk.avi", meta["video_hash"])], db, _small_cfg(),
            device="cpu", mesh_devices=["cpu", "cpu"],
        )
        rows = db.conn.execute(
            "SELECT video_ms, pdf_hash, page FROM videos_mapping ORDER BY video_ms"
        ).fetchall()
        info = db.find_mapping_info(meta["video_hash"])
    (root / f"out{pid}.json").write_text(json.dumps(dict(
        rank=mesh.rank(), rows=rows, finished=bool(info.finished) if info else False,
    )))
    dist.destroy_process_group()


def test_two_process_gather_and_db_gate(tmp_path):
    from test_multiprocess import _make_media

    meta = _make_media(tmp_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    (tmp_path / "tmp").mkdir()
    # The engine keeps its index under TMPDIR: this test's own directory.
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", TMPDIR=str(tmp_path / "tmp"))
    env.pop("SLIDEO_MULTIHOST", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__)), str(i), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-4000:]}"

    out0 = json.loads((tmp_path / "out0.json").read_text())
    out1 = json.loads((tmp_path / "out1.json").read_text())
    rows = out0["rows"]
    assert out0["rank"] == 0 and out0["finished"], rows
    assert rows[0][0] == 0 and rows[0][2] == 0, rows
    switches = [r for r in rows if r[1] == meta["pdf_hash"] and r[2] == 2]
    assert len(switches) == 1, rows
    assert abs(switches[0][0] - 10_000) <= 5_000, rows
    assert rows[-1][1] is None, rows
    assert out1["rank"] == 1 and out1["rows"] == [] and not out1["finished"], out1


if __name__ == "__main__":
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
