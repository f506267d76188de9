"""The port's host layer against the JAX package's, on the CPU.

1. Hashing, ``CheckedPath``, ``video_exts`` and both progress reporters:
   the counterparts of tests/test_host_units.py:15-94, each result equal
   to the JAX package's on the same input.
2. The viewer server: the counterparts of tests/test_web.py's seven tests
   against the port's ``make_server`` and ``Db``, and the port's viewer
   assets equal to the JAX package's (index.html after its comment).
3. Video decode: "grab", "seek" and "chunk" on tests/test_pipeline.py's
   fixture video (the counterpart of its test_video_info_and_sampling):
   "chunk" gives the indices and bytes of "grab" and of the JAX package's
   "chunk", and resumes from ``start_after_frame``; "seek" the indices,
   with a mean absolute difference below 2 grey levels; an error in a
   decode worker reaches the consumer.

Exact equality everywhere but the "seek" content bound above.
"""

from __future__ import annotations

import io
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from slideo_tpu.app import checked_path as jcp
from slideo_tpu.app import hashing as jhashing
from slideo_tpu.app import progress as jprogress
from slideo_tpu.app import video_exts as jexts
from slideo_tpu.io import video as jvideo
from slideo_tpu_torch.app import hashing, progress
from slideo_tpu_torch.app import pipeline as tpipeline
from slideo_tpu_torch.app import web as tweb
from slideo_tpu_torch.app.checked_path import CheckedPath, Kind
from slideo_tpu_torch.app.db import Db, PdfExtractedPagesDir
from slideo_tpu_torch.app.video_exts import VIDEO_EXTS, is_video_ext
from slideo_tpu_torch.io import pdf as tpdf
from slideo_tpu_torch.io import video as tvideo
from test_pipeline import fixture_dir  # noqa: F401  (shared fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# --- 1. host units -------------------------------------------------------------


def test_hash_file_and_files_equal_jax(tmp_path):
    files = []
    for i in range(5):
        p = tmp_path / f"{i}.bin"
        p.write_bytes(bytes([i]) * (1000 + (1 << 20) * (i == 4)))  # one spans two reads
        files.append(p)
    want = [jhashing.hash_file(p) for p in files]
    assert [hashing.hash_file(p) for p in files] == want
    assert hashing.hash_files(files) == want
    assert hashing.hash_str("slideo") == jhashing.hash_str("slideo")


def test_temp_paths_equal_jax(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    try:
        assert hashing.get_temp_path() == jhashing.get_temp_path() == tmp_path / "pdf-video-sync"
        a = hashing.get_temp_path_key("index", "somekey")
        assert a == jhashing.get_temp_path_key("index", "somekey")
        assert a != hashing.get_temp_path_key("index", "otherkey")
        assert a.name.startswith("index-") and len(a.name) == 6 + 20
    finally:
        tempfile.tempdir = None


def test_checked_path_classification(tmp_path):
    for name, kind in (("a.pdf", Kind.PDF), ("a.PDF", Kind.PDF), ("b.mp4", Kind.VIDEO),
                       ("b.MKV", Kind.VIDEO)):
        assert CheckedPath.from_path(Path(name)).kind == kind
        assert CheckedPath.from_path(Path(name)).kind.value == jcp.CheckedPath.from_path(
            Path(name)).kind.value
    d = tmp_path / "somedir"
    d.mkdir()
    for bad, msg in ((Path("c.xyz"), "Unsupported file extension 'xyz'"),
                     (Path("noext"), "Unsupported file extension in"), (d, "directory")):
        with pytest.raises(ValueError, match=msg) as got:
            CheckedPath.from_path(bad)
        with pytest.raises(ValueError) as want:
            jcp.CheckedPath.from_path(bad)
        assert str(got.value) == str(want.value)


def test_video_exts_equal_jax():
    assert VIDEO_EXTS == jexts.VIDEO_EXTS
    for ext in ("mp4", "mkv", "webm", "avi", "mov", ".MP4"):
        assert is_video_ext(ext)
    for ext in ("pdf", "txt", "png"):
        assert not is_video_ext(ext)


def test_composed_progress_sums():
    seen, jseen = [], []
    for mod, out in ((progress, seen), (jprogress, jseen)):
        composed = mod.ComposedProgressReporter(lambda p, t, m, out=out: out.append((p, t)))
        r1, r2 = composed.create_nested(), composed.create_nested()
        r1(2, 10, "a")
        r2(3, 5, "b")
        r1(10, 10, "a")
    assert seen == jseen == [(2, 10), (5, 15), (13, 15)]


def test_terminal_progress_renders_as_jax():
    outs = []
    for mod in (progress, jprogress):
        buf = io.StringIO()
        bar = mod.TerminalProgress(stream=buf, min_interval_s=0.0)
        bar.report(1, 4, "working")
        bar.report(4, 4, "done")
        bar.finish()
        bar.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "1/4" in outs[0] and "4/4" in outs[0] and outs[0].endswith("\n")
    assert outs[0].count("\n") == 1  # finish() ends the bar once


# --- 2. the viewer server ---------------------------------------------------------

PDF = "a" * 64
VID = "b" * 64


@pytest.fixture()
def server(tmp_path):
    db = Db(tmp_path / "slideo.db")
    media = tmp_path / "video.bin"
    media.write_bytes(bytes(range(256)) * 40)  # 10240 bytes
    pages = tmp_path / "pages"
    pages.mkdir()
    (pages / "p-1.png").write_bytes(b"\x89PNG fakepage1")
    (pages / "p-2.png").write_bytes(b"\x89PNG fakepage2")
    db.update_hashes([(str(media), VID)])
    db.set_pdf_extracted_pages_dir(PdfExtractedPagesDir(PDF, pages, True))
    db.create_or_reset_video(VID, [PDF])
    db.finalize_video_matchings(VID, [(0, PDF, 0), (7000, None, None)])
    db.close()

    srv = tweb.make_server(tmp_path / "slideo.db", port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()
    srv.server_close()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    return urllib.request.urlopen(req)


def test_pdf_matchings_json(server):
    with _get(f"{server}/pdf-matchings/{PDF}") as r:
        assert r.headers["Access-Control-Allow-Origin"] == "http://127.0.0.1:8080"
        rows = json.loads(r.read())
    assert rows == [
        {"video_offset_ms": 0, "pdf_hash": PDF, "video_hash": VID, "page_idx": 0,
         "duration_ms": 7000}
    ]


def test_files_full_and_range(server):
    with _get(f"{server}/files/{VID}") as r:
        body = r.read()
    assert len(body) == 10240
    with _get(f"{server}/files/{VID}", {"Range": "bytes=10-19"}) as r:
        assert r.status == 206
        assert r.headers["Content-Range"] == "bytes 10-19/10240"
        assert r.read() == bytes(range(10, 20))
    with _get(f"{server}/files/{VID}", {"Range": "bytes=-16"}) as r:
        assert r.status == 206 and len(r.read()) == 16


def test_pdf_pages_routes(server):
    with _get(f"{server}/pdf-pages/{PDF}") as r:
        pages = json.loads(r.read())
    assert [p["page_idx"] for p in pages] == [0, 1]
    with _get(f"{server}{pages[1]['url']}") as r:
        assert r.read().endswith(b"fakepage2")


def test_index_and_assets(server):
    static = REPO / "slideo_tpu_torch" / "webview" / "static"
    assert tweb.STATIC_DIR == static.resolve()
    jax_static = REPO / "slideo_tpu/webview/static"
    assert (static / "viewer.js").read_bytes() == (jax_static / "viewer.js").read_bytes()
    # The same page after its leading comment, which names no machine path.
    body = lambda p: p.read_text().split("-->", 1)[1]  # noqa: E731
    assert body(static / "index.html") == body(jax_static / "index.html")
    with _get(f"{server}/") as r:
        assert r.read() == (static / "index.html").read_bytes()
    with _get(f"{server}/viewer.js") as r:
        assert b"playVideo" in r.read()


def test_errors(server):
    for url, code in [
        (f"{server}/files/{'f' * 64}", 404),       # unknown hash
        (f"{server}/files/notahash", 400),          # malformed hash
        (f"{server}/no-such-asset.js", 404),
        (f"{server}/../pipeline.py", 404),
        (f"{server}/pdf-pages/{'c' * 64}", 404),    # no extraction recorded
    ]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url)
        assert e.value.code == code, url

    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{server}/files/{VID}", {"Range": "bytes=99999999-"})
    assert e.value.code == 416


def test_on_demand_extraction_async(server, tmp_path, monkeypatch):
    """A known PDF never extracted is extracted off the request: 202, then
    the viewer polls until the pages exist."""
    h = "d" * 64
    pdf_file = tmp_path / "deck2.pdf"
    pdf_file.write_bytes(b"%PDF fake")
    with Db(tmp_path / "slideo.db") as db:
        db.update_hashes([(str(pdf_file), h)])

    started, release = threading.Event(), threading.Event()
    threads = []

    def fake_pdfs_to_images(pdfs, db, reporter=None):
        threads.append(threading.get_ident())
        started.set()
        assert release.wait(10)
        pages = tmp_path / "lazy_pages"
        pages.mkdir(exist_ok=True)
        (pages / "p-1.png").write_bytes(b"\x89PNG lazypage1")
        db.set_pdf_extracted_pages_dir(PdfExtractedPagesDir(h, pages, True))

    monkeypatch.setattr(tpdf, "have_poppler", lambda: True)
    monkeypatch.setattr(tpipeline, "pdfs_to_images", fake_pdfs_to_images)

    r = _get(f"{server}/pdf-pages/{h}")
    assert r.status == 202
    assert json.loads(r.read()) == {"status": "extracting"}
    assert started.wait(10)
    assert _get(f"{server}/pdf-pages/{h}").status == 202  # the request thread is free
    release.set()
    for _ in range(100):
        r = _get(f"{server}/pdf-pages/{h}")
        if r.status == 200:
            break
        time.sleep(0.05)
    assert r.status == 200
    assert [p["page_idx"] for p in json.loads(r.read())] == [0]
    assert threads and threads[0] != threading.get_ident()


def test_on_demand_extraction_failure_is_500(server, tmp_path, monkeypatch):
    h = "e" * 64
    pdf_file = tmp_path / "deck3.pdf"
    pdf_file.write_bytes(b"%PDF broken")
    with Db(tmp_path / "slideo.db") as db:
        db.update_hashes([(str(pdf_file), h)])
    monkeypatch.setattr(tpdf, "have_poppler", lambda: True)

    def boom(pdfs, db, reporter=None):
        raise RuntimeError("pdftocairo exploded")

    monkeypatch.setattr(tpipeline, "pdfs_to_images", boom)
    code = None
    for _ in range(100):
        try:
            code = _get(f"{server}/pdf-pages/{h}").status
        except urllib.error.HTTPError as e:
            code = e.code
        if code == 500:
            break
        assert code == 202
        time.sleep(0.05)
    assert code == 500


# --- 3. video decode ----------------------------------------------------------------


def test_video_info_and_sampling(fixture_dir):  # noqa: F811
    vid = fixture_dir["vid_path"]
    info = tvideo.open_video_info(vid)
    assert info.total_frames == 100 and abs(info.fps - 5.0) < 0.1
    assert abs(info.total_time_s - 20.0) < 0.1

    grab = list(tvideo.sampled_frames(vid, 5.0, mode="grab"))
    assert [f.frame_idx for f in grab] == [0, 25, 50, 75]
    assert grab[0].gray.shape == (240, 320)

    seek = list(tvideo.sampled_frames(vid, 5.0, mode="seek", workers=2))
    assert [f.frame_idx for f in seek] == [0, 25, 50, 75]
    assert all(np.abs(s.gray.astype(float) - g.gray).mean() < 2.0 for s, g in zip(seek, grab))

    for workers in (1, 2, 3, 8):
        chunk = list(tvideo.sampled_frames(vid, 5.0, mode="chunk", workers=workers))
        jchunk = list(jvideo.sampled_frames(vid, 5.0, mode="chunk", workers=workers))
        assert [f.frame_idx for f in chunk] == [f.frame_idx for f in jchunk] == [0, 25, 50, 75]
        for cf, jf, gf in zip(chunk, jchunk, grab):
            assert np.array_equal(cf.gray, gf.gray) and np.array_equal(cf.gray, jf.gray)
            assert cf.time_s == jf.time_s == gf.time_s

    for mode in ("chunk", "seek", "grab"):
        resumed = list(tvideo.sampled_frames(vid, 5.0, mode=mode, workers=2, start_after_frame=25))
        assert [f.frame_idx for f in resumed] == [50, 75], mode
        assert list(tvideo.sampled_frames(vid, 5.0, mode=mode, start_after_frame=99)) == []
    with pytest.raises(ValueError, match="decode_mode"):
        tvideo.sampled_frames(vid, 5.0, mode="fast")


@pytest.mark.parametrize("mode", ["chunk", "seek"])
def test_decode_worker_error_reaches_the_consumer(fixture_dir, monkeypatch, mode):  # noqa: F811
    def broken(frame):
        raise RuntimeError("decoder fault")

    monkeypatch.setattr(tvideo, "_to_gray", broken)
    frames = tvideo.sampled_frames(fixture_dir["vid_path"], 5.0, mode=mode, workers=2)
    with pytest.raises(RuntimeError, match="decoder fault"):
        next(frames)
