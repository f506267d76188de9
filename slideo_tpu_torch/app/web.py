"""Embedded HTTP server + JSON API for the web viewer.

Port of ``slideo_tpu/app/web.py`` (reference crates/app/src/web.rs): a
stdlib ThreadingHTTPServer on the same address (127.0.0.1:63944,
web.rs:119) with the same routes and JSON shapes, serving the port's own
copy of the viewer (``webview/static``):

  GET /pdf-matchings/{pdf_hash} -> [{video_offset_ms, pdf_hash, video_hash,
                                     page_idx, duration_ms}]      (web.rs:42-52)
  GET /files/{hash}             -> file bytes with HTTP Range support so the
                                   browser can seek the video     (web.rs:54-67)
  GET /                          -> viewer index.html              (web.rs:88-91)
  GET /{asset}                   -> static viewer asset            (web.rs:93-96)

Additional routes (pages are rendered on the server instead of by pdf.js):

  GET /pdf-pages/{pdf_hash}      -> JSON [{page_idx, url}]
  GET /pdf-pages/{pdf_hash}/{n}  -> page PNG (n is the 1-based page number)
"""

from __future__ import annotations

import json
import mimetypes
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..io import pdf as pdf_io
from .db import Db

# On-demand page extraction runs in background threads so a drag&dropped
# 200-page deck never blocks the HTTP request that discovered it (the
# request returns 202 and the viewer polls). Keyed by pdf_hash.
_extract_lock = threading.Lock()
_extract_jobs: dict[str, dict] = {}

__all__ = ["start_server", "make_server", "PORT"]

PORT = 63944
STATIC_DIR = Path(__file__).resolve().parent.parent / "webview" / "static"
_HASH_RE = re.compile(r"^[0-9a-fA-F]{16,64}$")


class _Handler(BaseHTTPRequestHandler):
    db_path: Path
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _cors(self):
        # The reference applies CORS middleware to EVERY route (web.rs:110),
        # so the dev webview on :8080 can fetch files as well as JSON.
        self.send_header("Access-Control-Allow-Origin", "http://127.0.0.1:8080")

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self._cors()
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, msg):
        body = msg.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self._cors()
        self.end_headers()
        self.wfile.write(body)

    def _send_file(self, path: Path):
        """Static file with single-range support (video seeking, web.rs:54-67)."""
        try:
            size = path.stat().st_size
            f = open(path, "rb")
        except OSError:
            self._error(404, "404 Not Found")
            return
        ctype = mimetypes.guess_type(str(path))[0] or "application/octet-stream"
        range_header = self.headers.get("Range")
        start, end = 0, size - 1
        code = 200
        if range_header:
            m = re.match(r"bytes=(\d*)-(\d*)$", range_header.strip())
            if m and (m.group(1) or m.group(2)):
                if m.group(1):
                    start = int(m.group(1))
                    if m.group(2):
                        end = min(int(m.group(2)), size - 1)
                else:  # suffix range: last N bytes
                    n = int(m.group(2))
                    start = max(size - n, 0)
                if start > end or start >= size:
                    self._error(416, "Range Not Satisfiable")
                    f.close()
                    return
                code = 206
        length = end - start + 1
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Accept-Ranges", "bytes")
        self._cors()
        self.send_header("Content-Length", str(length))
        if code == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        try:
            f.seek(start)
            remaining = length
            while remaining > 0:
                chunk = f.read(min(1 << 20, remaining))
                if not chunk:
                    break
                self.wfile.write(chunk)
                remaining -= len(chunk)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            f.close()

    def _extract_on_demand(self, db: Db, pdf_hash: str):
        """Kick off (or report on) background extraction of a known PDF.

        Returns an (http_code, payload) pair for the in-progress/error cases,
        or None when the caller should re-read the now-finished record.
        Never runs pdftocairo on the request thread (a large deck would
        otherwise block this request for the whole extraction).
        """
        pdf_path = db.get_path(pdf_hash)
        if pdf_path is None or not pdf_path.exists():
            return 404, "Hash not known"
        if not pdf_io.have_poppler():
            return 503, "pdftocairo unavailable"
        with _extract_lock:
            job = _extract_jobs.get(pdf_hash)
            if job is None or (job["state"] == "failed" and job.get("retry", False)):
                job = {"state": "running"}
                _extract_jobs[pdf_hash] = job
                t = threading.Thread(
                    target=self._run_extraction,
                    args=(self.db_path, pdf_hash, pdf_path, job),
                    daemon=True,
                )
                t.start()
        if job["state"] == "running":
            return 202, {"status": "extracting"}
        if job["state"] == "failed":
            return 500, f"extraction failed: {job.get('error', 'unknown error')}"
        return None  # finished — caller re-reads the DB record

    @staticmethod
    def _run_extraction(db_path, pdf_hash: str, pdf_path: Path, job: dict) -> None:
        from . import pipeline

        db = Db(db_path)  # this thread's own connection: one never crosses threads
        try:
            pipeline.pdfs_to_images([(pdf_path, pdf_hash)], db)
            rec = db.get_pdf_extracted_pages_dir(pdf_hash)
            if rec is None or not rec.finished or not rec.dir.exists():
                raise RuntimeError("no pages were produced")
            job["state"] = "done"
        except Exception as e:  # surfaced to the polling client as 500
            job["state"] = "failed"
            job["error"] = str(e)
        finally:
            db.close()

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        db = Db(self.db_path)
        try:
            if path.startswith("/pdf-matchings/"):
                h = path.rsplit("/", 1)[1]
                if not _HASH_RE.match(h):
                    return self._error(400, "bad hash")
                return self._json(db.get_pdf_video_matchings(h))
            if path.startswith("/files/"):
                h = path.rsplit("/", 1)[1]
                if not _HASH_RE.match(h):
                    return self._error(400, "bad hash")
                p = db.get_path(h)
                if p is None or not p.exists():
                    return self._error(404, "Hash not known")
                return self._send_file(p)
            if path.startswith("/pdf-pages/"):
                parts = [p for p in path.split("/") if p][1:]
                if not parts or not _HASH_RE.match(parts[0]):
                    return self._error(400, "bad hash")
                rec = db.get_pdf_extracted_pages_dir(parts[0])
                if rec is None or not rec.finished or not rec.dir.exists():
                    # Viewer-only / drag&drop flow for a never-synced PDF:
                    # the reference serves the raw PDF and lets pdf.js render
                    # it (web.rs:54-67, viewer/index.ts:40-76); the
                    # server-rendered equivalent extracts pages on demand
                    # through the same two-phase cache, when the hash maps to
                    # a known file. Extraction runs off-request: 202 + poll.
                    res = self._extract_on_demand(db, parts[0])
                    if res is not None:
                        code, payload = res
                        if isinstance(payload, dict):
                            return self._json(payload, code)
                        return self._error(code, payload)
                    rec = db.get_pdf_extracted_pages_dir(parts[0])
                    if rec is None or not rec.finished or not rec.dir.exists():
                        return self._error(404, "no extracted pages")
                pages = pdf_io._scan_pages(rec.dir)
                if len(parts) == 1:
                    return self._json(
                        [
                            {
                                "page_idx": p.page_nr - 1,
                                "url": f"/pdf-pages/{parts[0]}/{p.page_nr}",
                            }
                            for p in pages
                        ]
                    )
                want = int(parts[1]) if parts[1].isdigit() else -1
                for p in pages:
                    if p.page_nr == want:
                        return self._send_file(p.image_path)
                return self._error(404, "no such page")
            # static viewer assets
            name = "index.html" if path == "/" else path.lstrip("/")
            asset = (STATIC_DIR / name).resolve()
            if not asset.is_relative_to(STATIC_DIR) or not asset.is_file():
                return self._error(404, "404 Not Found")
            return self._send_file(asset)
        finally:
            db.close()


def make_server(db_path: Path | None = None, port: int = PORT) -> ThreadingHTTPServer:
    """The viewer's server on 127.0.0.1:``port`` (0: any free port) over the
    store at ``db_path`` (None: ``db.default_db_path()``); each request
    opens its own connection."""
    handler = type("Handler", (_Handler,), {"db_path": db_path})
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def start_server(
    pdf_hash: str | None = None, db_path: Path | None = None, port: int = PORT
) -> None:
    """Blocking server start, printing the viewer URL (web.rs:98-124)."""
    server = make_server(db_path, port)
    if pdf_hash:
        print(f"View pdf on http://localhost:{port}/?pdf-hash={pdf_hash}")
    else:
        print(f"Server is running on http://localhost:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
