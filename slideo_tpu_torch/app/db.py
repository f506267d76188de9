"""SQLite matchings store, the viewer's on-disk contract.

Port of ``slideo_tpu/app/db.py`` (reference crates/app/src/db.rs and its
migration 20210309093718_setup.sql), limited to what the port's engine,
command line and viewer server call: the same schema, the same file
location (``SLIDEO_DB_DIR``, else ~/.config/Slideo/db/slideo.db), the same
SQL and row formats, so the JAX package, its viewer and the port read one
another's rows. The viewer's JSON rows (PdfVideoMatching, db.rs:194-201)
keep the reference's duration rule (the delta to the video's next mapping,
else 5000 ms, db.rs:212-271).
"""

from __future__ import annotations

import os
import sqlite3
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Db", "default_db_path", "MappingInfo", "PdfExtractedPagesDir"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS pdf_extracted_pages_dirs (
    pdf_hash TEXT PRIMARY KEY NOT NULL,
    dir TEXT NOT NULL UNIQUE,
    finished BOOLEAN NOT NULL
);
CREATE TABLE IF NOT EXISTS files (
    id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    file_path TEXT UNIQUE NOT NULL,
    hash TEXT UNIQUE NOT NULL
);
CREATE TABLE IF NOT EXISTS videos (
    id INTEGER NOT NULL PRIMARY KEY AUTOINCREMENT,
    video_hash TEXT NOT NULL UNIQUE,
    finished BOOLEAN NOT NULL
);
CREATE TABLE IF NOT EXISTS videos_pdfs (
    id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    video_id INTEGER NOT NULL REFERENCES videos (id) ON DELETE CASCADE,
    pdf_hash TEXT NOT NULL,
    UNIQUE (video_id, pdf_hash)
);
CREATE TABLE IF NOT EXISTS videos_mapping (
    id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    video_id INTEGER NOT NULL REFERENCES videos (id) ON DELETE CASCADE,
    video_ms INTEGER NOT NULL,
    pdf_hash TEXT,
    page INTEGER,
    UNIQUE (video_id, video_ms)
);
-- Extension of the reference schema: per-batch progress, so an interrupted
-- run resumes at frame granularity.
CREATE TABLE IF NOT EXISTS videos_mapping_partial (
    video_id INTEGER NOT NULL REFERENCES videos (id) ON DELETE CASCADE,
    frame_idx INTEGER NOT NULL,
    video_ms INTEGER NOT NULL,
    pdf_hash TEXT,
    page INTEGER,
    UNIQUE (video_id, frame_idx)
);
CREATE TABLE IF NOT EXISTS videos_progress (
    video_id INTEGER PRIMARY KEY REFERENCES videos (id) ON DELETE CASCADE,
    last_frame_idx INTEGER NOT NULL
);
"""


def default_db_path() -> Path:
    """~/.config/Slideo/db/slideo.db (reference: db.rs:28-44); SLIDEO_DB_DIR
    overrides the directory."""
    override = os.environ.get("SLIDEO_DB_DIR")
    if override:
        base = Path(override)
    else:
        xdg = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
        base = Path(xdg) / "Slideo" / "db"
    base.mkdir(parents=True, exist_ok=True)
    return base / "slideo.db"


@dataclass
class MappingInfo:
    pdf_hashes: list[str]
    finished: bool


@dataclass
class PdfExtractedPagesDir:
    pdf_hash: str
    dir: Path
    finished: bool


class Db:
    """Connection wrapper; SQLite's file lock makes concurrent instances safe."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else default_db_path()
        self.conn = sqlite3.connect(str(self.path), timeout=30.0)
        self.conn.execute("PRAGMA foreign_keys = ON")
        with self.conn:
            self.conn.executescript(_SCHEMA)

    def close(self) -> None:
        self.conn.close()

    def __enter__(self) -> "Db":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- files -----------------------------------------------------------------

    def update_hashes(self, file_hashes: list[tuple[str, str]]) -> None:
        """Record path <-> hash pairs (delete-then-insert, db.rs:106-130)."""
        with self.conn:
            for path, h in file_hashes:
                self.conn.execute(
                    "DELETE FROM files WHERE file_path = ? OR hash = ?", (path, h)
                )
                self.conn.execute(
                    "INSERT INTO files(file_path, hash) VALUES (?, ?)", (path, h)
                )

    def get_path(self, file_hash: str) -> Path | None:
        row = self.conn.execute(
            "SELECT file_path FROM files WHERE hash = ?", (file_hash,)
        ).fetchone()
        return Path(row[0]) if row else None

    # -- pdf page extraction cache (two-phase, db.rs:81-104, 318-341) ---------

    def get_pdf_extracted_pages_dir(self, pdf_hash: str) -> PdfExtractedPagesDir | None:
        row = self.conn.execute(
            "SELECT pdf_hash, dir, finished FROM pdf_extracted_pages_dirs"
            " WHERE pdf_hash = ?",
            (pdf_hash,),
        ).fetchone()
        if row is None:
            return None
        return PdfExtractedPagesDir(row[0], Path(row[1]), bool(row[2]))

    def set_pdf_extracted_pages_dir(self, data: PdfExtractedPagesDir) -> None:
        with self.conn:
            self.conn.execute(
                "DELETE FROM pdf_extracted_pages_dirs WHERE pdf_hash = ?",
                (data.pdf_hash,),
            )
            self.conn.execute(
                "INSERT INTO pdf_extracted_pages_dirs(pdf_hash, dir, finished)"
                " VALUES (?, ?, ?)",
                (data.pdf_hash, str(data.dir), data.finished),
            )

    # -- videos ----------------------------------------------------------------

    def create_or_reset_video(self, video_hash: str, pdf_hashes: list[str]) -> None:
        """Reset a video's cache entry to finished=false (db.rs:132-160)."""
        with self.conn:
            self.conn.execute("DELETE FROM videos WHERE video_hash = ?", (video_hash,))
            cur = self.conn.execute(
                "INSERT INTO videos(video_hash, finished) VALUES (?, 0)", (video_hash,)
            )
            for pdf_hash in pdf_hashes:
                self.conn.execute(
                    "INSERT INTO videos_pdfs(video_id, pdf_hash) VALUES (?, ?)",
                    (cur.lastrowid, pdf_hash),
                )

    def find_mapping_info(self, video_hash: str) -> MappingInfo | None:
        rows = self.conn.execute(
            "SELECT videos.id, finished, videos_pdfs.pdf_hash FROM videos"
            " LEFT JOIN videos_pdfs ON videos_pdfs.video_id = videos.id"
            " WHERE video_hash = ?",
            (video_hash,),
        ).fetchall()
        if not rows:
            return None
        return MappingInfo(
            pdf_hashes=[r[2] for r in rows if r[2] is not None],
            finished=bool(rows[0][1]),
        )

    def _video_id(self, video_hash: str) -> int:
        row = self.conn.execute(
            "SELECT id FROM videos WHERE video_hash = ?", (video_hash,)
        ).fetchone()
        if row is None:
            raise KeyError(f"video {video_hash} not registered")
        return row[0]

    def finalize_video_matchings(
        self, video_hash: str, matchings: list[tuple[int, str | None, int | None]]
    ) -> None:
        """Write the final timeline, mark the video finished and clear its
        checkpoint rows in one transaction (db.rs:162-191).

        matchings: (video_ms, pdf_hash or None, page_idx 0-based or None). A
        None pdf_hash row means "no slide visible" (page stored as 0, the
        reference's unwrap_or(0)).
        """
        video_id = self._video_id(video_hash)
        with self.conn:
            self.conn.execute("UPDATE videos SET finished = 1 WHERE id = ?", (video_id,))
            for video_ms, pdf_hash, page_idx in matchings:
                self.conn.execute(
                    "INSERT INTO videos_mapping(video_id, video_ms, pdf_hash, page)"
                    " VALUES (?, ?, ?, ?)",
                    (video_id, video_ms, pdf_hash, page_idx if page_idx is not None else 0),
                )
            self.conn.execute(
                "DELETE FROM videos_mapping_partial WHERE video_id = ?", (video_id,)
            )
            self.conn.execute("DELETE FROM videos_progress WHERE video_id = ?", (video_id,))

    # -- per-batch checkpoints -------------------------------------------------

    def save_partial_matchings(
        self,
        video_hash: str,
        rows: list[tuple[int, int, str | None, int | None]],
        last_frame_idx: int,
    ) -> None:
        """Checkpoint the frames decided so far.

        rows: (frame_idx, video_ms, pdf_hash or None, page_idx or None).
        """
        video_id = self._video_id(video_hash)
        with self.conn:
            for frame_idx, video_ms, pdf_hash, page in rows:
                self.conn.execute(
                    "INSERT OR REPLACE INTO videos_mapping_partial"
                    " (video_id, frame_idx, video_ms, pdf_hash, page)"
                    " VALUES (?, ?, ?, ?, ?)",
                    (video_id, frame_idx, video_ms, pdf_hash, page),
                )
            self.conn.execute(
                "INSERT OR REPLACE INTO videos_progress (video_id, last_frame_idx)"
                " VALUES (?, ?)",
                (video_id, last_frame_idx),
            )

    def load_partial_matchings(
        self, video_hash: str
    ) -> tuple[list[tuple[int, int, str | None, int | None]], int] | None:
        """(rows, last_frame_idx) of an interrupted run, or None."""
        try:
            video_id = self._video_id(video_hash)
        except KeyError:
            return None
        prog = self.conn.execute(
            "SELECT last_frame_idx FROM videos_progress WHERE video_id = ?",
            (video_id,),
        ).fetchone()
        if prog is None:
            return None
        rows = self.conn.execute(
            "SELECT frame_idx, video_ms, pdf_hash, page FROM videos_mapping_partial"
            " WHERE video_id = ? ORDER BY frame_idx",
            (video_id,),
        ).fetchall()
        return [tuple(r) for r in rows], prog[0]

    # -- viewer query (db.rs:212-271) ------------------------------------------

    def get_pdf_video_matchings(self, pdf_hash: str) -> list[dict]:
        """JSON rows of GET /pdf-matchings/{hash}: duration = delta to the
        next mapping of the same video (any pdf), else 5000 ms."""
        video_ids = self.conn.execute(
            "SELECT DISTINCT video_id FROM videos_pdfs WHERE pdf_hash = ?",
            (pdf_hash,),
        ).fetchall()
        result: list[dict] = []
        for (video_id,) in video_ids:
            rows = self.conn.execute(
                "SELECT video_ms, pdf_hash, page, video_hash FROM videos_mapping"
                " INNER JOIN videos ON videos.id = video_id"
                " WHERE video_id = ? ORDER BY video_ms ASC",
                (video_id,),
            ).fetchall()
            for i, (video_ms, row_pdf_hash, page, video_hash) in enumerate(rows):
                duration_ms = rows[i + 1][0] - video_ms if i + 1 < len(rows) else 5000
                if row_pdf_hash == pdf_hash:
                    result.append(
                        {
                            "video_offset_ms": video_ms,
                            "pdf_hash": row_pdf_hash,
                            "video_hash": video_hash,
                            "page_idx": page if page is not None else 0,
                            "duration_ms": duration_ms,
                        }
                    )
        return result
