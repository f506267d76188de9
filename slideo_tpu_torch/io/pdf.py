"""Poppler subprocess wrappers: pdfinfo + pdftocairo.

Port of ``slideo_tpu/io/pdf.py`` (reference crates/pdftocairo/src/
{pdf_info.rs,pdftocairo.rs}), limited to what the engine calls: run the
poppler tools, poll the output directory for progress (pdftocairo.rs:
195-213), and parse ``p-NN.png`` file names into sorted page numbers
(pdftocairo.rs:217-232). ``SLIDEO_POPPLER_DIR`` names a poppler install
that is not on PATH.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

__all__ = ["PdfInfo", "Page", "have_poppler", "pdf_info", "pdftocairo"]

ProgressFn = Callable[[int, int, str], None]


@dataclass
class PdfInfo:
    pages: int
    raw: dict[str, str]


@dataclass
class Page:
    page_nr: int  # 1-based, like the reference (pdf_to_images.rs:18-31)
    image_path: Path


def _env() -> dict[str, str]:
    env = dict(os.environ)
    extra = env.get("SLIDEO_POPPLER_DIR")
    if extra:
        env["PATH"] = extra + os.pathsep + env.get("PATH", "")
    return env


def _which(tool: str) -> str | None:
    return shutil.which(tool, path=_env()["PATH"])


def have_poppler() -> bool:
    return _which("pdftocairo") is not None and _which("pdfinfo") is not None


def pdf_info(pdf: Path) -> PdfInfo:
    """Run ``pdfinfo`` and parse its ``Key: Value`` lines (pdf_info.rs:16-46)."""
    out = subprocess.run(
        ["pdfinfo", str(pdf)], capture_output=True, text=True, check=True, env=_env()
    ).stdout
    raw: dict[str, str] = {}
    for line in out.splitlines():
        if ":" in line:
            k, v = line.split(":", 1)
            raw[k.strip()] = v.strip()
    return PdfInfo(pages=int(raw.get("Pages", "0")), raw=raw)


_PAGE_RE = re.compile(r"^p-0*(\d+)\.(png|jpg|jpeg)$")


def _scan_pages(target_dir: Path) -> list[Page]:
    pages = []
    for f in target_dir.iterdir():
        m = _PAGE_RE.match(f.name)
        if m:
            pages.append(Page(page_nr=int(m.group(1)), image_path=f))
    pages.sort(key=lambda p: p.page_nr)
    return pages


def pdftocairo(
    pdf: Path,
    target_dir: Path,
    progress: ProgressFn | None = None,
    total_pages: int | None = None,
) -> list[Page]:
    """Rasterize all pages to ``target_dir/p-NN.png``; returns sorted pages.
    A directory that already holds files is reused as it is. Progress is
    reported by polling the output directory every 500 ms while the
    subprocess runs (pdftocairo.rs:195-213)."""
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    if any(target_dir.iterdir()):
        return _scan_pages(target_dir)

    proc = subprocess.Popen(
        ["pdftocairo", str(pdf), str(target_dir / "p"), "-png"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
    )
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            n = sum(1 for _ in target_dir.iterdir())
            if progress and total_pages:
                progress(n, total_pages, f"Extracting pages of {Path(pdf).name}...")
            time.sleep(0.5)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"pdftocairo failed ({proc.returncode}): {err.decode(errors='replace')}"
            )
    finally:
        stop.set()
        poller.join()
    return _scan_pages(target_dir)
