// Viewer logic: equivalent of the reference webview's Model + MainView +
// pdf.js overlay (webview/src/model/index.ts, components/MainView.tsx,
// viewer/index.ts): fetch /pdf-matchings/{hash}, render every page with a
// play button showing the matched duration, and on click set the video to
// /files/{videoHash}, seek to offsetMs and play (MainView.tsx:53-62).
//
// Page rendering is progressive: when the raw PDF is reachable at
// /files/{pdf-hash} and pdf.js loads, pages render client-side to
// canvases at devicePixelRatio — crisp at any zoom, like the reference's
// pdf.js viewer (viewer/index.ts:40-76). pdf.js is loaded from the
// wheel's vendored copy first (/vendor/*, installed by
// tools/vendor_pdfjs.py at release-build time — the reference embeds all
// viewer assets via rust-embed, web.rs:69-71, so offline must work) and
// only from the CDN when the vendored copy is absent (dev checkouts).
// If neither loads (air-gapped dev checkout, or the deck was registered
// from pre-extracted pages without the PDF) the viewer falls back to the
// server-rendered PNGs.
"use strict";

const PDFJS_CDN = "https://cdnjs.cloudflare.com/ajax/libs/pdf.js/3.11.174";

const params = new URLSearchParams(location.search);
const pdfHash = params.get("pdf-hash");
const serverUrl = params.get("server-url") || "";

const pagesEl = document.getElementById("pages");
const videoEl = document.getElementById("video");
const statusEl = document.getElementById("status");
const rateEl = document.getElementById("rate");

let currentVideoHash = null;

rateEl.addEventListener("change", () => {
  videoEl.playbackRate = parseFloat(rateEl.value);
});

function fmtDuration(ms) {
  const s = Math.round(ms / 1000);
  return `${String(Math.floor(s / 60)).padStart(2, "0")}:${String(s % 60).padStart(2, "0")}`;
}

function playVideo(offsetMs, videoHash) {
  if (currentVideoHash !== videoHash) {
    videoEl.src = `${serverUrl}/files/${videoHash}`;
    currentVideoHash = videoHash;
  }
  videoEl.currentTime = offsetMs / 1000;
  videoEl.playbackRate = parseFloat(rateEl.value);
  videoEl.play();
}

function loadScript(src) {
  return new Promise((resolve, reject) => {
    const s = document.createElement("script");
    s.src = src;
    s.onload = resolve;
    s.onerror = () => reject(new Error(`failed to load ${src}`));
    document.head.appendChild(s);
  });
}

// Try to open the raw PDF with pdf.js; null on any failure (no network,
// PDF not on the server, parse error) — callers fall back to PNG pages.
async function tryOpenPdf() {
  try {
    const head = await fetch(`${serverUrl}/files/${pdfHash}`, {
      method: "GET",
      headers: { Range: "bytes=0-3" },
    });
    if (!head.ok) return null;
    const magic = new Uint8Array(await head.arrayBuffer());
    if (String.fromCharCode(...magic.slice(0, 4)) !== "%PDF") return null;
    try {
      // Vendored copy (self-contained wheel; works offline).
      await loadScript(`${serverUrl}/vendor/pdf.min.js`);
      window.pdfjsLib.GlobalWorkerOptions.workerSrc =
        `${serverUrl}/vendor/pdf.worker.min.js`;
    } catch (e) {
      // Dev checkout without vendored assets: CDN fallback.
      await loadScript(`${PDFJS_CDN}/pdf.min.js`);
      window.pdfjsLib.GlobalWorkerOptions.workerSrc =
        `${PDFJS_CDN}/pdf.worker.min.js`;
    }
    return await window.pdfjsLib.getDocument(`${serverUrl}/files/${pdfHash}`)
      .promise;
  } catch (e) {
    return null;
  }
}

// Lazy, zoom-aware canvas rendering: a page renders when it scrolls into
// view, at its on-screen CSS size x devicePixelRatio; browser zoom changes
// devicePixelRatio, so a re-render keeps glyph edges sharp at any zoom.
const pageObserver = new IntersectionObserver(
  (entries) => {
    for (const e of entries) {
      if (e.isIntersecting) renderPdfCanvas(e.target);
    }
  },
  { rootMargin: "200px" }
);
let _resizeTimer;
window.addEventListener("resize", () => {
  clearTimeout(_resizeTimer);
  _resizeTimer = setTimeout(() => {
    for (const c of document.querySelectorAll("canvas.pdf-page")) {
      c.dataset.renderedScale = "";
      pageObserver.unobserve(c);
      pageObserver.observe(c);
    }
  }, 250);
});

async function renderPdfCanvas(canvas) {
  const doc = canvas._pdfDoc;
  const scale = (window.devicePixelRatio || 1) * (canvas.clientWidth || 800);
  if (!doc || canvas.dataset.rendering === "1" ||
      canvas.dataset.renderedScale === String(scale)) {
    return;
  }
  canvas.dataset.rendering = "1";
  try {
    const page = await doc.getPage(Number(canvas.dataset.pageNr));
    const base = page.getViewport({ scale: 1 });
    const cssW = canvas.clientWidth || 800;
    const vp = page.getViewport({
      scale: ((window.devicePixelRatio || 1) * cssW) / base.width,
    });
    canvas.width = vp.width;
    canvas.height = vp.height;
    await page.render({ canvasContext: canvas.getContext("2d"), viewport: vp })
      .promise;
    canvas.dataset.renderedScale = String(scale);
  } finally {
    canvas.dataset.rendering = "0";
  }
}

async function init() {
  if (!pdfHash) {
    statusEl.textContent = "No ?pdf-hash= given.";
    return;
  }
  statusEl.textContent = "Loading…";
  let [pagesRes, matchRes] = await Promise.all([
    fetch(`${serverUrl}/pdf-pages/${pdfHash}`),
    fetch(`${serverUrl}/pdf-matchings/${pdfHash}`),
  ]);
  // 202 = the server is extracting the deck's pages in the background
  // (drag&dropped, never-synced PDF) — poll until it finishes.
  while (pagesRes.status === 202) {
    statusEl.textContent = "Extracting pdf pages…";
    await new Promise((r) => setTimeout(r, 1000));
    pagesRes = await fetch(`${serverUrl}/pdf-pages/${pdfHash}`);
  }
  if (!pagesRes.ok) {
    statusEl.textContent =
      pagesRes.status === 404
        ? "Unknown pdf — sync it once with the slideo CLI first."
        : `Could not load pdf pages (${pagesRes.status}).`;
    return;
  }
  const pages = await pagesRes.json();
  const matchings = matchRes.ok ? await matchRes.json() : [];
  const pdfDoc = await tryOpenPdf(); // null -> PNG fallback

  // First matching per page (viewer/index.ts:40-76 uses the first one).
  const byPage = new Map();
  for (const m of matchings) {
    if (!byPage.has(m.page_idx)) byPage.set(m.page_idx, []);
    byPage.get(m.page_idx).push(m);
  }
  for (const list of byPage.values()) {
    list.sort((a, b) => a.video_offset_ms - b.video_offset_ms);
  }

  for (const p of pages) {
    const div = document.createElement("div");
    div.className = "page";
    if (pdfDoc && p.page_idx + 1 <= pdfDoc.numPages) {
      const canvas = document.createElement("canvas");
      canvas.className = "pdf-page";
      canvas.dataset.pageNr = String(p.page_idx + 1);
      canvas._pdfDoc = pdfDoc;
      div.appendChild(canvas);
      pageObserver.observe(canvas);
    } else {
      const img = document.createElement("img");
      img.loading = "lazy";
      img.src = `${serverUrl}${p.url}`;
      div.appendChild(img);
    }
    const badge = document.createElement("div");
    badge.className = "badge";
    const ms = byPage.get(p.page_idx);
    if (ms && ms.length) {
      for (const m of ms.slice(0, 3)) {
        const btn = document.createElement("button");
        btn.className = "play-btn";
        btn.textContent = `▶ ${fmtDuration(m.video_offset_ms)} (${fmtDuration(m.duration_ms)})`;
        btn.title = "Play video from this slide";
        btn.addEventListener("click", () => playVideo(m.video_offset_ms, m.video_hash));
        badge.appendChild(btn);
      }
    } else {
      div.classList.add("no-match");
    }
    div.appendChild(badge);
    pagesEl.appendChild(div);
  }
  statusEl.textContent = `${pages.length} pages, ${matchings.length} matchings.`;
}

// Drag & drop a PDF to switch decks: hash the file client-side and reload
// with its content hash (reference: MainView.tsx:36-45 using js-sha256;
// WebCrypto here).
document.body.addEventListener("dragover", (e) => e.preventDefault());
document.body.addEventListener("drop", async (e) => {
  e.preventDefault();
  const file = e.dataTransfer && e.dataTransfer.files && e.dataTransfer.files[0];
  if (!file) return;
  statusEl.textContent = `Hashing ${file.name}…`;
  const buf = await file.arrayBuffer();
  const digest = await crypto.subtle.digest("SHA-256", buf);
  const hex = [...new Uint8Array(digest)].map((b) => b.toString(16).padStart(2, "0")).join("");
  const p = new URLSearchParams(location.search);
  p.set("pdf-hash", hex);
  location.search = p.toString();
});

init();
