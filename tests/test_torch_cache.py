"""The port's persisted slide index and streamed cold build, on the CPU.

A deck of five page PNGs in two sizes (240 x 320 and 200 x 300, letterboxed
top-left with zero fill) is built from its files with 2 pages a chunk, so
a chunk boundary falls between the sizes. Tolerances:

1. ORB cold -> warm through the constructor: desc, valid and pts
   bit-equal; thumbnails within 0.07 (the f16 quantum at 255 is 0.0625,
   the JAX package's bound in tests/test_pipeline.py); the warm engine
   builds nothing and assigns the cold engine's slides.
2. SIFT cold -> warm: valid, pts and scale bit-equal; descriptors within
   1e-3 (float16 of unit descriptors); the same slides.
3. The streamed build is bit-equal to ``build_slide_index`` of the
   letterboxed batch, for both engines.
4. The archive's packed arrays equal ``np.packbits`` of the index, and the
   JAX package's loader reads the port's ORB archive to the same bits.
5. The key changes with the device type, the engine, ``cfg.orb`` and a
   page's bytes, stays for the same bytes under another path, and never
   equals the JAX package's key.
6. A truncated archive makes the engine rebuild; an error of the device
   side of a load is raised; an engine given ``page_grays`` leaves the
   temporary directory empty.

Every test isolates ``TMPDIR``, so no run is served another run's index.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from slideo_tpu.app import pipeline as jpipeline
from slideo_tpu.app.pipeline import PdfPage as JPdfPage
from slideo_tpu_torch.app import pipeline
from slideo_tpu_torch.app.pipeline import MatchingEngine, PdfPage
from slideo_tpu_torch.models import orb_matcher, sift_matcher
from test_pipeline import small_cfg  # noqa: F401  (shared fixture)
from test_torch_config import port_cfg
from test_torch_sift_engine import FAST_CFG as SIFT_CFG

torch.set_num_threads(1)

SIZES = [(240, 320), (240, 320), (200, 300), (200, 300), (240, 300)]
CHUNK = 2


def _page(rng: np.random.RandomState, hw, label: str) -> np.ndarray:
    h, w = hw
    img = np.full((h, w), 255, np.uint8)
    cv2.putText(img, label, (20, 40), cv2.FONT_HERSHEY_SIMPLEX, 1.0, 0, 2)
    for _ in range(22):
        y, x = rng.randint(60, h - 30), rng.randint(20, w - 60)
        cv2.rectangle(img, (x, y), (x + rng.randint(15, 50), y + rng.randint(4, 10)),
                      int(rng.randint(0, 120)), -1)
    return img


def _frame(page: np.ndarray, hw, angle: float, rng: np.random.RandomState) -> np.ndarray:
    """The page, letterboxed into ``hw``, rotated and scaled a little, with
    camera noise (an exact copy would match nothing)."""
    canvas = np.zeros(hw, np.uint8)
    canvas[:page.shape[0], :page.shape[1]] = page
    m = cv2.getRotationMatrix2D((hw[1] / 2, hw[0] / 2), angle, 0.97)
    f = cv2.warpAffine(canvas, m, (hw[1], hw[0]), borderValue=40).astype(np.float32)
    return np.clip(np.rint(f + rng.randn(*hw) * 2), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """Page files, the letterboxed batch, a stream of frames and the
    isolated temporary directory every cold engine of the module writes to."""
    root = tmp_path_factory.mktemp("deck")
    rng = np.random.RandomState(11)
    imgs = [_page(rng, hw, f"Pg {i + 1}") for i, hw in enumerate(SIZES)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(root / f"p-{i + 1}.png")
        cv2.imwrite(str(paths[-1]), img)
    pages = [PdfPage(root / "deck.pdf", "d" * 64, p, i + 1) for i, p in enumerate(paths)]
    hw = (max(h for h, _ in SIZES), max(w for _, w in SIZES))
    batch = np.zeros((len(imgs), *hw), np.uint8)
    for i, img in enumerate(imgs):
        batch[i, :img.shape[0], :img.shape[1]] = img
    frames = [_frame(imgs[1], hw, 2.0, rng), _frame(imgs[3], hw, -2.0, rng),
              rng.randint(0, 256, hw).astype(np.uint8)]
    samples = [(25 * i, 5.0 * i, f) for i, f in enumerate(frames)]
    tmp = tmp_path_factory.mktemp("tmpdir")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(tmp))
        mp.setattr(MatchingEngine, "_BUILD_CHUNK", CHUNK)
        tempfile.tempdir = None
        yield dict(paths=paths, pages=pages, batch=batch, samples=samples, tmp=tmp)
    tempfile.tempdir = None


@pytest.fixture
def isolated_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    yield tmp_path
    tempfile.tempdir = None


def _slides(engine: MatchingEngine, samples) -> list:
    out = engine.match_samples(samples, total_ms=15000, total_frames=75)
    return [(m.video_ms, m.page.page_nr if m.page else None) for m in out]


def _cold_and_warm(deck, cfg):
    cold = MatchingEngine(cfg, deck["pages"], device="cpu")
    cold_build = dict(pipeline.LAST_BUILD_BREAKDOWN)

    def no_build(*a, **kw):
        raise AssertionError("the warm engine built its index")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orb_matcher, "build_slide_index_from_chunks", no_build)
        mp.setattr(sift_matcher, "build_slide_index_sift_from_chunks", no_build)
        warm = MatchingEngine(cfg, deck["pages"], device="cpu")
    assert set(cold_build) >= {"hash_key_s", "letterbox_s", "extract_s", "save_s",
                               "save_fetch_s", "save_write_s"}
    assert pipeline.LAST_BUILD_BREAKDOWN == {}
    assert set(pipeline.LAST_LOAD_BREAKDOWN) == {"read_s", "upload_assemble_s"}
    assert cold.slide_hw == warm.slide_hw == deck["batch"].shape[1:]
    return cold, warm


def test_orb_warm_load_equals_cold_build(deck, small_cfg):  # noqa: F811
    cold, warm = _cold_and_warm(deck, port_cfg(small_cfg))
    c, w = cold.index, warm.index
    for f in ("desc", "valid", "slide_ids", "train_ids"):
        assert torch.equal(getattr(c.desc_index, f), getattr(w.desc_index, f)), f
    assert torch.equal(c.pts, w.pts)
    assert (c.smalls - w.smalls).abs().max().item() <= 0.07
    want = _slides(cold, deck["samples"])
    assert [p for _, p in want] == [2, 4, None]
    assert _slides(warm, deck["samples"]) == want


def test_sift_warm_load_equals_cold_build(deck):
    cold, warm = _cold_and_warm(deck, port_cfg(SIFT_CFG))
    c, w = cold.index, warm.index
    for f in ("valid", "pts", "scale"):
        assert torch.equal(getattr(c, f), getattr(w, f)), f
    assert (c.desc - w.desc).abs().max().item() <= 1e-3
    assert (c.smalls - w.smalls).abs().max().item() <= 0.07
    want = _slides(cold, deck["samples"])
    assert [p for _, p in want] == [2, 4, None]
    assert _slides(warm, deck["samples"]) == want


@pytest.mark.parametrize("engine", ["orb", "sift"])
def test_streamed_build_equals_one_batch(deck, small_cfg, engine, isolated_tmp):  # noqa: F811
    cfg = port_cfg(small_cfg if engine == "orb" else SIFT_CFG)
    streamed = MatchingEngine(cfg, deck["pages"], device="cpu").index
    if engine == "orb":
        one = orb_matcher.build_slide_index(deck["batch"], cfg, "cpu")
        pairs = [(getattr(streamed.desc_index, f), getattr(one.desc_index, f))
                 for f in ("desc", "valid")]
    else:
        one = sift_matcher.build_slide_index_sift(deck["batch"], cfg, "cpu")
        pairs = [(streamed.desc, one.desc), (streamed.valid, one.valid), (streamed.scale, one.scale)]
    pairs += [(streamed.pts, one.pts), (streamed.smalls, one.smalls)]
    for a, b in pairs:
        assert torch.equal(a, b)


def test_archive_is_the_jax_packages_layout(deck, small_cfg, isolated_tmp):  # noqa: F811
    cfg = port_cfg(small_cfg)
    engine = MatchingEngine(cfg, deck["pages"], device="cpu")
    key = pipeline._index_cache_key(deck["pages"], cfg, "cpu")
    path = pipeline._index_path(key)
    assert path == jpipeline.get_temp_path_key("index", key) / "index.npz"
    s, k = engine.index.pts.shape[:2]
    desc = engine.index.desc_index.desc.numpy().reshape(s, k, -1)
    valid = engine.index.desc_index.valid.numpy().reshape(s, k)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(pipeline._ORB_ARRAYS)
        assert np.array_equal(z["desc_bits"], np.packbits(desc > 0, axis=-1))
        assert np.array_equal(z["valid"], np.packbits(valid, axis=-1))
        assert z["desc_bits"].dtype == z["valid"].dtype == np.uint8
        assert z["pts"].dtype == np.float32 and z["smalls_f16"].dtype == np.float16
        assert z["slide_hw"].tolist() == list(engine.slide_hw)
    # The JAX package's own loader reads the port's archive.
    loaded, slide_hw = jpipeline._load_orb_index(key)
    assert tuple(slide_hw) == engine.slide_hw
    assert np.array_equal(np.asarray(loaded.desc_index.desc), engine.index.desc_index.desc.numpy())
    assert np.array_equal(np.asarray(loaded.desc_index.valid), engine.index.desc_index.valid.numpy())
    assert np.array_equal(np.asarray(loaded.pts), engine.index.pts.numpy())
    sift = MatchingEngine(port_cfg(SIFT_CFG), deck["pages"], device="cpu").index
    skey = pipeline._index_cache_key(deck["pages"], port_cfg(SIFT_CFG), "cpu")
    with np.load(pipeline._index_path(skey)) as z:
        assert sorted(z.files) == sorted(pipeline._SIFT_ARRAYS)
        assert np.array_equal(z["valid"], np.packbits(sift.valid.numpy()))
        assert z["desc_f16"].dtype == np.float16


def test_cache_key(deck, small_cfg, tmp_path):  # noqa: F811
    cfg = port_cfg(small_cfg)
    pages = deck["pages"]
    key = pipeline._index_cache_key(pages, cfg, "cpu")
    assert pipeline._index_cache_key(pages, cfg, torch.device("cpu")) == key
    assert pipeline._index_cache_key(pages, cfg, "cuda") != key
    assert pipeline._index_cache_key(pages, dataclasses.replace(cfg, engine="sift"), "cpu") != key
    other_orb = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, fast_threshold=21))
    assert pipeline._index_cache_key(pages, other_orb, "cpu") != key
    # The same bytes under another path: the same key. One changed byte: another.
    moved = []
    for p in pages:
        q = tmp_path / f"moved-{p.page_nr}.png"
        q.write_bytes(p.image_path.read_bytes())
        moved.append(PdfPage(Path("other.pdf"), "e" * 64, q, p.page_nr))
    assert pipeline._index_cache_key(moved, cfg, "cpu") == key
    data = bytearray(moved[2].image_path.read_bytes())
    data[-1] ^= 1
    moved[2].image_path.write_bytes(bytes(data))
    assert pipeline._index_cache_key(moved, cfg, "cpu") != key
    # Never the JAX package's key on the same pages and config.
    jpages = [JPdfPage(p.pdf_path, p.pdf_hash, p.image_path, p.page_nr) for p in pages]
    assert jpipeline._index_cache_key(jpages, small_cfg) not in (
        key, pipeline._index_cache_key(pages, cfg, "cuda"))


def test_truncated_archive_rebuilds(deck, small_cfg, isolated_tmp):  # noqa: F811
    cfg = port_cfg(small_cfg)
    cold = MatchingEngine(cfg, deck["pages"], device="cpu")
    path = pipeline._index_path(pipeline._index_cache_key(deck["pages"], cfg, "cpu"))
    whole = path.read_bytes()
    for cut in (len(whole) // 2, len(whole) - 30, 100):
        path.write_bytes(whole[:cut])
        again = MatchingEngine(cfg, deck["pages"], device="cpu")
        assert "extract_s" in pipeline.LAST_BUILD_BREAKDOWN, cut
        assert pipeline.LAST_LOAD_BREAKDOWN == {}, cut
        assert torch.equal(again.index.desc_index.desc, cold.index.desc_index.desc)
        assert path.read_bytes() == whole  # the rebuild saved the index again


def test_device_side_load_error_is_raised(deck, small_cfg, isolated_tmp, monkeypatch):  # noqa: F811
    cfg = port_cfg(small_cfg)
    MatchingEngine(cfg, deck["pages"], device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("device fault while unpacking")

    monkeypatch.setattr(pipeline.hamming, "unpack_descriptor_bits", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        MatchingEngine(cfg, deck["pages"], device="cpu")


def test_page_grays_leave_the_cache_alone(deck, small_cfg, isolated_tmp):  # noqa: F811
    engine = MatchingEngine(port_cfg(small_cfg), deck["pages"], device="cpu",
                            page_grays=deck["batch"])
    assert set(pipeline.LAST_BUILD_BREAKDOWN) == {"extract_s"}
    assert engine.slide_hw == deck["batch"].shape[1:]
    assert list(isolated_tmp.iterdir()) == []


def test_chip_smoke_png_writer_decodes_to_its_page(tmp_path):
    """chip_smoke.py writes its decks' pages with zlib and struct alone
    (the card's machine has no image codec); OpenCV decodes each to the
    page's bytes, and the pipeline reads its size from the header, so a
    warm engine's key names files that hold exactly the cold run's deck."""
    import chip_smoke

    rng = np.random.RandomState(3)
    for hw in ((7, 9), (180, 241)):
        page = rng.randint(0, 256, hw).astype(np.uint8)
        path = tmp_path / f"p-{hw[1]}.png"
        chip_smoke.write_png(path, page)
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), page)
        assert pipeline._png_size(path) == hw
