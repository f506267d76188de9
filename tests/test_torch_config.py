"""The port's own copies of the JAX package's framework-free modules.

``slideo_tpu_torch`` imports nothing of ``slideo_tpu``: it keeps its own
config, SQLite store and cache paths. These tests hold each copy to its
original: the same config defaults field by field, rows written through the
port's ``Db`` read back identically through the JAX package's ``Db`` on the
same file, the same cache paths. ``port_cfg`` builds the port's config from
a JAX package config, so parity tests hand each package its own object.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest

from slideo_tpu import config as jconfig
from slideo_tpu.app import db as jdb
from slideo_tpu.app.hashing import get_temp_path_key as jkey
from slideo_tpu_torch import config as tconfig
from slideo_tpu_torch.app import db as tdb
from slideo_tpu_torch.app.hashing import get_temp_path_key as tkey


def port_cfg(cfg):
    """The port's config object with the values of a JAX package config
    (any of its dataclasses, nested ones included)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: port_cfg(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def test_config_defaults_equal_field_by_field():
    want, got = jconfig.DEFAULT_CONFIG, tconfig.DEFAULT_CONFIG
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("orb", "sift", "match", "video"):
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(want, name))]
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(got, name))]
        assert tf == jf, name
    assert got.orb.per_level_quota == want.orb.per_level_quota
    small = jconfig.OrbConfig(n_features=384, n_levels=4, scale_factor=1.3)
    assert port_cfg(small).per_level_quota == small.per_level_quota
    assert port_cfg(jconfig.DEFAULT_CONFIG) == got


def test_port_db_rows_read_back_by_jax_db(tmp_path, monkeypatch):
    monkeypatch.setenv("SLIDEO_DB_DIR", str(tmp_path / "dbdir"))
    assert tdb.default_db_path() == jdb.default_db_path()
    video, pdf = "v" * 64, "p" * 64
    timeline = [(0, pdf, 0), (5000, pdf, 3), (9000, None, None), (15000, None, None)]
    partial = [(0, 0, pdf, 0), (125, 5000, pdf, 3), (250, 10000, None, None)]

    with tdb.Db() as port:
        port.set_pdf_extracted_pages_dir(tdb.PdfExtractedPagesDir(pdf, tmp_path / "pages", False))
        port.set_pdf_extracted_pages_dir(tdb.PdfExtractedPagesDir(pdf, tmp_path / "pages", True))
        port.create_or_reset_video(video, [pdf])
        port.save_partial_matchings(video, partial, 250)
        with jdb.Db() as jax_db:
            assert jax_db.load_partial_matchings(video) == (partial, 250)
            assert jax_db.find_mapping_info(video) == jdb.MappingInfo([pdf], False)
        port.finalize_video_matchings(video, timeline)

    with jdb.Db() as jax_db:
        assert jax_db.get_pdf_extracted_pages_dir(pdf) == jdb.PdfExtractedPagesDir(
            pdf, tmp_path / "pages", True
        )
        assert jax_db.find_mapping_info(video) == jdb.MappingInfo([pdf], True)
        assert jax_db.load_partial_matchings(video) is None
        rows = jax_db.conn.execute(
            "SELECT video_ms, pdf_hash, page FROM videos_mapping ORDER BY video_ms"
        ).fetchall()
        assert rows == [(ms, h, p if p is not None else 0) for ms, h, p in timeline]
        assert [r["duration_ms"] for r in jax_db.get_pdf_video_matchings(pdf)] == [5000, 4000]
    with tdb.Db() as port:
        assert port.find_mapping_info(video) == tdb.MappingInfo([pdf], True)


@pytest.mark.parametrize("category,key", [("pdf", "abc-xyz"), ("index", "deck é 1")])
def test_temp_path_key_equal(category, key):
    assert tkey(category, key) == jkey(category, key)
    assert isinstance(tkey(category, key), Path)
