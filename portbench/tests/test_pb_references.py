"""A configuration brings its own plain reference and engine settings:
``spec.reference`` finds the ``Reference`` of ``references/<name>.py`` by the
configuration's ``reference`` key or its ``engine``, and
``client.build_config`` runs every section the file states and refuses a
key it would drop. A stub reference registered under
``portbench.references`` serves a SIFT configuration through
``spec.cell``, ``build_config``, ``spec.reference`` and ``check.compare``
with no edit to a file of the harness."""

import json
import sys
import types

import pytest
import torch

from portbench.client import build_config
from portbench.lib import check, pages, spec
from portbench.lib.run_data import Run
from portbench.lib.traffic import FilmedStream
from portbench.references import orb

CELLS = ["orb500-filmed-x4", "orb64-filmed-x4", "orb64-screencap-x4"]
SIFT = {"max_keypoints": 1024, "n_octaves": 4, "lowe_ratio": 0.75, "min_rating": 12.0}


class StubReference:
    """A reference for these tests: the dedup passes a frame that differs
    from the one before it, and a frame shows the page nearest to it."""

    def __init__(self, conf, deck, control=None):
        self.deck = deck.to(torch.int32)

    def changed(self, img, prev):
        return prev is None or not torch.equal(img, prev)

    def match_frame(self, img, k):
        slide = int((self.deck - img.to(torch.int32)).abs().flatten(1).sum(1).argmin())
        return dict(slide=slide, similarity=0.75, rating=float(k % 7), keypoints=0)


def _register(monkeypatch, name):
    mod = types.ModuleType(f"portbench.references.{name}")
    mod.Reference = StubReference
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_cells_resolve_to_the_orb_reference(cell_name):
    assert spec.reference(spec.cell(cell_name)["config"]) is orb.Reference


def test_a_reference_key_overrides_the_engine(monkeypatch):
    _register(monkeypatch, "orb_variant")
    conf = dict(spec.cell("orb64-filmed-x4")["config"], reference="orb_variant")
    assert spec.reference(conf) is StubReference


@pytest.mark.parametrize("key", ["engine", "reference"])
def test_an_unknown_reference_names_its_file(key):
    conf = dict(spec.cell("orb64-filmed-x4")["config"], **{key: "nosuch"})
    with pytest.raises(FileNotFoundError, match="portbench/references/nosuch.py"):
        spec.reference(conf)
    with pytest.raises(ValueError, match="not a module name"):
        spec.reference(dict(conf, **{key: "lib.check"}))


def test_build_config_runs_the_sift_section():
    cfg = build_config(dict(spec.cell("orb64-filmed-x4")["config"], engine="sift", sift=SIFT))
    assert cfg.engine == "sift"
    assert {k: getattr(cfg.sift, k) for k in SIFT} == SIFT


@pytest.mark.parametrize("cell_name", CELLS)
def test_build_config_builds_what_the_cells_ran(cell_name):
    """The configurations of the cells give the ``SlideoConfig`` that the
    harness built from ``orb`` (lists as tuples), ``match`` and ``video``
    alone, with ``sift`` at its defaults."""
    from slideo_tpu_torch.config import MatchConfig, OrbConfig, SlideoConfig, VideoConfig

    conf = spec.cell(cell_name)["config"]
    orb_ = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["orb"].items()}
    want = SlideoConfig(engine=conf["engine"], orb=OrbConfig(**orb_), match=MatchConfig(**conf["match"]),
                        video=VideoConfig(**conf["video"]))
    assert build_config(conf) == want


@pytest.mark.parametrize("section, key, named", [
    (None, "sfit", ["'sfit'"]),
    ("match", "ransac_iter", ["'ransac_iter'", "'match'"]),
    ("sift", "lowe", ["'lowe'", "'sift'"]),
])
def test_build_config_refuses_what_it_would_drop(section, key, named):
    conf = spec.cell("orb64-filmed-x4")["config"]
    if section is None:
        conf[key] = {}
    else:
        conf.setdefault(section, {})[key] = 1
    with pytest.raises(ValueError) as err:
        build_config(conf)
    assert all(n in str(err.value) for n in named), err.value


def _sift_files(root):
    """A SIFT configuration, a filmed mix and a cell of one client at a tiny
    size, as files under ``root`` laid out as ``portbench/`` is."""
    conf = spec.cell("orb64-filmed-x4")["config"]
    conf.update(name="sift-lecture-3", engine="sift", sift=SIFT)
    conf["deck"].update(pages=3, height=120, width=160)
    mix = dict(json.loads((spec.ROOT / "traffic" / "filmed.json").read_text()), pool=24, period=12)
    cell = dict(config="sift-lecture-3", traffic="filmed-24", clients=1, chips=1, dwell=3, check_frames=6,
                limits={"answer_gap_max": 0.0})
    for kind, name, data in [("configs", "sift-lecture-3", conf), ("traffic", "filmed-24", mix),
                             ("workloads", "sift-filmed-x1", cell)]:
        (root / kind).mkdir(parents=True, exist_ok=True)
        (root / kind / f"{name}.json").write_text(json.dumps(data))


@pytest.mark.parametrize("wrong", [False, True])
def test_a_stub_reference_serves_a_sift_configuration(monkeypatch, tmp_path, wrong):
    """The harness judges a SIFT cell by the reference found by name: a
    program that answers as the stub does is correct, one that names
    another slide is not."""
    _sift_files(tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    _register(monkeypatch, "sift")
    cell = spec.cell("sift-filmed-x1")
    conf = cell["config"]
    cfg = build_config(conf)
    assert cfg.engine == "sift" and cfg.sift.max_keypoints == SIFT["max_keypoints"]
    assert spec.reference(conf) is StubReference

    seed, first, last = 2**31 + 41, 30, 53
    deck = pages.make_deck(conf["deck"], seed, "cpu")
    stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], seed, 0)
    pool, sums = stream.make_pool(deck)
    program = StubReference(conf, deck)
    rows, answers = {}, {}
    for k in range(first, last + 1):
        img = torch.from_numpy(pool[k % stream.pool])
        prev = None if k == first else torch.from_numpy(pool[(k - 1) % stream.pool])
        if program.changed(img, prev):
            a = program.match_frame(img, k)
            slide = (a["slide"] + 1) % 3 if wrong else a["slide"]
            rows[k], answers[k] = slide, (slide, a["similarity"], a["rating"])
    report = dict(first=first, last=last, rows=rows, answers=answers, pool_sums=sums,
                  deck_sums=pages.checksums(deck))
    run = Run(cell=cell, seed=seed, seconds=1.0, t_start=0.0, t_run=0.0, ready=[{}], reports=[report])
    verdict = check.compare(run, "cpu")
    assert verdict["checks"]["inputs_differ"]["value"] == 0
    assert verdict["correct"] is not wrong, verdict["checks"]
