"""The benchmark's files: every name resolves, and BENCHMARK.json keeps to
the characters, sizes and keys that the format of BENCHMARK.json allows."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.lib import check, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p.split("/") and (ROOT / p).is_dir() for p in BENCH["paths"])
    assert not any(w.startswith("/") or ".." in w.split("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names(kind):
    return [entry["name"] for entry in BENCH[kind]]


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = _names(kind)
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names), names
    for entry in BENCH[kind]:
        for key in ("why", "layer", "source"):
            if key in entry and kind != "end_to_end":
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_units_and_keys(kind):
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    cells = set(_names("workloads"))
    for m in BENCH[kind]:
        assert set(m) <= allowed and UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    if kind == "end_to_end":
        assert "setup_s" in _names(kind)
        assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
                   for m in BENCH[kind])
    else:
        e2e = set(_names("end_to_end"))
        assert all(m["moves"] in e2e and m["source"] in
                   ("device_trace", "program_span", "program_counter", "host_clock") for m in BENCH[kind])


def test_every_configuration_and_cell_resolves_to_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"] and w["config"] in configs
        assert callable(spec.reference(cell["config"]))
        assert cell["chips"] == w["chips"]
        assert json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())["traffic"] \
            == w["traffic"]
        assert set(cell["limits"]) & set(check.WIDEST) and set(cell["limits"]) & {"answer_gap_median", "slide_gap_median"}
        assert set(cell["limits"]) <= set(check.numbers([])) - {"worst"}
    assert {c for w in BENCH["workloads"] for c in [w["config"]]} == set(configs)


def test_every_per_layer_metric_has_a_reader():
    readers = set(spec.metric_names())
    for m in BENCH["per_layer"]:
        assert m["name"] in readers
        mod = spec.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert PATH.fullmatch(p.relative_to(ROOT).as_posix()), p


FORBIDDEN = {"jax", "jaxlib", "flax", "slideo_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_whole_name_is_compared():
    assert not {"slideo_tpu_torch"} & FORBIDDEN
    assert "slideo_tpu" in check.FORBIDDEN and "slideo_tpu_torch" not in check.FORBIDDEN


YARDSTICK = ["lib/pages.py", "lib/traffic.py", "lib/peaks.py", "lib/window.py", "lib/seeds.py"] + sorted(
    p.relative_to(ROOT / "portbench").as_posix() for p in (ROOT / "portbench" / "references").glob("*.py"))


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert "slideo_tpu_torch" not in _imports(ROOT / "portbench" / name)


def test_nothing_reads_the_jax_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_r" not in text and "MULTICHIP" not in text, path


@pytest.mark.parametrize("prog, want_sim, want_rating", [
    (dict(changed=True, slide=9, similarity=0.9342, rating=512.0), 0.0889, 0.0),    # the grid's edge out on one side
    (dict(changed=True, slide=9, similarity=0.8453, rating=511.0), 0.0, 1 / 512),   # one inlier more on one side
    (dict(changed=True, slide=8, similarity=0.8453, rating=512.0), 1.0, 1.0),       # another slide
    (dict(changed=False), 1.0, 1.0),                                                # dropped by the dedup
])
def test_the_widest_gaps(prog, want_sim, want_rating):
    ref = dict(changed=True, slide=9, similarity=0.8453, rating=512.0, keypoints=2000, frame=268)
    dropped = dict(changed=False, frame=269)
    nums = check.numbers([(prog, ref, 9), (dict(changed=False), dropped, 9)])
    assert nums["answer_gap_max"] == pytest.approx(want_sim, abs=1e-4)
    assert nums["rating_answer_gap_max"] == pytest.approx(want_rating)
