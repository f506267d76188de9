"""The benchmark's data files, found by name under ``portbench/``:
``workloads/<cell>.json`` names a configuration, a traffic mix, the number
of clients and the cell's own parameters and limits;
``configs/<config>.json`` is the configuration as it is run;
``traffic/<mix>.json`` the mix's parameters; ``metrics/<metric>.py`` the
reader of one per-layer metric; ``references/<name>.py`` the plain
reference that judges a configuration."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT.parent)})")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    """A cell with its configuration and traffic mix resolved:
    ``{"name", "config": {...}, "traffic": {...}, "clients", "dwell", ...}``."""
    c = _load("workloads", name)
    c["name"] = name
    c["config"] = _load("configs", c["config"])
    c["traffic"] = _load("traffic", c["traffic"])
    return c


def reference(conf: dict):
    """The class ``Reference`` of the plain reference that judges the
    configuration ``conf``: ``references/<name>.py``, where ``<name>`` is
    its ``"reference"`` key, or else its ``"engine"`` (the contract is in
    ``references/__init__.py``)."""
    name = conf.get("reference", conf["engine"])
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"reference name {name!r} is not a module name")
    module = f"portbench.references.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        path = ROOT / "references" / f"{name}.py"
        raise FileNotFoundError(f"no reference named {name!r} ({path.relative_to(ROOT.parent)})") from None
    return mod.Reference


def metric_module(name: str):
    """The reader of the per-layer metric ``name``: a module with ``UNIT``
    and ``read(run)``, which returns the metric or None when the run holds
    nothing to read it from."""
    return importlib.import_module(f"portbench.metrics.{name}")


def metric_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "metrics").glob("*.py") if not p.stem.startswith("_"))
