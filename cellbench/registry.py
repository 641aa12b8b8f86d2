"""Finds the benchmark's pieces by name.

- ``cell(name)``: ``workloads/<name>.json`` (configuration, chips, traffic
  kind and its parameters, limits, why);
- ``config(name)``: ``configs/<name>.json``;
- ``traffic(kind)``: ``traffic/<kind>.py``, the generator and client loop
  of one kind of traffic;
- ``metric(name)``: ``metrics/<name>.py``, the reader of one per-layer
  metric;
- ``reference(kind)`` and ``work(kind)``: ``reference/<kind>.py`` and
  ``work/<kind>.py`` of one flow kind (the kind lower-cased).

Nothing here lists the pieces: adding one is adding its file. ``root`` is
the ``cellbench`` directory (a copy in the tests). This module imports
nothing of the program.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent

#: the names BENCHMARK.json allows: no space, comma or slash, at most 64
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")

_modules: dict = {}


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise LookupError(f"{path} does not exist")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the ``cellbench`` directory."""
    return _json(Path(root).parent / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    check_name(name, "cell")
    d = _json(Path(root) / "workloads" / f"{name}.json")
    if d.get("name", name) != name:
        raise ValueError(f"workloads/{name}.json names itself {d['name']!r}")
    return {**d, "name": name}


def config(name: str, root: Path = ROOT) -> dict:
    check_name(name, "configuration")
    d = _json(Path(root) / "configs" / f"{name}.json")
    if d.get("name", name) != name:
        raise ValueError(f"configs/{name}.json names itself {d['name']!r}")
    return {**d, "name": name}


def _module(path: Path, modname: str) -> ModuleType:
    key = str(path)
    mod = _modules.get(key)
    if mod is not None:
        return mod
    if not path.is_file():
        raise LookupError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _modules[key] = mod
    return mod


def _piece(folder: str, name: str, root: Path) -> ModuleType:
    check_name(name, folder)
    tag = re.sub(r"\W", "_", name)
    return _module(Path(root) / folder / f"{name}.py",
                   f"cellbench_{folder}_{tag}")


def traffic(kind: str, root: Path = ROOT) -> ModuleType:
    return _piece("traffic", kind, root)


def metric(name: str, root: Path = ROOT) -> ModuleType:
    return _piece("metrics", name, root)


def reference(kind: str, root: Path = ROOT) -> ModuleType:
    return _piece("reference", kind.lower(), root)


def work(kind: str, root: Path = ROOT) -> ModuleType:
    return _piece("work", kind.lower(), root)
