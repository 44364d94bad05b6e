"""Discovery by name: a cell, its configuration, its traffic mix, its driver
and its per-layer metrics' readers, each a file of its own.

``BENCHMARK.json`` (at the root of the checkout) lists the cells and the
metrics; ``gpubench/workloads/<cell>.json`` holds a cell's configuration
and traffic names, its ``why`` and the limits of its comparison;
``gpubench/configs/<config>.json`` the sizes, its ``"semantic_arch"``
naming its semantic trunk's kind; ``gpubench/reference/trunks/<kind>.py``
that trunk: its input rate, frame count, parameter holder, float32 forward
and FLOPs for one span (``reference/trunks/__init__.py`` finds it by the
name);
``gpubench/traffic/<mix>.json`` the mix's driver and parameters;
``gpubench/drivers/<driver>.py`` the shape of the load;
``gpubench/layer_metrics/<metric>.py`` a reader with
``read(ctx) -> float | None``.  Adding any of them adds files and entries,
never edits one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    spec: Dict          # gpubench/workloads/<cell>.json
    config: Dict        # gpubench/configs/<config>.json
    traffic: Dict       # gpubench/traffic/<mix>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = HERE.parent, listed: bool = True) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` under ``root`` lists it;
    with ``listed=False`` also a cell that only has its file (a parked
    cell, for the tools), then with no metrics."""
    bench = _json(root / "BENCHMARK.json")
    here = root / "gpubench"
    spec = _json(here / "workloads" / f"{name}.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        if listed:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        bench = dict(end_to_end=[], per_layer=[])
        entries = [spec]
    entry = entries[0]
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Cell(name, spec,
                _json(here / "configs" / f"{spec['config']}.json"),
                _json(here / "traffic" / f"{spec['traffic']}.json"),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                int(entry["chips"]))


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "gpubench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell, root: Path = HERE.parent) -> ModuleType:
    return _module(root / "gpubench" / "drivers"
                   / f"{cell.traffic['driver']}.py")


def reader(metric: str, root: Path = HERE.parent) -> ModuleType:
    return _module(root / "gpubench" / "layer_metrics" / f"{metric}.py")
