"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.json`` with its kind's generator ``traffic/<kind>.py``,
``reference/<name>.py``, ``data/<name>.py`` and ``metrics/<metric>.py``.
A later cell, mix, configuration or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Dict, List, Optional

PORTBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


class SpecError(ValueError):
    """A name that does not resolve, or files that disagree."""


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(path: pathlib.Path) -> ModuleType:
    """Import a file of this tree by path (names may hold dots)."""
    if not path.is_file():
        raise SpecError(f"no file {path.relative_to(ROOT)}")
    name = "portbench_" + "_".join(
        path.relative_to(PORTBENCH).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None


@dataclasses.dataclass
class Cell:
    """One cell with everything its run reads."""
    name: str
    chips: int
    config: dict            # configs/<config>.json, plus "name"
    traffic: dict           # traffic/<traffic>.json, plus "name"
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def kind(self) -> ModuleType:
        """The traffic kind's generator, ``traffic/<kind>.py``."""
        return load_module(PORTBENCH / "traffic" / f"{self.traffic['kind']}.py")

    def reference(self) -> ModuleType:
        """The configuration's plain reference."""
        return load_module(PORTBENCH / "reference"
                           / f"{self.config['reference']}.py")

    def data(self) -> ModuleType:
        """The configuration's data generator."""
        return load_module(PORTBENCH / "data" / f"{self.config['data']}.py")


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _metrics(entries: List[dict]) -> List[Metric]:
    return [Metric(**e) for e in entries]


def metrics_of(bench: dict, cell: str) -> tuple:
    """The cell's end-to-end metrics (those without ``workloads`` and those
    that list it) and the per-layer metrics that list it; a per-layer
    metric without ``workloads`` is refused."""
    e2e = [m for m in _metrics(bench["end_to_end"])
           if m.workloads is None or cell in m.workloads]
    layer = _metrics(bench["per_layer"])
    missing = [m.name for m in layer if m.workloads is None]
    if missing:
        raise SpecError(f"per-layer metrics without workloads: {missing}")
    return e2e, [m for m in layer if cell in m.workloads]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``SpecError`` where a name does not resolve or the cell's file
    disagrees with ``BENCHMARK.json``."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"BENCHMARK.json has no workload {name!r}")
    own = _json(PORTBENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise SpecError(f"workloads/{name}.json says {key} "
                            f"{own[key]!r}, BENCHMARK.json {entry[key]!r}")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise SpecError(f"BENCHMARK.json has no config {entry['config']!r}")
    config = dict(_json(ROOT / conf["file"]), name=conf["name"])
    traffic = dict(_json(PORTBENCH / "traffic" / f"{entry['traffic']}.json"),
                   name=entry["traffic"])
    e2e, layer = metrics_of(bench, name)
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, limits=dict(own["limits"]),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str) -> ModuleType:
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``
    with ``read(ctx) -> float | None``."""
    return load_module(PORTBENCH / "metrics" / f"{metric}.py")
