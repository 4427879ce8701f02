"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here knows a cell, a configuration, a traffic mix or a metric by
name: each is a file found from its name, so a later change adds one by
adding files and entries and edits none.

* a configuration: the ``file`` its entry in ``configs`` names;
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a cell's limits on the numbers that decide ``correct``:
  ``portbench/limits/<workload>.json``;
* a metric, end-to-end or per-layer: ``portbench/metrics/<name>.py``, a
  module with ``read(reading) -> float | None``;
* a model family's plain reference, weights and work counts:
  ``portbench/reference/<family>.py``;
* a kernel family's device-kernel names: one ``.txt`` file a name under
  ``portbench/kernels/<family>/``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # the numbers' limits
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], wl["config"], "configuration")
    here = root / "portbench"
    return Cell(
        name=name, chips=int(wl["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (here / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
        root=root)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric ``name`` (``read(reading)``)."""
    return _module(root / "portbench" / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_")
                   .replace("-", "_"))


def family(name: str, root: Path = ROOT) -> ModuleType:
    """The plain reference of model family ``name``."""
    return _module(root / "portbench" / "reference" / f"{name}.py",
                   "portbench_family_" + name)


def kernel_names(kind: str, root: Path = ROOT) -> List[str]:
    """The device-kernel names of kernel family ``kind``: each file's
    stripped text, matched as a substring of a traced kernel's name."""
    return sorted(p.read_text().strip() for p in
                  (root / "portbench" / "kernels" / kind).glob("*.txt"))


def peaks(root: Path = ROOT) -> Dict[str, float]:
    return json.loads((root / "portbench" / "work" / "peaks.json")
                      .read_text())
