"""What a cell is made of, found by name under a benchmark root.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
the metrics with the cells that report them.  Everything else is a file of
its own, found by the name it goes by there:

* ``portbench/configs/<config>.json`` (the ``file`` of the configuration):
  the plant's settings as run, under ``sim``, and the agents' files;
* ``portbench/traffic/<traffic>.json``: a mix's parameters, and under
  ``driver`` the name of the generator that reads them,
  ``portbench/traffic/<driver>.py``;
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.

So a later cell, mix or metric is added by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration's file
    traffic_name: str
    traffic: dict         # the mix's file
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(cell: Cell):
    drv = cell.traffic["driver"]
    return load_module(cell.root / "portbench" / "traffic" / f"{drv}.py",
                       f"portbench_driver_{drv}")


def metric_reader(cell: Cell, metric: str):
    """The ``read(readings)`` of the metric's own file."""
    mod = load_module(cell.root / "portbench" / "metrics" / f"{metric}.py",
                      "portbench_metric_" + metric.replace(".", "_"))
    return mod.read
