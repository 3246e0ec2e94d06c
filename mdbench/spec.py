"""Where the benchmark finds a cell: everything is looked up by name.

- BENCHMARK.json (beside this folder) lists the cells and the metrics;
- mdbench/workloads/<cell>.json holds a cell's run: its configuration,
  lattice, run() length, chips, traced calls and the limits of its checks;
- mdbench/configs/<config>.json holds a configuration's physics;
- mdbench/metrics/<metric>.py reads one per-layer metric from a traced
  run: `read(ctx) -> float | None`.

A new cell, configuration or per-layer metric is a new file and a new
entry in BENCHMARK.json; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list
    config_dir: pathlib.Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def potential(self):
        pot = self.config.get("potential")
        return None if pot is None else self.config_dir / pot


def _reports(metric: dict, cell: str, e2e: set) -> bool:
    """A per-layer metric is reported in the cells it lists, else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


def cell(name: str) -> Cell:
    """The cell `name`: its workload and configuration files and the
    metrics BENCHMARK.json has it report."""
    bench = json.loads(BENCHMARK.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} {wl[key]!r} in its workload "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    cfg = json.loads((HERE / "configs" / f"{entry['config']}.json")
                     .read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=cfg, workload=wl, end_to_end=e2e,
                per_layer=per_layer, config_dir=HERE / "configs")


def reader(metric: str):
    """The `read` function of mdbench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"mdbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
