"""Every configuration, cell and metric of BENCHMARK.json has its file,
and the files agree with it."""

import json
import pathlib

import pytest

from mdbench import reference, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["style"] in ("lj", "eam") and cfg["units"] in reference.UNITS
    if cfg["style"] == "eam":
        eam = reference.read_eam(ROOT / "mdbench/configs" / cfg["potential"])
        assert eam.mass > 0 and eam.cut > 4.0


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file_loads(entry):
    cell = spec.cell(entry["name"])
    wl = cell.workload
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    assert len(wl["lattice"]) == 3 and wl["steps_per_run"] > 0
    assert set(wl["limits"]) == {"lost", "misplaced", "regrown", "force_gap",
                                 "T_gap", "U_gap", "P_gap", "U0_gap",
                                 "P0_gap", "x_gap", "v_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"atom_steps_per_s",
                                                    "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    assert callable(spec.reader(metric["name"]))
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}
