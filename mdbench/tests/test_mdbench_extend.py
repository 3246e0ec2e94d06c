"""A later change adds a configuration, a cell and a per-layer metric as
new files and new BENCHMARK.json entries: in a copy of the benchmark, the
harness finds and runs all three with no edit to any file it has."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

DRIVE = r"""
import json, time
from mdbench import spec, run
cell = spec.cell("tiny_lj.fcc6.run20")
res = run.run_cell(cell, 11, 0, True, ["cpu"], time.perf_counter())
got = {m["name"]: spec.reader(m["name"])(res["ctx"]) for m in cell.per_layer}
print(json.dumps({"config": cell.config["name"], "correct": res["correct"],
                  "natoms": res["natoms"], "metrics": got}))
"""


def test_new_config_cell_and_metric_need_no_edit(tmp_path):
    shutil.copytree(ROOT / "mdbench", tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "mdbench").rglob("*") if p.is_file()}

    cfg = json.loads((ROOT / "mdbench/configs/lj_fcc.json").read_text())
    cfg["name"] = "tiny_lj"
    (tmp_path / "mdbench/configs/tiny_lj.json").write_text(json.dumps(cfg))
    wl = json.loads((ROOT / "mdbench/workloads/lj_fcc.131k.json")
                    .read_text())
    wl.update(config="tiny_lj", traffic="fcc6.run20", lattice=[6, 6, 6],
              steps_per_run=20, trace_runs=2, why="a throwaway cell")
    (tmp_path / "mdbench/workloads/tiny_lj.fcc6.run20.json").write_text(
        json.dumps(wl))
    (tmp_path / "mdbench/metrics/sim.runs_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.calls('sim.run')\n")
    bench["configs"].append({"name": "tiny_lj", "source": cfg["source"],
                             "file": "mdbench/configs/tiny_lj.json",
                             "reduced": [], "why": "a throwaway config"})
    bench["workloads"].append({"name": "tiny_lj.fcc6.run20",
                               "config": "tiny_lj", "traffic": "fcc6.run20",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "sim.runs_traced", "unit": "runs", "better": "higher",
        "source": "program_span", "layer": "step loop",
        "moves": "atom_steps_per_s", "workloads": ["tiny_lj.fcc6.run20"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "tiny_lj" and got["natoms"] == 4 * 6 ** 3
    assert got["correct"] is True
    assert got["metrics"]["sim.runs_traced"] == 2
    assert got["metrics"]["setup.construct_s"] > 0
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, f"{rel} was edited"
