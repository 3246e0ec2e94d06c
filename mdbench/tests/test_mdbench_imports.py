"""What the benchmark's processes load: never jax, jaxlib, flax, the JAX
package (minimd_tpu) or the repository's bench.py, compared by whole
top-level names; and the reference side loads nothing of the program."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

HARNESS = r"""
import json, sys, time
sys.path.insert(0, "mdbench/tests")
from conftest import small_cell
from mdbench import run
res = run.run_cell(small_cell("lj_fcc.131k", (6, 6, 6), 20), 5, 0, False,
                   ["cpu"], time.perf_counter(), calls=2)
print(json.dumps({"correct": res["correct"],
                  "forbidden": run.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE = r"""
import json, sys
import numpy as np, torch
from mdbench import checks, lattice, reference, roofline, spec, trace
cfg = json.load(open("mdbench/configs/eam_cu.json"))
x, box = lattice.fcc(8, 8, 8, cfg["density"])
m = reference.Model(cfg, box, len(x), "mdbench/configs")
m.forces(torch.tensor(x))
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    got = _run(HARNESS)
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert "minimd_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "minimd_tpu", "bench"} \
        & set(got["top"])


def test_the_reference_loads_nothing_of_the_program():
    top = set(_run(REFERENCE))
    assert "minimd_torch" not in top
    assert not {"jax", "jaxlib", "flax", "minimd_tpu", "bench"} & top


def test_names_are_compared_whole(monkeypatch):
    from mdbench import run
    for name in ("minimd_tpu_x", "jaxlike", "benchmarks"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    assert "minimd_tpu" not in found and "bench" not in found
    monkeypatch.setitem(sys.modules, "minimd_tpu.ops", object())
    assert "minimd_tpu" in run.forbidden_modules()
