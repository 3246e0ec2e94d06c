"""The port's headline benchmark on one CUDA card: bench.py's cells, run
lengths and slope timing, through minimd_torch.

    python -m minimd_torch.bench [--devices N]

The counterpart of the repository's bench.py, which runs the JAX package.
It prints one JSON line last, with bench.py's keys and rounding:

  {"metric": "lj_131k_throughput", "value": N,
   "unit": "Matom_steps_per_sec", "vs_baseline": N, "companions": {...}}

`companions` also carries `device`: the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them, since every number here is that card's.

Cells (bench.py:112-118), f32, full neighbors, each the best of 3 slopes:
LJ 131,072 atoms (inputs/in.lj.miniMD, -s 32) run(100) against run(300);
LJ 864,000 (-s 60) 60 against 180; EAM 131,072 (inputs/in.eam.miniMD)
100 against 300; EAM 864,000 40 against 120; then the LJ 131k deck on a
1-domain ShardedSimulation, 60 against 240, beside the Simulation's rate
(`sharded_1chip_ratio`). With --devices N, only the LJ 131k deck on a
ShardedSimulation of N domains, placed on the visible cards in turn (one
card may hold them all), 60 against 300 (bench.py:98-108).

Timing (bench.py:43-56): both run lengths once to warm, then, per repeat,
run(a) and run(b) each between two CUDA events (run() ends in a host
sync). The slope (tb - ta) / (b - a) cancels each run's start and end; the
best slope is kept. Every slope is printed on a `[slope]` line of its own
(both lengths' ms, ms a step, the rate) before the JSON line. After the
timed runs every atom must be kept (rebin overflow 0, the cell layout not
regrown, valid.sum() == natoms), else the bench raises.

The cells run the path that Simulation picks for them, the port's
defaults: lj_force and the rebin kernels (rebin_bin + rebin_gather) for
LJ, eam_rho and eam_force for EAM, and the decomposed run's sharded
lj_force and rebin. main() has no CPU mode: without a card it exits
non-zero before any set-up. throughput() and throughput_sharded() take
device="cpu" for the tests; the host clock then times the plain versions,
which gives no device metric.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .config import builtin_deck
from .sim import Simulation

# The C++ reference's CPU numbers (neither this card's nor the JAX
# package's): its README.md:286-288, 864k atoms on 2 MPI x 16 OpenMP
# threads (BASELINE.md:12), and its 16-rank CPU EAM figure (bench.py:33).
BASELINE_MATOM_STEPS = 23.67
BASELINE_EAM = 9.2


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def run_ms(sim, steps: int, device) -> float:
    """Milliseconds of sim.run(steps): between two CUDA events on the
    card, on the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim.run(steps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    sim.run(steps)
    return (time.perf_counter() - t0) * 1e3


def slope(sim, a: int, b: int, device) -> tuple[float, float, float]:
    """(ms of run(a), ms of run(b), ms a step between them)."""
    ta = run_ms(sim, a, device)
    tb = run_ms(sim, b, device)
    step_ms = (tb - ta) / (b - a)
    if not step_ms > 0:
        raise RuntimeError(f"run({b}) took {tb:.3f} ms, run({a}) {ta:.3f} "
                           "ms: no positive slope to time")
    return ta, tb, step_ms


def check_kept(sim, layout, label: str):
    """Raise unless every atom is kept: no rebin overflow, the cell layout
    (grid, capacity) not regrown since `layout`, valid.sum() == natoms."""
    st = sim.state
    kept = int(st.valid.sum())
    now = (sim.geom.nb, sim.geom.capacity)
    if int(st.overflow) != 0 or now != layout or kept != sim.natoms:
        raise RuntimeError(
            f"{label}: overflow={int(st.overflow)}, layout {layout} -> "
            f"{now}, {kept} of {sim.natoms} atoms kept")


def best_rate(label: str, sim, a: int, b: int, reps: int, device) -> float:
    """bench.py's timing: warm run(a) and run(b), then reps slopes, each
    printed; the best slope's Matom-steps/s, after check_kept."""
    layout = (sim.geom.nb, sim.geom.capacity)
    sim.run(a)
    sim.run(b)
    best = float("inf")
    for k in range(reps):
        ta, tb, step_ms = slope(sim, a, b, device)
        print(f"[slope] {label} ({sim.natoms} atoms) {k + 1}/{reps}: "
              f"run({a}) {ta:.3f} ms, run({b}) {tb:.3f} ms, "
              f"{step_ms:.5f} ms/step = {sim.natoms / step_ms / 1e3:.2f} "
              "Matom-steps/s", flush=True)
        best = min(best, step_ms)
    check_kept(sim, layout, label)
    return sim.natoms / best / 1e3


def sized_deck(style: str, n: int):
    """The shipped `style` deck at n^3 FCC cells."""
    inp = builtin_deck(style)
    inp.nx = inp.ny = inp.nz = n
    return inp


def throughput(style: str, n: int, steps_a: int, steps_b: int, reps: int,
               *, device="cuda", dtype=torch.float32) -> float:
    """Matom-steps/s of the `style` deck at n^3 FCC cells on a Simulation:
    the best of reps slopes between run(steps_a) and run(steps_b)."""
    sim = Simulation.from_input(sized_deck(style, n), dtype=dtype,
                                device=device)
    return best_rate(f"{style} -s {n}", sim, steps_a, steps_b, reps, device)


def throughput_sharded(style: str, n: int, a: int, b: int, ndev: int,
                       reps: int = 3, *, device="cuda") -> float:
    """As throughput(), f32, on a ShardedSimulation of ndev domains
    (parallel.mesh.mesh_devices(ndev, device))."""
    from .parallel import ShardedSimulation
    from .parallel.mesh import mesh_devices

    sim = ShardedSimulation.from_input(
        sized_deck(style, n), devices=mesh_devices(ndev, device))
    return best_rate(f"{style} -s {n} sharded {ndev} domain(s) mesh "
                     f"{sim.mesh.shape}", sim, a, b, reps, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m minimd_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="run only the LJ 131k deck on a ShardedSimulation "
                         "of N domains (on the visible cards in turn)")
    args = ap.parse_args(argv)
    if args.devices < 0:
        ap.error("--devices takes N >= 1")
    if not torch.cuda.is_available():
        raise SystemExit("python -m minimd_torch.bench needs a CUDA card; "
                         "none is visible")
    card = card_line()
    print(f"# {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    if args.devices:
        lj = throughput_sharded("lj", 32, 60, 300, args.devices)
        line = {
            "metric": "lj_131k_sharded_throughput",
            "value": round(lj, 2),
            "unit": "Matom_steps_per_sec",
            "vs_baseline": round(lj / BASELINE_MATOM_STEPS, 3),
            "companions": {"devices": args.devices, "device": card},
        }
    else:
        lj131 = throughput("lj", 32, 100, 300, reps=3)
        lj864 = throughput("lj", 60, 60, 180, reps=3)
        eam131 = throughput("eam", 32, 100, 300, reps=3)
        eam864 = throughput("eam", 60, 40, 120, reps=3)
        shard131 = throughput_sharded("lj", 32, 60, 240, ndev=1)
        line = {
            "metric": "lj_131k_throughput",
            "value": round(lj131, 2),
            "unit": "Matom_steps_per_sec",
            "vs_baseline": round(lj131 / BASELINE_MATOM_STEPS, 3),
            "companions": {
                "lj_864k": round(lj864, 2),
                "lj_864k_vs_baseline": round(lj864 / BASELINE_MATOM_STEPS,
                                             3),
                "eam_131k": round(eam131, 2),
                "eam_131k_vs_ref_cpu": round(eam131 / BASELINE_EAM, 3),
                "eam_864k": round(eam864, 2),
                "eam_864k_vs_ref_cpu": round(eam864 / BASELINE_EAM, 3),
                "lj_131k_sharded_1chip": round(shard131, 2),
                "sharded_1chip_ratio": round(shard131 / lj131, 3),
                "device": card,
            },
        }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
