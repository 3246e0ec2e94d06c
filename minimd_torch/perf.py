"""Throughput of one shipped deck at one size on one CUDA card:
scripts/perf.py on the port.

    python -m minimd_torch.perf [--style lj|eam] [--n N] [--steps A B]

Builds the deck at N^3 FCC cells (f32, the path Simulation picks), prints
`natoms=... grid=... C=... device=...` (the card's name and power limit
as nvidia-smi gives them), warms run(A) and run(B), times each once
between CUDA events and prints the slope: `per_step=... ms
throughput=... Matom_steps/s overflow=...` (scripts/perf.py:33-53). Every
atom must be kept (minimd_torch.bench.check_kept). There is no CPU mode:
without a card main() exits non-zero before any set-up; measure() takes
device="cpu" for the tests, timed on the host clock, no device metric.
"""

from __future__ import annotations

import argparse

import torch

from . import bench
from .sim import Simulation


def measure(style: str, n: int, steps, *, device="cuda") -> dict:
    """Print perf's two lines; returns natoms, ms a step and the rate."""
    sim = Simulation.from_input(bench.sized_deck(style, n),
                                dtype=torch.float32, device=device)
    layout = (sim.geom.nb, sim.geom.capacity)
    where = (bench.card_line() if torch.device(device).type == "cuda"
             else str(device))
    print(f"natoms={sim.natoms} grid={sim.geom.nb} C={sim.geom.capacity} "
          f"device={where}", flush=True)
    a, b = steps
    sim.run(a)
    sim.run(b)
    _, _, step_ms = bench.slope(sim, a, b, device)
    rate = sim.natoms / step_ms / 1e3
    print(f"per_step={step_ms:.3f} ms  throughput={rate:.2f} Matom_steps/s"
          f"  overflow={int(sim.state.overflow)}", flush=True)
    bench.check_kept(sim, layout, f"{style} -s {n}")
    return {"natoms": sim.natoms, "ms_per_step": step_ms, "rate": rate}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m minimd_torch.perf",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--style", choices=["lj", "eam"], default="eam")
    ap.add_argument("--n", type=int, default=32, help="FCC cells per side")
    ap.add_argument("--steps", type=int, nargs=2, default=(100, 300))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("python -m minimd_torch.perf needs a CUDA card; "
                         "none is visible")
    return measure(args.style, args.n, tuple(args.steps))


if __name__ == "__main__":
    main()
