"""Command-line entry point of the PyTorch/CUDA port (the single-device LJ
subset of minimd_tpu.cli, ref/ljs.cpp:61-504).

    python -m minimd_torch -i inputs/in.lj.miniMD [-s N] [-n steps]
        [--precision 1|2] [--device cuda|cpu]

Deck and override precedence are minimd_tpu.cli.load_input's. Flags of the
JAX CLI that the port does not have yet exit with an error naming the
ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys

from minimd_tpu.cli import load_input
from minimd_tpu.config import FORCE_EAM, FORCE_LJ, UNITS_LJ
from minimd_tpu.timer import TIME_TOTAL, Timer

VARIANT_STRING = "miniMD-torch 0.1 (PyTorch/CUDA)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minimd-torch",
        description=f"{VARIANT_STRING}: the PyTorch/CUDA port of miniMD-TPU "
                    "(single device, LJ)")
    p.add_argument("-i", "--input_file", default=None,
                   help="input deck (default: in.lj.miniMD)")
    p.add_argument("-n", "--nsteps", type=int, default=-1)
    p.add_argument("-s", "--size", type=int, default=-1,
                   help="linear dimension of system box (unit cells)")
    p.add_argument("-nx", type=int, default=-1)
    p.add_argument("-ny", type=int, default=-1)
    p.add_argument("-nz", type=int, default=-1)
    p.add_argument("--ntypes", type=int, default=4)
    p.add_argument("-b", "--neigh_bins", type=int, default=-1,
                   help="linear dimension of the cell grid (default: autotuned)")
    p.add_argument("-u", "--units", default=None, choices=["lj", "metal"])
    p.add_argument("-p", "--force", dest="forcestyle", default=None,
                   choices=["lj", "eam"])
    p.add_argument("-f", "--data_file", default=None)
    p.add_argument("--precision", type=int, default=1, choices=[1, 2],
                   help="1=float32, 2=float64 (float64 runs on the CPU only)")
    p.add_argument("--capacity", type=int, default=None,
                   help="cell capacity override (default: data-driven)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # flags of minimd_tpu's CLI that the port does not have yet
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--half_neigh", type=int, default=0)
    p.add_argument("--timed", action="store_true")
    p.add_argument("-o", "--yaml_output", type=int, default=0)
    p.add_argument("--profile", default=None)
    return p


def _unported(args, inp) -> str | None:
    if args.devices > 1:
        return "--devices > 1 (ROADMAP queue 1 item 9)"
    if args.half_neigh == 1:
        return "--half_neigh 1 (ROADMAP queue 1 item 8)"
    if args.timed:
        return "--timed (ROADMAP queue 1 item 7)"
    if args.yaml_output:
        return "-o 1 (ROADMAP queue 1 item 7)"
    if args.profile:
        return "--profile (ROADMAP queue 1 item 7)"
    if inp.forcetype == FORCE_EAM:
        return "EAM (ROADMAP queue 1 item 6)"
    return None


def banner(inp, sim, args):
    print(f"# {VARIANT_STRING} output ...")
    print("# Run Settings: ")
    print(f"\t# Device: {sim.device}")
    print(f"\t# Inputfile: {args.input_file or 'in.lj.miniMD'}")
    print(f"\t# Datafile: {inp.datafile or 'None'}")
    print("# Physics Settings: ")
    print(f"\t# ForceStyle: {'LJ' if inp.forcetype == FORCE_LJ else 'EAM'}")
    print(f"\t# Force Parameters: {inp.epsilon:2.2f} {inp.sigma:2.2f}")
    print(f"\t# Units: {'LJ' if inp.units == UNITS_LJ else 'METAL'}")
    print(f"\t# Atoms: {sim.natoms}")
    print(f"\t# Atom types: {args.ntypes}")
    print(f"\t# System size: {sim.geom.prd[0]:2.2f} {sim.geom.prd[1]:2.2f} "
          f"{sim.geom.prd[2]:2.2f} (unit cells: {inp.nx} {inp.ny} {inp.nz})")
    print(f"\t# Density: {inp.rho:f}")
    print(f"\t# Force cutoff: {inp.force_cut:f}")
    print(f"\t# Timestep size: {inp.dt:f}")
    print("# Technical Settings: ")
    print(f"\t# Neigh cutoff: {inp.neigh_cut:f}")
    print("\t# Half neighborlists: 0")
    print(f"\t# Cell grid: {sim.geom.nb[0]} {sim.geom.nb[1]} {sim.geom.nb[2]} "
          f"(capacity {sim.geom.capacity})")
    print(f"\t# Neighbor frequency: {inp.neigh_every}")
    print(f"\t# Thermo frequency: {inp.thermo_nstat}")
    print(f"\t# Size of float: {4 if args.precision == 1 else 8}")
    print()


def main(argv=None):
    args = build_parser().parse_args(argv)
    inp = load_input(args)
    missing = _unported(args, inp)
    if missing:
        sys.exit(f"ERROR: {missing} is not ported to minimd_torch yet.")

    import torch

    from .sim import Simulation

    dtype = torch.float32 if args.precision == 1 else torch.float64
    nbins = (args.neigh_bins,) * 3 if args.neigh_bins > 0 else None
    print("# Create System:")
    sim = Simulation.from_input(inp, ntypes=args.ntypes, dtype=dtype,
                                device=args.device, nbins=nbins,
                                capacity=args.capacity)
    print("# Done .... ")
    banner(inp, sim, args)

    print("# Starting dynamics ...")
    print("# Timestep T U P Time")
    r0 = sim._row0
    print(f"{r0[0]} {r0[1]:e} {r0[2]:e} {r0[3]:e}  0.000")
    timer = Timer()
    timer.barrier_start(TIME_TOTAL)
    trace = sim.run()        # ends in a host sync: the time is complete
    timer.barrier_stop(TIME_TOTAL)
    t_total = timer.array[TIME_TOTAL]

    for r in sim.thermo_trace(trace)[1:]:
        print(f"{r[0]} {r[1]:e} {r[2]:e} {r[3]:e} {t_total:6.3f}")
    lost = sim.natoms - int(sim.state.valid.sum())
    if lost:
        print(f"# WARNING: {lost} atoms lost")

    perf = sim.natoms * inp.ntimes / t_total if t_total else 0.0
    print("\n\n# Performance Summary:")
    print("# MPI_proc OMP_threads nsteps natoms t_total t_force t_neigh "
          "t_comm t_other performance perf/thread grep_string t_extra")
    print(f"1 1 {inp.ntimes} {sim.natoms} {t_total:f} 0.000000 0.000000 "
          f"0.000000 {t_total:f} {perf:f} {perf:f} PERF_SUMMARY 0.000000\n\n")


if __name__ == "__main__":
    main()
