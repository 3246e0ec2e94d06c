"""Command-line entry point of the PyTorch/CUDA port (minimd_tpu.cli,
ref/ljs.cpp:61-504).

    python -m minimd_torch -i inputs/in.lj.miniMD [-s N] [-n steps]
        [-p lj|eam] [--precision 1|2] [--device cuda|cpu] [--devices N]
        [--half_neigh 0|1] [-gn 0|1] [--timed] [--check_exchange]
        [--safe_exchange] [-o 1] [--yaml_screen] [--profile DIR]

Deck and override precedence are minimd_tpu.cli.load_input's (copied
here). The port's `--device cuda|cpu` takes the place of the reference's
`-d N` (a GPU id). `--devices N` (N > 1) runs the decomposed run
(minimd_torch/parallel, main_sharded) on N domains: with `--device cuda`
on the visible cards in turn (cuda:i % count, so one card may hold all
N), with `--device cpu` all on the CPU; this takes the place of the JAX
CLI's "requested N devices, have M" error. `--backend` is refused, as the
port has no backend switch (the tensors' device decides). The
reference's CPU execution knobs are accepted and do nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from .config import (FORCE_EAM, FORCE_LJ, UNITS_LJ, UNITS_METAL, In,
                     builtin_deck, parse_deck)
from .timer import TIME_COMM, TIME_FORCE, TIME_NEIGH, TIME_TOTAL, Timer

VARIANT_STRING = "miniMD-torch 0.1 (PyTorch/CUDA)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minimd-torch",
        description=f"{VARIANT_STRING}: the PyTorch/CUDA port of miniMD-TPU "
                    "(LJ and EAM, one device or a decomposed run)")
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
    p.add_argument("-o", "--yaml_output", type=int, default=0,
                   help="1 = write the YAML report miniMD-<date>.yaml")
    p.add_argument("--yaml_screen", action="store_true",
                   help="also print the YAML report")
    p.add_argument("--precision", type=int, default=1, choices=[1, 2],
                   help="1=float32, 2=float64 (the card's kernels are "
                        "float32)")
    p.add_argument("--capacity", type=int, default=None,
                   help="cell capacity override (default: data-driven)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes (the reference's -d N GPU id "
                        "has no counterpart)")
    p.add_argument("--devices", type=int, default=1,
                   help="spatial decomposition over N domains (mesh by "
                        "min-surface factorization): with --device cuda on "
                        "the visible cards in turn (cuda:i %% count, so one "
                        "card may hold all N), with --device cpu on the CPU")
    p.add_argument("--safe_exchange", action="store_true",
                   help="with --devices N: multi-hop atom migration (place "
                        "atoms arriving from any domain, ref "
                        "comm.cpp:599-689); migration is capacity-checked "
                        "either way")
    p.add_argument("--backend", default=None,
                   help="refused: the port has no backend switch")
    p.add_argument("--timed", action="store_true",
                   help="run with phase timers (force, neigh, and comm with "
                        "--devices N) and a card sync at every stamp; the "
                        "same trajectory")
    p.add_argument("--check_exchange", action="store_true",
                   help="timed run that audits each interval's largest "
                        "displacement against skin/2")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the run (CUDA "
                        "activity on the card) into DIR as Chrome JSON")
    p.add_argument("--half_neigh", type=int, default=0,
                   help="1 = Newton half-neighbor path, LJ + EAM, also "
                        "with --devices (each pair evaluated once, j-side "
                        "accumulation folded back; plain torch, a parity "
                        "option); 0 = full stencils")
    p.add_argument("-gn", "--ghost_newton", type=int, default=1,
                   help="with --half_neigh 1 (ljs.cpp:205-206): 1 = Newton's "
                        "3rd law across the periodic boundary, ghost forces "
                        "folded back (comm.cpp:320-361); 0 = boundary pairs "
                        "duplicated on both owners at half eng/vir weight, "
                        "no fold (force_lj.cpp:239-249). LJ implements both; "
                        "with full stencils it has no effect")
    # the reference's CPU execution knobs: accepted, no effect
    p.add_argument("--sort", type=int, default=-1, help="[no-op]")
    p.add_argument("-t", "--num_threads", type=int, default=1,
                   help="[no-op] reference OpenMP thread count")
    p.add_argument("--teams", type=int, default=1, help="[no-op]")
    p.add_argument("-sse", type=int, default=0,
                   help="miniMD-SSE only: exits")
    p.add_argument("-dm", "--device_map", action="store_true",
                   help="[no-op] reference GPU/rank mapping")
    p.add_argument("-ng", "--num_gpus", type=int, default=2, help="[no-op]")
    p.add_argument("--skip_gpu", type=int, default=-1, help="[no-op]")
    return p


def _unported(args) -> str | None:
    if args.backend is not None:
        return ("--backend (ROADMAP queue 1 item 11: the port has no "
                "backend switch; the tensors' device decides)")
    return None


def load_input(args) -> In:
    """Deck, then the command line's overrides (ljs.cpp:330-379)."""
    if args.input_file:
        inp = parse_deck(args.input_file)
        inp.source = args.input_file
    else:
        inp = builtin_deck("lj")
        inp.source = "in.lj.miniMD"
    if args.nsteps > 0:
        inp.ntimes = args.nsteps
    if args.size > 0:
        inp.nx = inp.ny = inp.nz = args.size
    if args.nx > 0:
        inp.nx = args.nx
        inp.ny = args.ny if args.ny > 0 else (args.nx if args.size < 0 else inp.ny)
        inp.nz = args.nz if args.nz > 0 else (args.nx if args.size < 0 else inp.nz)
    if args.units:
        inp.units = UNITS_LJ if args.units == "lj" else UNITS_METAL
    if args.forcestyle:
        inp.forcetype = FORCE_EAM if args.forcestyle == "eam" else FORCE_LJ
    if args.data_file:
        inp.datafile = args.data_file
    return inp


def banner(inp, sim, args, device=None):
    print(f"# {VARIANT_STRING} output ...")
    print("# Run Settings: ")
    print(f"\t# Device: {sim.device if device is None else device}")
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
    print(f"\t# Half neighborlists: {int(sim.half_neigh)}")
    print(f"\t# Cell grid: {sim.geom.nb[0]} {sim.geom.nb[1]} {sim.geom.nb[2]} "
          f"(capacity {sim.geom.capacity})")
    print(f"\t# Neighbor frequency: {inp.neigh_every}")
    print(f"\t# Thermo frequency: {inp.thermo_nstat}")
    print(f"\t# Ghost Newton: {args.ghost_newton}")
    print(f"\t# Size of float: {4 if args.precision == 1 else 8}")
    print()


def _notes(args, inp):
    """The JAX CLI's notes on the half-neighbor options
    (minimd_tpu/cli.py:156-196)."""
    if args.half_neigh not in (0, 1):
        print("# Warning: --half_neigh -1 (the reference's unsafe-threaded "
              "mode) has no analog here; using full stencils. Supported: "
              "0 (full, default) and 1 (Newton half-neighbor).")
    if args.half_neigh != 1:
        return
    if inp.forcetype == FORCE_EAM and args.ghost_newton == 0:
        # the reference forces gn=0 for EAM (ljs.cpp:277-281); this
        # build's EAM half path folds instead (ops/eam_half.py)
        print("# Note: the EAM half-neighbor path uses the ghost-Newton "
              "fold regardless of -gn (identical physics; the reference "
              "forces gn=0 for EAM, ljs.cpp:277-281).")
    elif args.ghost_newton == 0:
        print("# Note: -gn 0 duplicates boundary pairs on both owners at "
              "half eng/vir weight and skips the reverse force "
              "communication (ref force_lj.cpp:239-249); identical "
              "physics to the gn=1 fold, decomposed differently. On one "
              "card the fold is a few slab adds, so gn=1 is the default.")


def _profiler(args, cuda: bool):
    """A torch.profiler context for --profile DIR (CUDA activity when the
    run uses a card), else a null context. It covers set-up and the run,
    so the trace holds the program's minimd.setup.* spans too."""
    if not args.profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _setup_line(record: dict) -> str:
    """Set-up's parts (the simulation's setup_record) as one # line."""
    return "# Set-up: " + ", ".join(
        f"{k} {v}" if isinstance(v, bool) else f"{k} {v:.3f} s"
        for k, v in record.items())


def _save_profile(args, prof):
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "minimd_torch_trace.json")
        prof.export_chrome_trace(path)
        print(f"# profiler trace: {path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = _unported(args)
    if missing:
        sys.exit(f"ERROR: {missing} is not ported to minimd_torch.")
    if args.sse:
        print("ERROR: -sse applies to the miniMD-SSE CPU variant only. Exiting.")
        sys.exit(0)
    inp = load_input(args)
    _notes(args, inp)

    import torch

    from .output import lost_atom_check, yaml_report
    from .sim import Simulation

    dtype = torch.float32 if args.precision == 1 else torch.float64
    if args.devices > 1:
        return main_sharded(args, inp, dtype)
    nbins = (args.neigh_bins,) * 3 if args.neigh_bins > 0 else None
    print("# Create System:")
    prof = _profiler(args, args.device == "cuda")
    with prof:
        sim = Simulation.from_input(inp, ntypes=args.ntypes, dtype=dtype,
                                    device=args.device, nbins=nbins,
                                    capacity=args.capacity,
                                    half_neigh=args.half_neigh == 1,
                                    ghost_newton=args.ghost_newton != 0)
        print("# Done .... ")
        print(_setup_line(sim.setup_record))
        banner(inp, sim, args)

        print("# Starting dynamics ...")
        print("# Timestep T U P Time")
        r0 = sim._row0
        print(f"{r0[0]} {r0[1]:e} {r0[2]:e} {r0[3]:e}  0.000")
        timer = Timer()
        timer.barrier_start(TIME_TOTAL)
        if args.timed or args.check_exchange:
            trace = sim.run_timed(timer, check_exchange=args.check_exchange)
        else:
            trace = sim.run()    # ends in a host sync: the time is complete
        timer.barrier_stop(TIME_TOTAL)
    _save_profile(args, prof)

    t = timer.array
    t_total = t[TIME_TOTAL]
    rows = sim.thermo_trace(trace)
    for r in rows[1:]:
        print(f"{r[0]} {r[1]:e} {r[2]:e} {r[3]:e} {t_total:6.3f}")
    lost = lost_atom_check(sim)
    if lost:
        print(f"# WARNING: {lost} atoms lost")

    t_force, t_neigh, t_comm = t[TIME_FORCE], t[TIME_NEIGH], t[TIME_COMM]
    t_other = max(t_total - t_force - t_neigh - t_comm, 0.0)
    perf = sim.natoms * inp.ntimes / t_total if t_total else 0.0
    print("\n\n# Performance Summary:")
    print("# MPI_proc OMP_threads nsteps natoms t_total t_force t_neigh "
          "t_comm t_other performance perf/thread grep_string t_extra")
    print(f"1 1 {inp.ntimes} {sim.natoms} {t_total:f} {t_force:f} "
          f"{t_neigh:f} {t_comm:f} {t_other:f} {perf:f} {perf:f} "
          f"PERF_SUMMARY 0.000000\n\n")

    if args.yaml_output:
        path = yaml_report(sim, rows, timer, screen=args.yaml_screen)
        print(f"# YAML report: {path}")
    return sim, rows


def main_sharded(args, inp, dtype):
    """The decomposed run (minimd_torch/parallel; minimd_tpu/cli.py
    main_sharded): the banner, the mesh and the domains' devices, the
    step-0 row, --timed / --check_exchange through run_timed (COMM the
    halo, NEIGH the migration), --profile, the lost-atom audit,
    PERF_SUMMARY with the devices column and perf/device, and the YAML
    report with the per-device statistics. Returns (ssim, rows)."""
    from .output import lost_atom_check, per_device_statistics, yaml_report
    from .parallel import ShardedSimulation, mesh_devices

    try:
        devices = mesh_devices(args.devices, args.device)
    except RuntimeError as e:
        sys.exit(f"ERROR: --device {args.device}: {e}")
    print("# Create System (decomposed):")
    nbins = (args.neigh_bins,) * 3 if args.neigh_bins > 0 else None
    prof = _profiler(args, args.device == "cuda")
    with prof:
        ssim = ShardedSimulation.from_input(
            inp, devices=devices, dtype=dtype, nbins=nbins,
            ntypes=args.ntypes, safe_exchange=args.safe_exchange,
            capacity=args.capacity, half_neigh=args.half_neigh == 1,
            ghost_newton=args.ghost_newton != 0)
        print("# Done .... ")
        print(_setup_line(ssim.setup_record))
        groups = ", ".join(f"{dev} x{len(ks)}"
                           for dev, ks in ssim.router.groups)
        banner(inp, ssim, args, device=f"{args.devices} domains ({groups})")
        print(f"# Mesh: {dict(ssim.mesh.shape)}")
        print(f"# Domains' devices: {ssim.devices}")

        print("# Starting dynamics ...")
        print("# Timestep T U P Time")
        r0 = ssim.row0
        print(f"{r0[0]} {r0[1]:e} {r0[2]:e} {r0[3]:e}  0.000")
        timer = Timer()
        timer.barrier_start(TIME_TOTAL)
        if args.timed or args.check_exchange:
            trace = ssim.run_timed(timer, inp.ntimes,
                                   check_exchange=args.check_exchange)
        else:
            trace = ssim.run(inp.ntimes)   # ends in a host sync
        timer.barrier_stop(TIME_TOTAL)
    _save_profile(args, prof)

    t = timer.array
    t_total = t[TIME_TOTAL]
    rows = ssim.thermo_trace(trace)
    for r in rows[1:]:
        print(f"{r[0]} {r[1]:e} {r[2]:e} {r[3]:e} {t_total:6.3f}")
    lost = lost_atom_check(ssim)
    if lost:
        print(f"# WARNING: {lost} atoms lost")

    t_force, t_neigh, t_comm = t[TIME_FORCE], t[TIME_NEIGH], t[TIME_COMM]
    t_other = max(t_total - t_force - t_neigh - t_comm, 0.0)
    perf = ssim.natoms * inp.ntimes / t_total if t_total else 0.0
    print("\n\n# Performance Summary:")
    print("# devices OMP_threads nsteps natoms t_total t_force t_neigh "
          "t_comm t_other performance perf/device grep_string t_extra")
    print(f"{args.devices} 1 {inp.ntimes} {ssim.natoms} {t_total:f} "
          f"{t_force:f} {t_neigh:f} {t_comm:f} {t_other:f} {perf:f} "
          f"{perf / args.devices:f} PERF_SUMMARY 0.000000\n\n")

    if args.yaml_output:
        path = yaml_report(ssim, rows, timer, nprocs=args.devices,
                           screen=args.yaml_screen,
                           extra_stats=per_device_statistics(ssim))
        print(f"# YAML report: {path}")
    return ssim, rows


if __name__ == "__main__":
    main()
