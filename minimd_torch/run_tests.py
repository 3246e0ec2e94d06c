"""Golden-trace validation sweep: the reference's `run_tests` harness
(ref/run_tests:1-150) on the port.

Sweeps system sizes x force styles (x domain counts via --devices, x the
Newton half-neighbor paths via --half_neigh) against the golden logs in
tests/golden/ with the reference's statistical acceptance criterion. The
counterpart of scripts/run_tests.py, with its scopes, cases, statuses
(PASS / FAIL / SKIP / XFAIL) and exit code; its --tpu is --device here.
The default runs f32 on the card (precision 4, the accelerator's cases);
--device cpu runs f64 on the CPU (precision 8, the CPU's cases).

    python -m minimd_torch.run_tests --scope quick             # card
    python -m minimd_torch.run_tests --scope quick --device cpu
    python -m minimd_torch.run_tests --input lj --size 10 --steps 2000
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
SIZES = {10: "4k", 16: "16k", 20: "32k", 30: "108k", 40: "256k", 60: "864k"}

# Large EAM in single precision cannot meet the acceptance envelope: P's
# pre-ramp tolerance is 0.3 metal units, 1.8e-6 relative at P ~ -1.64e5,
# below what an f32 evaluation holds through the virial's cancellation.
# The reference's own f32 build (PRECISION=1, -s 40 -n 1000) fails its own
# criterion at T 0.27 / E 1.00 / P 1.00, with step-0 U off by 0.8%; the
# reference validates these sizes in f64, as the --device cpu scopes do.
# A case of this set that passes prints PASS.
XFAIL_F32 = {("eam", 40), ("eam", 60)}


def scope_cases(scope: str | None, cuda: bool, input_name=None, size=10,
                steps=500) -> list[tuple[str, int, int]]:
    """(input, size, steps) of a scope: the JAX script's lists, its
    accelerator lists on the card (f32, where the envelope stays at its
    floor until step ~4000, so runs are long enough for post-ramp rows to
    decide) and its CPU lists in f64."""
    if scope == "quick":
        if cuda:
            return [("lj", 10, 10000), ("eam", 10, 10000)]
        return [("lj", 10, 500), ("eam", 10, 500)]
    if scope == "full":
        if cuda:
            return [("lj", 10, 10000), ("lj", 20, 2000), ("eam", 10, 10000)]
        # LJ full trace (10000 steps): a 1000-step slice oversamples the
        # tight deterministic window and fails marginally even in f64
        return [("lj", 10, 10000), ("lj", 16, 500), ("lj", 20, 500),
                ("eam", 10, 500), ("eam", 16, 200),
                ("lj-data", 16, 500), ("eam-data", 16, 200)]
    if scope == "large":
        # the sizes the reference validates beyond the pytest sweep
        # (256k = -s 40, 864k = -s 60); thermo every 100 steps
        if cuda:
            return [("lj", 40, 2000), ("lj", 60, 1000),
                    ("eam", 20, 10000), ("eam", 40, 1000)]
        return [("lj", 40, 200), ("lj", 60, 200),
                ("eam", 40, 200), ("eam", 60, 200)]
    return [(input_name or "lj", size, steps)]


def case_simulation(input_name: str, size: int, dtype, device: str = "cuda",
                    devices: int = 1, half_neigh: bool = False,
                    ghost_newton: bool = True, thermo_nstat: int = 100):
    """The Simulation (or ShardedSimulation, devices > 1, on domains
    placed as the CLI places them: parallel.mesh.mesh_devices) of a case
    at -s size. "lj-data" / "eam-data" write the deck's lattice
    (positions, scaled velocities, mass) with write_lammps_data into a
    temporary directory, removed after set-up, and read it through the
    -f path."""
    from . import create
    from .config import builtin_deck
    from .sim import Simulation

    style, _, via_data = input_name.partition("-")
    inp = builtin_deck(style)
    inp.nx = inp.ny = inp.nz = size
    inp.thermo_nstat = thermo_nstat

    def build():
        if devices > 1:
            from .parallel import ShardedSimulation
            from .parallel.mesh import mesh_devices
            return ShardedSimulation.from_input(
                inp, devices=mesh_devices(devices, device), dtype=dtype,
                half_neigh=half_neigh, ghost_newton=ghost_newton)
        return Simulation.from_input(inp, dtype=dtype, device=device,
                                     half_neigh=half_neigh,
                                     ghost_newton=ghost_newton)

    if not via_data:
        return build()
    from .lammps_data import write_lammps_data
    from .units import thermo_scales

    mass = 1.0
    if style == "eam":
        from .eam_file import default_potential_path, read_funcfl
        mass = read_funcfl(default_potential_path()).mass
    box = create.create_box(size, size, size, inp.rho)
    x, v = create.create_atoms(size, size, size, inp.rho, box)
    sc = thermo_scales(inp.units, len(x), box.volume)
    v = create.create_velocity(v, inp.t_request, len(x), mass, sc.t_scale)
    with tempfile.TemporaryDirectory() as tmp:
        inp.datafile = str(pathlib.Path(tmp) / f"{input_name}.data")
        write_lammps_data(inp.datafile, box, x, v, mass=mass)
        return build()


def run_case(input_name: str, size: int, steps: int, precision: int,
             device: str = "cuda", devices: int = 1,
             half_neigh: bool = False, ghost_newton: bool = True):
    """One case against tests/golden/<size>.<style>: (comparison, rows,
    None), or (None, None, reason) when there is no golden log. The
    data cases' trace must match the deck's golden log."""
    import torch

    from .validate import compare_traces, parse_golden

    style = input_name.partition("-")[0]
    golden_path = GOLDEN / f"{SIZES.get(size, size)}.{style}"
    if not golden_path.exists():
        return None, None, f"no golden log {golden_path.name}"
    golden = parse_golden(golden_path)
    dtype = torch.float64 if precision == 8 else torch.float32
    sim = case_simulation(input_name, size, dtype, device, devices,
                          half_neigh, ghost_newton)
    rows = sim.thermo_trace(sim.run(steps))
    res = compare_traces(rows, golden.rows, natoms=sim.natoms, system=style,
                         precision=precision)
    return res, rows, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scope", choices=["quick", "full", "large"],
                    default=None)
    ap.add_argument("--input",
                    choices=["lj", "eam", "lj-data", "eam-data"], default=None)
    ap.add_argument("--size", type=int, default=10)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: f32 on the card (precision 4); cpu: f64 "
                         "on the CPU (precision 8)")
    ap.add_argument("--devices", type=int, default=1,
                    help="run the sweep on N domains (ShardedSimulation; "
                         "the reference's multi-rank sweep, "
                         "ref/run_tests:62-150)")
    ap.add_argument("--half_neigh", type=int, default=0, choices=[0, 1],
                    help="1 = sweep the Newton half-neighbor force paths")
    ap.add_argument("--ghost_newton", type=int, default=1, choices=[0, 1],
                    help="with --half_neigh 1: 0 sweeps the reference's "
                         "-gn 0 duplicate-boundary-pair variant (LJ; "
                         "force_lj.cpp:239-249) instead of the Newton fold")
    args = ap.parse_args(argv)

    cuda = args.device == "cuda"
    if cuda:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card is visible; pass --device cpu "
                             "for the CPU")
    precision = 4 if cuda else 8
    cases = scope_cases(args.scope, cuda, args.input, args.size, args.steps)

    failed = 0
    for input_name, size, steps in cases:
        res, _, skip = run_case(input_name, size, steps, precision,
                                device=args.device, devices=args.devices,
                                half_neigh=bool(args.half_neigh),
                                ghost_newton=bool(args.ghost_newton))
        tag = (f"{input_name} -s {size} -n {steps} (precision {precision}"
               + (f", devices {args.devices}" if args.devices > 1 else "")
               + (", half_neigh" if args.half_neigh else "")
               + (", gn=0" if args.half_neigh and not args.ghost_newton
                  else "") + ")")
        if skip:
            print(f"SKIP   {tag}: {skip}", flush=True)
            continue
        if (not res.passed and precision == 4
                and (input_name, size) in XFAIL_F32):
            print(f"XFAIL  {tag}: {res} — expected in f32; the reference's "
                  "own f32 build fails this case worse (see XFAIL_F32)",
                  flush=True)
            continue
        print(f"{'PASS' if res.passed else 'FAIL':6} {tag}: {res}",
              flush=True)
        failed += not res.passed
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
