#!/usr/bin/env python3
"""Card-side checks of minimd_torch beyond chip_smoke.py, one per command
(each needs one CUDA card; run from the root of a checkout):

    python scripts/torch_checks.py gates-f64
        the three half-neighbor paths (LJ -gn 1, LJ -gn 0, EAM) in float64
        on the 4k decks for 10,000 steps against tests/golden/4k.{lj,eam}
        through validate.compare_traces at precision 8, with the same
        criterion read over the first 2,000 steps (rows 0-2000) of the
        same run: does a short gate fail for a reason that f64 removes?

    python scripts/torch_checks.py half-memory [--s 32 60]
        the three half paths at full width (-s 32: 131,072 atoms; -s 60:
        864,000): peak device memory over construction and run(20), the
        time of one force call (noev and ev) and the rows.

    python scripts/torch_checks.py eam-rate [--repo DIR] [--runs 10]
        the EAM deck (131,072 Cu atoms, f32) through the polynomial and the
        gather-table kernels: `runs` timed run(100)s of each (CUDA events,
        after a warm run), then a torch.profiler pass of each (wall, device
        busy time and the host time per step that the device waits on).
        --repo imports minimd_torch from another checkout (a parent
        commit unpacked with git archive), so that one call can run parent
        and change in alternating processes.

Every line is printed as "[name] ..." and the last line is a JSON object
of the numbers.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent


def _sim(deck, s, **kw):
    from minimd_torch.config import parse_deck
    from minimd_torch.sim import Simulation

    inp = parse_deck(HERE / f"inputs/in.{deck}.miniMD")
    inp.nx = inp.ny = inp.nz = s
    return Simulation.from_input(inp, device="cuda", **kw)


def gates_f64(steps=10000, prefix=2000):
    import torch

    from minimd_torch.validate import compare_traces, parse_golden

    out = {}
    for deck, label, gn in (("lj", "lj-half", True),
                            ("lj", "lj-half-gn0", False),
                            ("eam", "eam-half", True)):
        golden = parse_golden(HERE / f"tests/golden/4k.{deck}").rows
        t0 = time.time()
        sim = _sim(deck, 10, dtype=torch.float64, half_neigh=True,
                   ghost_newton=gn)
        rows = sim.thermo_trace(sim.run(steps))
        full = compare_traces(rows, golden, natoms=4000, system=deck,
                              precision=8)
        short = compare_traces([r for r in rows if r[0] <= prefix], golden,
                               natoms=4000, system=deck, precision=8)
        print(f"[gate-4k-{label}-f64] {steps} steps in {time.time() - t0:.1f}"
              f"s: {full}; first {prefix} steps: {short}; overflow="
              f"{sim.state.overflow} regrows={sim._regrows}", flush=True)
        out[label] = {
            "steps": steps, "passed": full.passed,
            "frac": [full.frac_t, full.frac_e, full.frac_p],
            f"passed_{prefix}": short.passed,
            f"frac_{prefix}": [short.frac_t, short.frac_e, short.frac_p]}
    return out


def half_memory(sizes=(32, 60), steps=20):
    import torch

    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms

    out = {}
    for s in sizes:
        for deck, label, gn in (("lj", "lj", True), ("lj", "lj-gn0", False),
                                ("eam", "eam", True)):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sim = _sim(deck, s, half_neigh=True, ghost_newton=gn)
            rows = sim.thermo_trace(sim.run(steps))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            x, typ = sim.state.x, sim.state.typ
            f_ms = cuda_ms(lambda: sim.force_fn_noev(x, typ), 3)
            f_ev_ms = cuda_ms(lambda: sim.force_fn(x, typ), 3)
            name = f"half-{label}-{sim.natoms}"
            print(f"[{name}] nb={sim.geom.nb} C={sim.geom.capacity} peak "
                  f"{peak:.3f}GiB (construction and run({steps})); force "
                  f"{f_ms:.3f}ms (ev {f_ev_ms:.3f}ms); overflow="
                  f"{sim.state.overflow} rows={rows}", flush=True)
            out[name] = {"peak_gib": peak, "force_ms": f_ms,
                         "force_ev_ms": f_ev_ms}
            del sim, x, typ
    return out


def eam_rate(runs=10, steps=100):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    from chip_smoke import through_rows

    out = {}
    for kind in ("poly", "rows"):
        sim = _sim("eam", 32)
        if kind == "rows":
            through_rows(sim)
        sim.run(steps)
        rates = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sim.run(steps)
            end.record()
            end.synchronize()
            rates.append(sim.natoms * steps / (start.elapsed_time(end) * 1e-3)
                         / 1e6)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()) / 1e3
        med = statistics.median(rates)
        print(f"[eam-rate-131k-{kind}] {runs} x run({steps}): median "
              f"{med:.3f} Matom-steps/s, min {min(rates):.3f}, max "
              f"{max(rates):.3f}; profiled wall {wall:.2f}ms device "
              f"{busy:.2f}ms, device idle {(wall - busy) / steps * 1e3:.1f}"
              f"us/step; regrows={sim._regrows}", flush=True)
        out[kind] = {"rates": rates, "median": med, "wall_ms": wall,
                     "device_ms": busy,
                     "idle_us_per_step": (wall - busy) / steps * 1e3}
        del sim
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["gates-f64", "half-memory", "eam-rate"])
    p.add_argument("--repo", default=None,
                   help="eam-rate: import minimd_torch from this checkout")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--s", type=int, nargs="+", default=[32, 60])
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scripts/torch_checks.py needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.repo or HERE).resolve()))
    import minimd_torch

    print(f"[setup] minimd_torch from {pathlib.Path(minimd_torch.__file__).parent}"
          f" on {torch.cuda.get_device_name(0)}", flush=True)
    if args.what == "gates-f64":
        got = gates_f64()
    elif args.what == "half-memory":
        got = half_memory(tuple(args.s))
    else:
        got = eam_rate(args.runs)
    print(json.dumps({args.what: got, "repo": str(args.repo or HERE)}))


if __name__ == "__main__":
    main()
