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

    python scripts/torch_checks.py glue [--repo DIR]
        where the card waits at 131k, for the LJ and the EAM deck (f32,
        the default kernels): chip_smoke.py's [profile-*] and
        [idle-split-*] lines (the idle of run() split into its part per
        run and its part in the step loop, and the host's against the
        card's time per rebin and per plain step) and the CLI's --timed
        t_force and t_neigh. --repo as for eam-rate, so that one call can
        run parent and change in turns.

    python scripts/torch_checks.py lj-parity --repo DIR [--runs 5]
        this checkout's kernels against DIR's (a parent commit unpacked
        with git archive) in four processes in turns, DIR, this, this, DIR
        (both packages are named minimd_torch, so each process imports
        one). Each process hashes the bytes of the kernels' outputs on the
        shapes 4k, 131k, 864k, cap64, cap512 and s6_nb2: lj_force f, eng,
        vir (ev and noev); lj_step x', w' and each step's eng, vir, vsq
        after 4 chained ev steps, and x', w' of one noev step; eam_rho,
        eam_force and the gather-table pair eam_rho_rows, eam_force_rows
        (rho, fp, the embed partials, f, eng, vir) on the EAM deck (ev and
        noev), also on chip_smoke.py's EAM lattice of twice the density
        ("dense", where the EAM kernels hand their stage and lists over
        early); the rebin's x, v, typ and overflow on those LJ shapes with
        at least 3 cells an axis and on chip_smoke.py's REBIN_SHAPES (a
        (3,3,3) grid, the EAM 131k lattice, an overflowing capacity, a
        teleporter); and the final x, v and thermo rows of a real run at 131k
        from each deck and EAM form (LJ run(200), EAM run(100) through the
        polynomial and through the gather-table kernels: a thermalised
        state whose cells can hold more than 32 atoms). Then it times
        lj_force and lj_step, the four EAM kernels (noev and ev) and the
        whole rebin (device ms with the queue kept full, the kernels' busy
        ms, host us per call) at 131k and 864k, and
        the main paths `runs` times each: LJ plain and
        fused_step (131k run(200), 864k run(100)) and EAM through the
        polynomial and the gather-table kernels (131k and 864k run(100)).
        The outputs must hash alike across all four processes.

    python scripts/torch_checks.py sharded-rate [--repo DIR] [--runs 5]
        the decomposed full-neighbor run of PR 9's phase 12: ShardedSimulation
        on a (2,2,2) mesh of this card's domains, the LJ and the EAM deck at
        131,072 atoms (f32), `runs` timed run(100)s each (CUDA events, after
        a warm run). --repo as for eam-rate, so that one call can run
        parent and change in turns.

Every line is printed as "[name] ..." and the last line is a JSON object
of the numbers.
"""

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
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


def glue(steps=(200, 100)):
    import contextlib
    import io

    sys.path.insert(0, str(HERE))
    from chip_smoke import device_share, idle_split
    from minimd_torch import cli

    out = {}
    for deck, n in zip(("lj", "eam"), steps):
        sim = _sim(deck, 32)
        device_share(f"{deck}-131k", sim, n)
        out[deck] = idle_split(f"{deck}-131k", sim, n)
        del sim
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["-i", str(HERE / f"inputs/in.{deck}.miniMD"),
                      "--timed"])
        perf = next(ln for ln in buf.getvalue().splitlines()
                    if "PERF_SUMMARY" in ln and not ln.startswith("#"))
        t_total, t_force, t_neigh = (float(v) for v in perf.split()[4:7])
        print(f"[timed-{deck}-131k] t_total={t_total:.4f}s t_force="
              f"{t_force:.4f}s t_neigh={t_neigh:.4f}s", flush=True)
        out[deck]["timed_s"] = (t_total, t_force, t_neigh)
    return out


def sharded_rate(runs=5, steps=100):
    import torch

    sys.path.insert(0, str(HERE))
    from chip_smoke import timed_run
    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation

    out = {}
    for deck in ("lj", "eam"):
        inp = parse_deck(HERE / f"inputs/in.{deck}.miniMD")
        sim = ShardedSimulation.from_input(inp, devices=["cuda"] * 8)
        rates = [timed_run(sim, steps)[2] for _ in range(runs)]
        print(f"[sharded-rate] {deck} 131k mesh={sim.mesh.shape} nb="
              f"{sim.geom.nb} C={sim.geom.capacity}: median "
              f"{statistics.median(rates):.3f} Matom-steps/s of "
              + " ".join(f"{r:.3f}" for r in rates), flush=True)
        out[f"{deck}_131k"] = rates
        del sim
        torch.cuda.empty_cache()
    return out


def _digest(*outs):
    """sha256 (16 hex digits) of the bytes of the tensors in outs."""
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


PARITY_SHAPES = ("4k", "131k", "864k", "cap64", "s6_nb2", "cap512")


def lj_parity_worker(runs):
    """One process of lj-parity: output hashes, kernel times and rates of
    the minimd_torch on sys.path."""
    import torch

    sys.path.insert(0, str(HERE))
    from chip_smoke import (EAM_RHO_SCALE, EAM_SHAPES, LJ_SHAPES,
                            REBIN_SHAPES, cuda_ms, host_us, lattice,
                            lj_params, profiled, queued_ms, rebin_case,
                            rebinned, through_rows, timed_run)
    from minimd_torch import cells
    from minimd_torch.ops import eam_cuda, eam_rows_cuda
    from minimd_torch.ops.eam import EAMTables
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_step_cuda import make_lj_step_cuda
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    out = {"hash": {}, "ms": {}, "host_us": {}, "rate": {}}
    hashes = out["hash"]
    tables = EAMTables.from_funcfl()

    def eam_hashes(label, s, nbins, cap, rho_scale=1.0):
        """Hash both EAM kernel pairs' outputs (ev and noev) on the EAM
        lattice of one shape; returns its geometry."""
        _, geom, st, xp = lattice(s, nbins, cap, deck="eam", kick=0.08,
                                  rho_scale=rho_scale)
        x = rebinned(geom, st, xp)
        for kind, rho_fn, pair_fn in (
                ("eam", eam_cuda.make_eam_rho_cuda,
                 eam_cuda.make_eam_pair_cuda),
                ("eam_rows", eam_rows_cuda.make_eam_rho_rows_cuda,
                 eam_rows_cuda.make_eam_pair_rows_cuda)):
            k_rho, k_pair = rho_fn(geom, tables), pair_fn(geom, tables)
            for ev in (True, False):
                tag = f"{kind} {label} {'ev' if ev else 'noev'}"
                rho, fp, embed = k_rho(x, ev)
                hashes[f"{tag} rho"] = _digest(rho, fp, embed)
                hashes[f"{tag} force"] = _digest(*k_pair(x, fp, ev))
        return geom

    def rebin_hash(label, geom, st, xp):
        hashes[f"rebin {label} x v typ overflow"] = _digest(
            *make_rebin_cuda(geom, "cuda")(xp, st.v, st.typ))

    # chip_smoke's shapes up to C = 512, which a parent before the
    # kernels took any capacity runs too
    for label in PARITY_SHAPES:
        s, nbins, cap = LJ_SHAPES[label]
        inp, geom, st, xp = lattice(s, nbins, cap)
        if min(geom.nb) >= 3:
            rebin_hash(label, geom, st, xp)
        rebin = cells.rebin_local if min(geom.nb) >= 3 else cells.rebin_lean
        x, v, typ, _ = rebin(xp, st.v, st.typ, geom)
        params = lj_params(inp)
        k_ev, k_noev = make_lj_force_cuda(geom, params)
        hashes[f"lj_force {label} ev"] = _digest(*k_ev(x, typ))
        hashes[f"lj_force {label} noev"] = _digest(*k_noev(x, typ))
        k_step, seed = make_lj_step_cuda(geom, params, inp.dt, 0.5 * inp.dt)
        x1, w1 = seed(x, v, k_noev(x, typ)[0])
        xs, ws, sums = x1.clone(), w1.clone(), []
        for _ in range(4):
            xs, ws, *ev = k_step(xs, ws, True)
            sums += ev
        hashes[f"lj_step {label} ev x4"] = _digest(xs, ws, *sums)
        hashes[f"lj_step {label} noev"] = _digest(
            *k_step(x1.clone(), w1.clone(), False)[:2])
        lj_grid = f"nb={geom.nb} C={geom.capacity}"
        geom = eam_hashes(label, s, nbins, cap)
        print(f"[lj-parity-hash] {label} LJ {lj_grid}, EAM nb={geom.nb} "
              f"C={geom.capacity}: "
              f"{sum(1 for k in hashes if f' {label} ' in k)} outputs",
              flush=True)
        torch.cuda.empty_cache()
    for label, scale in EAM_RHO_SCALE.items():
        geom = eam_hashes(label, *EAM_SHAPES[label], rho_scale=scale)
        print(f"[lj-parity-hash] {label} EAM nb={geom.nb} C={geom.capacity}"
              f": {sum(1 for k in hashes if f' {label} ' in k)} outputs",
              flush=True)
    for label in REBIN_SHAPES:
        geom, st, xp = rebin_case(label)
        rebin_hash(label, geom, st, xp)
        print(f"[lj-parity-hash] {label} rebin nb={geom.nb} C={geom.capacity}"
              ": 1 output", flush=True)
    for deck, steps, form in (("lj", 200, ""), ("eam", 100, ""),
                              ("eam", 100, " rows")):
        sim = _sim(deck, 32)
        if form:
            through_rows(sim)
        trace = sim.run(steps)
        if sim._regrows:
            raise AssertionError(f"{deck}{form} 131k: regrew")
        rows = torch.tensor(sim.thermo_trace(trace), dtype=torch.float64)
        hashes[f"run {deck}{form} 131k run({steps})"] = _digest(
            sim.state.x, sim.state.v, rows)
        print(f"[lj-parity-hash] {deck}{form} 131k run({steps}): rows "
              f"{rows.tolist()}", flush=True)
        del sim
    for label, s, iters in (("131k", 32, 50), ("864k", 60, 20)):
        inp, geom, st, xp = lattice(s)
        x, v, typ, _ = cells.rebin_local(xp, st.v, st.typ, geom)
        params = lj_params(inp)
        k_ev, k_noev = make_lj_force_cuda(geom, params)
        k_step, seed = make_lj_step_cuda(geom, params, inp.dt, 0.5 * inp.dt)
        x1, w1 = seed(x, v, k_noev(x, typ)[0])
        spare = torch.empty_like(x1)
        for name, fn in (
                ("lj_force", lambda: k_noev(x, typ)),
                ("lj_force_ev", lambda: k_ev(x, typ)),
                ("lj_step", lambda: k_step(x1, w1, False, out=spare)),
                ("lj_step_ev", lambda: k_step(x1, w1, True, out=spare))):
            out["ms"][f"{name} {label}"] = cuda_ms(fn, iters)
        # the whole rebin: device ms with the queue kept full, the card's
        # busy time per call (torch.profiler: the kernels alone, where
        # the host issues the parent's slower than the card runs them)
        # and the host's time to issue one
        rebin = make_rebin_cuda(geom, "cuda")
        out["ms"][f"rebin {label}"] = queued_ms(
            lambda: rebin(xp, st.v, st.typ), iters)
        busy = profiled(lambda: [rebin(xp, st.v, st.typ)
                                 for _ in range(iters)])[1]
        out["ms"][f"rebin_busy {label}"] = busy / iters
        out["host_us"][f"rebin {label}"] = host_us(
            lambda: rebin(xp, st.v, st.typ), iters)
        _, geom, st, xp = lattice(s, deck="eam", kick=0.08)
        x = rebinned(geom, st, xp)
        for kind, rho_fn, pair_fn in (
                ("", eam_cuda.make_eam_rho_cuda,
                 eam_cuda.make_eam_pair_cuda),
                ("_rows", eam_rows_cuda.make_eam_rho_rows_cuda,
                 eam_rows_cuda.make_eam_pair_rows_cuda)):
            k_rho, k_pair = rho_fn(geom, tables), pair_fn(geom, tables)
            fp = k_rho(x, False)[1]
            for name, fn in (
                    (f"eam_rho{kind}", lambda: k_rho(x, False)),
                    (f"eam_rho{kind}_ev", lambda: k_rho(x, True)),
                    (f"eam_force{kind}", lambda: k_pair(x, fp, False)),
                    (f"eam_force{kind}_ev", lambda: k_pair(x, fp, True))):
                out["ms"][f"{name} {label}"] = cuda_ms(fn, iters)
        print(f"[lj-parity-time] {label}: " + " ".join(
            f"{k.split()[0]}={v:.4f}ms" for k, v in out["ms"].items()
            if k.endswith(label)), flush=True)
        torch.cuda.empty_cache()
    for deck, label, s, steps, paths in (
            ("lj", "131k", 32, 200, ("plain", "fused")),
            ("lj", "864k", 60, 100, ("plain", "fused")),
            ("eam", "131k", 32, 100, ("plain", "rows")),
            ("eam", "864k", 60, 100, ("plain", "rows"))):
        for path in paths:
            sim = _sim(deck, s, fused_step=path == "fused")
            if path == "rows":
                through_rows(sim)
            rates = [timed_run(sim, steps)[2] for _ in range(runs)]
            if sim.state.overflow or sim._regrows:
                raise AssertionError(f"{deck} {label} {path}: regrew")
            out["rate"][f"{deck} {label} {path}"] = rates
            print(f"[lj-parity-rate] {deck} {label} {path}: median "
                  f"{statistics.median(rates):.3f} Matom-steps/s of "
                  + " ".join(f"{r:.3f}" for r in rates), flush=True)
            del sim
    return out


def lj_parity(repo, runs):
    """Four lj-parity workers in turns (repo, this, this, repo); raises
    SystemExit if any output hash differs."""
    turns = [("parent", repo), ("change", HERE), ("change", HERE),
             ("parent", repo)]
    got = []
    for name, where in turns:
        proc = subprocess.run(
            [sys.executable, __file__, "lj-parity", "--worker", "--repo",
             str(where), "--runs", str(runs)], capture_output=True,
            text=True, check=False)
        lines = proc.stdout.strip().splitlines()
        print("\n".join(f"{name}: {ln}" for ln in lines[:-1]), flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"lj-parity worker ({name}) failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        got.append((name, json.loads(lines[-1])["lj-parity"]))
    first = got[0][1]["hash"]
    differ = sorted({k for _, g in got for k in first
                     if g["hash"].get(k) != first[k]})
    for k in first:
        print(f"[lj-parity] {k}: "
              f"{'DIFFERS' if k in differ else 'bit-identical'} "
              f"({first[k]})", flush=True)
    summary = {"identical": len(first) - len(differ), "differ": differ,
               "turns": [n for n, _ in got]}
    for key in ("ms", "host_us", "rate"):
        summary[key] = {k: [g[key][k] for _, g in got] for k in got[0][1][key]}
    for k, vals in summary["ms"].items():
        print(f"[lj-parity-ms] {k} P C C P: "
              + " ".join(f"{v:.4f}" for v in vals), flush=True)
    for k, vals in summary["host_us"].items():
        print(f"[lj-parity-host-us] {k} P C C P: "
              + " ".join(f"{v:.1f}" for v in vals), flush=True)
    for k, vals in summary["rate"].items():
        med = [statistics.median(v) for v in vals]
        print(f"[lj-parity-rate] {k} medians P C C P: "
              + " ".join(f"{v:.3f}" for v in med) + "; parent range "
              f"{min(min(vals[0]), min(vals[3])):.3f}-"
              f"{max(max(vals[0]), max(vals[3])):.3f}, change range "
              f"{min(min(vals[1]), min(vals[2])):.3f}-"
              f"{max(max(vals[1]), max(vals[2])):.3f}", flush=True)
    if differ:
        print(json.dumps({"lj-parity": summary}))
        raise SystemExit(f"lj-parity: {len(differ)} output(s) differ")
    return summary


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["gates-f64", "half-memory", "eam-rate",
                                    "glue", "lj-parity", "sharded-rate"])
    p.add_argument("--repo", default=None,
                   help="eam-rate, glue, lj-parity, sharded-rate: import "
                   "minimd_torch from this checkout (lj-parity: the one the "
                   "change is held against)")
    p.add_argument("--worker", action="store_true",
                   help="lj-parity: one process of the four")
    p.add_argument("--runs", type=int, default=None)
    p.add_argument("--s", type=int, nargs="+", default=[32, 60])
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scripts/torch_checks.py needs a CUDA card")
    if args.what == "lj-parity" and not args.worker:
        if args.repo is None:
            raise SystemExit("lj-parity needs --repo DIR (the parent)")
        got = lj_parity(pathlib.Path(args.repo).resolve(), args.runs or 5)
        print(json.dumps({"lj-parity": got, "repo": args.repo}))
        return
    sys.path.insert(0, str(pathlib.Path(args.repo or HERE).resolve()))
    import minimd_torch

    print(f"[setup] minimd_torch from "
          f"{pathlib.Path(minimd_torch.__file__).parent} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if args.what == "gates-f64":
        got = gates_f64()
    elif args.what == "half-memory":
        got = half_memory(tuple(args.s))
    elif args.what == "eam-rate":
        got = eam_rate(args.runs or 10)
    elif args.what == "glue":
        got = glue()
    elif args.what == "sharded-rate":
        got = sharded_rate(args.runs or 5)
    else:
        got = lj_parity_worker(args.runs or 5)
    print(json.dumps({args.what: got, "repo": str(args.repo or HERE)}))


if __name__ == "__main__":
    main()
