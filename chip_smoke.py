#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimd_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels of minimd_torch/csrc with nvcc (one process per
   source, side by side);
3. hold each kernel against its plain PyTorch version on the card, f32:
   the LJ force (ev and noev) at 4k, 131k, 864k, a pinned capacity=64
   grid, s=6 on a (2,2,2) grid (image aliasing), capacities 512 and 520
   and two grids whose cells hold more than 512 atoms (s=18 on (3,3,3),
   C = 936; s=20 on (2,2,2), C = 4,152, whose parts of a round each keep
   thousands of candidates: the plain mirror's count is printed); the
   rebin (the two launches of
   csrc/rebin.cu), bit-identical to cells.rebin_local (x, v, typ and the
   overflow), on a perturbed state of the 4k, 131k, 864k, capacity=64,
   512, 520 and C = 936 grids (ranks past 512), a (3,3,3) grid (every neighbor wraps), the EAM
   deck's 131k lattice, a capacity that overflows and a teleporter (every
   lattice has four atom types);
   the two EAM kernels (density + embedding, force) on the same five
   shapes of the EAM deck, cap512, cap520, a lattice of twice the density
   (where the kernels hand their stage and lists over early) and s=18 on
   (2,2,2) (C = 3280, where the stage of C = 512 is handed over): rho, fp
   (bit-identical to the plain embedding of the kernel's own rho), the
   embed energy sum, forces, energy and virial, ev and noev; the fused LJ step on the LJ shapes (one call and
   4 chained calls, ev and noev: x', w', eng, vir, vsq, the input buffer
   unchanged, empty slots copied); the two gather-table EAM kernels on
   every EAM shape, cap512 and the dense lattice included, with the
   polynomial kernels' checks (both pairs run the passes of
   minimd_torch/csrc/eam_pass.cuh: one warp per cell on the pruned stage
   and per-lane in-cut lists of csrc/cell_stage.cuh, the gather tables a
   cubic per pair function where the polynomial form runs a Horner);
4. the 4k/10000-step f32 acceptance gates against tests/golden/4k.lj and
   tests/golden/4k.eam with the reference's statistical criterion
   (validate.compare_traces): LJ and EAM on the default path, LJ through
   Simulation(fused_step=True), EAM through the gather-table kernels;
5. the LJ main path at full width: Simulation.from_input on the benchmark
   deck inputs/in.lj.miniMD (131,072 atoms), run(200), with the kernels'
   launch counts taken over exactly that run and its step-100 row held
   against the reference's -s 32 smoke values, once on the default path
   and once with fused_step=True (190 lj_step and 10 lj_force launches);
   then -s 60 (864,000 atoms, 100 steps) against tests/golden/864k.lj on
   both paths; timed runs of the two paths in turns (CUDA events, after a
   warm run), a torch.profiler pass of each at 131k and 864k (the card's
   busy share), the host's and the card's time per rebin and per plain
   step (how much of the idle time each explains), each kernel timed
   against its plain version at both sizes (the whole rebin against
   cells.rebin_local) and the host's time to issue one call of each LJ
   wrapper and of the rebin;
6. the EAM main path at full width: inputs/in.eam.miniMD (131,072 Cu
   atoms), run(100) with the EAM kernels' launches counted over exactly
   that run and its step-0 row held against the golden step 0; then -s 60
   (864,000 atoms) against tests/golden/864k.eam at steps 0 and 100; each
   once with the polynomial kernels (the default) and once through the
   gather-table kernels (the Simulation's force closures set to
   ops/eam_rows_cuda.py's; no regrow may undo that); timed runs and
   kernel timings as for LJ, and the EAM kernels' candidates and
   pair-function warp-steps per cell from the plain mirror of their
   lists (one count for both forms: they share the stage and the f32
   cutoff);
7. the micro-probes (minimd_torch/micro.py): fma_chain and copy_add
   against their plain versions, then their own main path, the
   exp_micro.py timing loop at the TPU's rep counts, with launches counted
   over exactly that run: GFMA/s and GB/s with their shares of 33.5
   TFMA/s and 3.35 TB/s, the copy slope again on a 256 MB array, and
   copy_add per sweep beside torch.add(x, 1.0, out=y);
8. the half-neighbor paths (Simulation(half_neigh=True)): the 4k gates
   (LJ gn=1, LJ gn=0, EAM; HALF_GATE_STEPS steps) against the goldens,
   and 131k runs of each with step 0 and step 100 held against the full
   path's rows, every atom kept, the rate, peak memory and time per force;
9. the CLI at 131k: `--timed -o 1` on the LJ deck and `--timed` on the
   EAM deck, t_force and t_neigh above 0, the YAML's lost_atoms: 0, rows
   equal to run()'s;
10. checkpoint at 131k: save after 100 steps, resume, 100 more, against
   the uninterrupted run;
11. the CLI outside the kernels' envelope on both decks at -s 10:
   --precision 2 and -b 12 (stencil reach 2), on the JAX package's
   accelerator paths (plain LJ grid, exact-spline EAM, plain EAM grid),
   rows against tests/golden/4k.*;
12. the decomposed run (minimd_torch/parallel) on this card's domains:
   the sharded forms of lj_force, eam_rho, eam_force (every domain of
   the card in one launch) on the 131k LJ and EAM lattices split
   (2,2,2) and (4,2,1), per atom bit for bit the one-device kernels on
   the same cells and within tolerance of their plain versions; the
   migration with the sharded rebin kernels placing the residents, bit
   for bit the plain exchange_rebin (and a teleporter, movement overflow
   1); ShardedSimulation's 4k/10000 f32 gates, LJ and EAM on (2,2,2);
   the 131k main paths on (2,2,2) with the sharded kernels' launches
   counted; rates of Simulation and a 1-domain ShardedSimulation in
   turns and of (2,2,2) on the card, with its host time per step, at
   131k and 864k;
13. the decomposed run's surface on this card: the CLI's `--devices 8
   --timed -o 1` on both decks at 131k (rows against the one-device
   run's, lost_atoms 0, the YAML's per-device statistics, t_force, t_comm
   and t_neigh above 0 and within t_total, the sharded kernels
   launched); the sharded half paths (LJ gn=1, LJ gn=0, EAM; plain torch
   forces, the migration's sharded rebin) on (2,2,2) at 131k, rows
   against the decomposed full path's and the one-device half path's,
   rate and peak memory; their 4k/10000 f32 LJ gate; resume_sharded at
   131k against the uninterrupted run; dryrun_multichip(8);
14. past cells.MAX_CAPACITY (512, where the JAX package stops growing):
   the 4k LJ and EAM decks at capacity=520 f32 on the card, and the LJ
   deck through the fused step, 40 steps each (two rebins) through the
   kernels (each of the path's kernels launched), rows at steps 0 and 40
   against the default-capacity card run's; then a 4k LJ float64
   ShardedSimulation on ["cuda:0", "cpu"] * 4, two device groups whose
   copies go through the routes (the boundary slabs only), rows against
   the one-group card run, with the elements each step ships per group
   beside the whole other group's. [setup] prints the seconds of the main
   paths' Simulation.from_input calls (131k and 864k, LJ and EAM);
15. the host side: [setup-split] Simulation.from_input at LJ 131k, 864k
   and 2,048,000 atoms (inputs/in.lj.miniMD.80) and EAM 864k, then its
   pieces (setup_system on the host runtime and on its numpy bodies in
   turns, build_geometry, init_state with the upload, from_state with the
   first force); [sweep-large] minimd_torch.run_tests' card `large` scope
   (LJ -s 40/2000 and -s 60/1000, EAM -s 20/10000 and -s 40/1000 against
   tests/golden, PASS or XFAIL with the kernels' launches); [native] the
   host runtime (csrc/native.cpp) bit for bit its numpy bodies at 864k,
   host seconds in turns; [data-864k] the LJ deck at -s 60 written with
   write_lammps_data and read through -f, its rows bit for bit the deck
   run's; [data-1m] python -m minimd_torch.make_data's 1,048,576 atoms in
   the box of tests/golden/1049k.lj-data, 100 steps through the CLI's -f,
   every atom kept, rows equal to Simulation.from_arrays' on its arrays;
16. the port's bench: python -m minimd_torch.bench (bench.py's cells,
   run lengths and best-of-3 slopes: LJ and EAM at 131k and 864k, the
   1-domain ShardedSimulation), python -m minimd_torch.bench --devices 8
   and python -m minimd_torch.perf --style eam --n 32, each in its own
   process: exit 0, every slope line printed, the last line bench.py's
   JSON keys with every rate finite and above 0 and the card named,
   perf's two lines with overflow=0; the bench's lj_131k beside the rates
   timed_run read at 131k in this call (phase 5), as a ratio.

Each kernel's bound is the least time the card could take for its work:
the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its FP32 operations (for the pair kernels on the in-cut
pairs of the timed input) over 67 TFLOP/s (an FMA counts 2, a compare,
select, min, max, square root, conversion or divide 1), the published
H100 SXM peaks; the rebin's bound is its bytes, x, v and typ read and
written once (56 B a slot). No single PyTorch call computes any of the
pair, rebin or FMA-chain functions, so their library_ms is null;
copy_add's is torch.add(x, 1.0, out=y).

Prints a JSON line of the 9 ported kernels and the 4 sharded forms, the
rates, the probes' pins, the half paths', the decomposed surface's and
phase 14's numbers, the set-up seconds and phase 15's (setup_split,
sweep_large, data) and phase 16's (bench), the card line, and last
{"ok": true,
"device": {...}}. Any failure raises: the exit code is then not 0 and no
result line is printed.
"""

import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

F_TOL, ENG_TOL, VIR_TOL = 2e-5, 1e-5, 1e-4   # tests/test_lj_trace.py:314-316
RHO_TOL = EMBED_TOL = 1e-5
# the fused step after 4 chained steps, of the scale of x and w
# (tests/test_lj_trace.py:586-598)
X_TOL, W_TOL, VSQ_TOL = 1e-6, 1e-5, 1e-5
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12      # H100 SXM: HBM3, FP32 (no TC)
# the FMA chain after 48 and 480 links (reps 2, 20): the kernel and the
# plain version both round once per link, so 2 ulps of values in [1, 2);
# a chain without the + 1e-7 is off by ~5.7e-6 at reps 2, one of 23 links
# per rep by ~2.1e-6 (tests/test_torch_micro.py)
FMA_ATOL = {2: 2.4e-7, 20: 2.4e-7}
# the half path against the full path at 131k, f32, relative: step 0 sums
# the same pairs in another order (T is the same sum), and for EAM the
# full path's pair functions are the kernels' fitted polynomials where the
# half path evaluates the exact splines; step 100 comes after 100 steps of
# two f32 trajectories (|P| < 1 is held absolutely)
HALF_STEP0_RTOL = {"lj": 2e-5, "eam": 1e-4}
HALF_STEPN_RTOL = 1e-3
# a resumed f32 run against the uninterrupted one after 100 steps: the
# checkpoint folds positions into the box and lays the cells out anew, so
# the force sums run in another order
CHECKPOINT_RTOL = 1e-3
# the 4k half-path gates' length: 10,000 steps, as the other gates run.
# They take ~190 s of the three on an H100 (the half path is plain torch,
# ~170 launches per LJ step), but 2,000 steps are too few for the LJ
# criterion: its tolerance is tight before step 700 in f32 (1400 in f64),
# so a short run is decided by those rows. Read over rows 0-2000 (each
# gate prints it), the default LJ kernel path fails too (T 0.476, E 0.524,
# P 0.286), as do both float64 half paths (scripts/torch_checks.py
# gates-f64), and all of them pass at 10,000 (PERF.md).
HALF_GATE_STEPS = 10000
SHAPES = {"4k": (10, None, None), "131k": (32, None, None),
          "864k": (60, None, None), "cap64": (10, None, 64),
          "s6_nb2": (6, (2, 2, 2), None)}
# the LJ kernels also at C = 512, the largest stage (STAGE_MAX entries:
# 73.7 KB of shared memory, past the 48 KB that a kernel gets without
# opting in), and past it, where the pair loop walks a round in parts of
# STAGE_MAX slots: C = 520, cells of 864 atoms (C = 936, the rebin's
# ranks past 512) and of 4,000 (C = 4,152, parts that keep up to ~4,000
# candidates each)
LJ_SHAPES = {**SHAPES, "cap512": (10, None, 512), "cap520": (10, None, 520),
             "c936": (18, (3, 3, 3), None), "stage": (20, (2, 2, 2), None)}
# the pair kernels' stage past C = 512 (csrc/cell_stage.cuh kMaxStage)
STAGE_MAX = 9 * 512
# lj_force's compare at cap512 takes the fused step's +-0.04 lattice: in
# the +-0.12 draw of that layout the positive and negative pair energies
# nearly cancel, so f32 sums in two orders (the plain version's and the
# kernel's, or the plain version's and its own f64 value) differ past
# ENG_TOL, while forces and virial agree as at the other shapes
# (PERF.md, the LJ pair loop findings)
# (the shapes past C = 512 take it too, untried at +-0.12)
LJ_KICK = {"cap512": 0.04, "cap520": 0.04, "c936": 0.04, "stage": 0.04}
# the Verlet list's plain mirror walks M x 27*C candidates: held against
# the kernel's list up to this many (131k: 2.1e8)
LIST_MIRROR_CELLS = 3e8
# the EAM kernels (both forms) also at C = 512 (the force pass's largest
# stage, STAGE_MAX candidates with fp, takes 92 KB of shared memory,
# opted in) and on a lattice of twice the deck's density, where a cell keeps more
# candidates than its stage holds (up to 357 against 9*C - 32 = 328)
# and atoms have up to 78 pairs in the cutoff against a list of 64: the
# kernels hand their stage over and run their lists early there
# and past C = 512: cap520, and cells of 2,916 atoms (C = 3,280), whose
# stencil keeps more candidates than the largest stage holds
EAM_SHAPES = {**SHAPES, "cap512": (10, None, 512), "dense": (10, None, None),
              "cap520": (10, None, 520), "stage": (18, (2, 2, 2), None)}
EAM_RHO_SCALE = {"dense": 2.0}
# the rebin also on (s, nbins, capacity, deck, kick, teleport): a (3,3,3)
# grid, where every neighbor of every cell wraps; the EAM deck's 131k
# lattice (its own grid, four types as every lattice here); the 4k grid
# at C = 32, which it fills exactly, with kicks that make cells take more
# than C; and one atom moved by half the box, which is lost (counted, not
# placed)
REBIN_SHAPES = {"nb3": (6, (3, 3, 3), None, "lj", 0.12, False),
                "eam-131k": (32, None, None, "eam", 0.08, False),
                "overflow": (10, None, 32, "lj", 0.5, False),
                "teleporter": (10, None, None, "lj", 0.12, True)}
REBIN_OVERFLOWS = ("overflow", "teleporter")
# the EAM kernels' prune keeps ~0.2 of the 27*C slots on the Cu lattice
EAM_KEPT_SHARE = 0.3


def ptxas_summary(log):
    """'kernel[<ev>]: registers, shared memory, spills' for each kernel in
    nvcc's -Xptxas -v report."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            m = re.search(r"\d([a-z_]+_kernel)", mangled)
            # the names of each bool template argument's two values
            flags = ((("one", "sharded"), ("shared", "wide"))
                     if "rebin" in mangled
                     else (("noev", "ev"), ("whole", "parts")))
            args, nbool = [], 0
            for num, flag in re.findall(r"Li(\d+)E|L(b[01])E", mangled):
                if num:
                    args.append(num)
                else:
                    args.append(flags[min(nbool, 1)][int(flag[1])])
                    nbool += 1
            name = (m.group(1) if m else mangled) + (
                f"<{','.join(args)}>" if args else "")
        elif "spill stores" in ln:
            spill = ln.strip().split(", ", 1)[1]
        elif "Used" in ln:
            out.append(f"{name}: {ln.split('Used ')[1]}, {spill}")
    return out


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def lj_list_times(geom, params, x, typ, k_ev, k_noev, iters):
    """ms a call of the LJ closures at x: the force over a kept list with
    its check and idle repair (lj, lj_ev), a call that names a new layout
    and so builds the list first (lj_fresh), and one whose check fails, so
    that the card repairs the list (lj_stale: every atom's build position
    moved by 1 first), with the build and the repair alone (lj_build,
    lj_repair: the differences), against the cell-walk kernel (lj_walk,
    lj_walk_ev)."""
    import itertools

    from minimd_torch.ops import lj_cuda

    names = itertools.count(1)
    t = {"lj_fresh": cuda_ms(lambda: k_noev(x, typ, layout=next(names)),
                             iters)}
    nl = k_ev.verlet
    kept = nl.layout
    t["lj_ev"] = cuda_ms(lambda: k_ev(x, typ, layout=kept), iters)
    t["lj"] = cuda_ms(lambda: k_noev(x, typ, layout=kept), iters)
    t["lj_build"] = t["lj_fresh"] - t["lj"]

    def stale():
        nl.xref.add_(1.0)
        k_noev(x, typ, layout=kept)

    t["lj_stale"] = cuda_ms(stale, iters)
    t["lj_repair"] = t["lj_stale"] - t["lj"] - cuda_ms(
        lambda: nl.xref.add_(1.0), iters)
    t["lj_walk"] = cuda_ms(
        lambda: lj_cuda.cell_walk(geom, params, x, False), iters)
    t["lj_walk_ev"] = cuda_ms(
        lambda: lj_cuda.cell_walk(geom, params, x, True), iters)
    return t


def time_lj_relaxed(label, sim, steps, iters):
    """The LJ list force, its build and the cell walk (lj_list_times) on
    a Simulation's state after `steps` more steps: a relaxed state, where
    the lattice's shells have spread; and the repairs that the card's
    drift check made over those steps (repairs, and per interval)."""
    nl = sim.force_fn.verlet
    before = int(nl.rebuilds)
    sim.run(steps)
    repairs = int(nl.rebuilds) - before
    x, typ = sim.state.x, sim.state.typ
    t = lj_list_times(sim.geom, sim.params, x, typ, sim.force_fn,
                      sim.force_fn_noev, iters)
    t["repairs"] = repairs
    t["repairs_per_interval"] = repairs * sim.inp.neigh_every / steps
    phase("kernel-time", f"lj {label} relaxed ({steps} steps more) "
          f"nb={sim.geom.nb} C={sim.geom.capacity}: " + " ".join(
              f"{k}={v:.4f}ms" for k, v in t.items()
              if k.startswith("lj")) + f" repairs={repairs} "
          f"({t['repairs_per_interval']:.2f} an interval)")
    return t


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms over iters calls, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters):
    """Device time of fn() in ms over iters calls with the card's queue
    kept full: a spin kernel holds the card while the host queues the
    calls, so a call that the host issues more slowly than the card runs
    it (the rebin at 131k) is timed on the card, not on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * one + 2e-3)))  # ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters):
    """Host time in microseconds to issue one fn() (the Python wrapper and
    the launch), over iters calls that queue faster than the card runs
    them; then waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


@functools.lru_cache(maxsize=None)
def _setup(deck, s, rho_scale=1.0):
    from minimd_torch import create
    from minimd_torch.config import builtin_deck

    inp = builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = s
    inp.rho *= rho_scale
    return inp, create.setup_system(inp)


def lattice(s, nbins=None, capacity=None, seed=7, deck="lj", kick=0.12,
            rho_scale=1.0):
    """(deck, geometry, f32 CUDA state, perturbed positions) of a shipped
    deck at size s, its density times rho_scale; every atom moved by
    ±kick per coordinate (the LJ default is tests/test_cells.py:94-96's),
    so a rebin has atoms to move. The EAM deck's geometry is built as the
    port builds it (solid)."""
    import numpy as np
    import torch

    from minimd_torch import cells
    from minimd_torch.state import init_state

    inp, (prd, x, v, typ, _) = _setup(deck, s, rho_scale)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, nbins=nbins,
                                capacity=capacity, solid=deck == "eam")
    st = init_state(x, v, typ, geom, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed)
    kick = torch.as_tensor(kick * np.sign(rng.normal(size=(3, geom.nslots))),
                           dtype=torch.float32, device="cuda")
    xp = st.x + kick * st.valid
    return inp, geom, st, xp


def rebin_case(label):
    """(geometry, f32 CUDA state, perturbed positions) of a REBIN_SHAPES
    case."""
    s, nbins, cap, deck, kick, teleport = REBIN_SHAPES[label]
    _, geom, st, xp = lattice(s, nbins, cap, deck=deck, kick=kick)
    if teleport:
        i = int(st.valid.nonzero()[0])
        xp[0, i] += geom.prd[0] * 0.5
    return geom, st, xp


def rebinned(geom, st, xp):
    from minimd_torch import cells

    rebin = cells.rebin_local if min(geom.nb) >= 3 else cells.rebin_lean
    return rebin(xp, st.v, st.typ, geom)[0]


def lj_params(inp):
    from minimd_torch.ops.lj import LJParams

    return LJParams.from_deck(1, inp.epsilon, inp.sigma, inp.force_cut)


def count_pairs(geom, x, cut, split=None):
    """(pairs with r < cut, of them r < split): ordered full-neighbor
    pairs of the positions, self excluded, on the plain grid."""
    import torch

    from minimd_torch.ops.pairgrid import (halo_extent, stencil_slice,
                                           to_padded_soa)

    h = halo_extent(geom)
    Xp = to_padded_soa(x, geom, h)
    Xi = [stencil_slice(g, (0, 0, 0), h, geom.nb)[..., :, None] for g in Xp]
    n_cut = n_split = 0
    for off in geom.stencil:
        d = [Xi[k] - stencil_slice(Xp[k], off, h, geom.nb)[..., None, :]
             for k in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        if not off.any():
            rsq += torch.eye(geom.capacity, device=x.device) * 1e30
        n_cut += int((rsq < cut * cut).sum())
        if split is not None:
            n_split += int((rsq < split * split).sum())
    return n_cut, n_split


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the two least times."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# FP32 operations per in-cut pair (see the module docstring): distance
# (3 sub, 3 mul, 2 add) and the per-thread force sum (3 FMA)
_DIST_OPS, _FSUM_OPS = 8, 6
_LJ_PAIR_OPS = _DIST_OPS + 1 + 5 + 4 + _FSUM_OPS  # div, sr6, fc, sum


def _poly_ops(polys, name, tail: bool):
    """Operations of one pair function at one r: the body's u map and
    Horner, or the tail's t map and Horner (+ row pick)."""
    if not tail:
        return 4 + 2 * (len(polys.body[name]) - 1)       # u: fma, 2 clamps
    merged = polys.tail_merged[name]
    if merged is not None:
        return 3 + 2 * (len(merged) - 1)
    return 6 + 2 * (len(polys.tail[name][0]) - 1)        # + floor, pick, sub


def eam_pair_ops(polys, names, n_cut, n_body):
    """Operations of one EAM pass over n_cut pairs, n_body of them with
    r < split: distance, sqrt, the pair functions, and the pass's own
    arithmetic (rho: 1 add; force: psi' 1 add + 1 FMA, force sum)."""
    per = {tail: sum(_poly_ops(polys, nm, tail) for nm in names)
           for tail in (False, True)}
    own = 1 if names == ("R",) else 3 + _FSUM_OPS
    base = _DIST_OPS + 1 + own
    return (n_body * (base + per[False])
            + (n_cut - n_body) * (base + per[True]))


# the fused step's kicks and drift per slot: 3 x (mul, add) each
_STEP_SLOT_OPS = 18
# the gather-table index map per pair: select, sub, mul or FMA, min, max,
# conversion, min, sub; then one cubic (3 FMA) per function
_ROW_MAP_OPS, _CUBIC_OPS = 8, 6


def rows_pair_ops(names, n_cut):
    """Operations of one gather-table pass over n_cut pairs: distance,
    sqrt, the index map, a cubic per function, the pass's own arithmetic
    (as eam_pair_ops)."""
    own = 1 if names == ("R",) else 3 + _FSUM_OPS
    return n_cut * (_DIST_OPS + 1 + _ROW_MAP_OPS + own
                    + _CUBIC_OPS * len(names))


def counters():
    """Every kernel's launch count, by kernel name."""
    from minimd_torch import micro
    from minimd_torch.ops import (eam_cuda, eam_rows_cuda, lj_cuda,
                                  lj_step_cuda, rebin_cuda)

    return {"lj_force": lj_cuda.LAUNCHES, "rebin_pull": rebin_cuda.LAUNCHES,
            **eam_cuda.LAUNCHES, "lj_step": lj_step_cuda.LAUNCHES,
            **eam_rows_cuda.LAUNCHES, **micro.LAUNCHES,
            "lj_force_sharded": lj_cuda.SHARDED_LAUNCHES,
            **eam_cuda.SHARDED_LAUNCHES,
            "rebin_sharded": rebin_cuda.SHARDED_LAUNCHES}


def reset_counters():
    from minimd_torch import micro
    from minimd_torch.ops import (eam_cuda, eam_rows_cuda, lj_cuda,
                                  lj_step_cuda, rebin_cuda)

    lj_cuda.LAUNCHES = rebin_cuda.LAUNCHES = lj_step_cuda.LAUNCHES = 0
    lj_cuda.SHARDED_LAUNCHES = rebin_cuda.SHARDED_LAUNCHES = 0
    for d in (eam_cuda.LAUNCHES, eam_cuda.SHARDED_LAUNCHES,
              eam_rows_cuda.LAUNCHES, micro.LAUNCHES):
        for k in d:
            d[k] = 0


def through_rows(sim):
    """Set an EAM Simulation's force closures to the gather-table kernels
    and recompute its initial force (Simulation has no switch for them)."""
    from minimd_torch.ops.eam_rows_cuda import make_eam_force_rows_cuda

    sim.force_fn, sim.force_fn_noev = make_eam_force_rows_cuda(
        sim.geom, sim.tables, sim.dtype, sim.device)
    sim._compute_initial_force()
    return sim


def compare_lj(label, geom, params, x, typ):
    import torch

    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_grid import make_lj_force_grid

    k_ev, k_noev = make_lj_force_cuda(geom, params, torch.float32, "cuda")
    p_ev, _ = make_lj_force_grid(geom, params, torch.float32, "cuda")
    fk, ek, vk = k_ev(x, typ)
    fn, en, vn = k_noev(x, typ)
    fp, ep, vp = p_ev(x, typ)
    torch.cuda.synchronize()
    scale = fp.abs().max().item()
    err = (fk - fp).abs().max().item()
    err_noev = (fn - fp).abs().max().item()
    e_rel = abs(ek.item() - ep.item()) / abs(ep.item())
    v_rel = abs(vk.item() - vp.item()) / abs(vp.item())
    ok = (err / scale < F_TOL and err_noev / scale < F_TOL
          and e_rel < ENG_TOL and v_rel < VIR_TOL
          and en.item() == 0.0 and vn.item() == 0.0
          and bool(torch.isfinite(fk).all()))
    phase("compare", f"lj_force {label} nb={geom.nb} C={geom.capacity}: "
          f"max|df|/max|f| ev={err / scale:.3e} noev={err_noev / scale:.3e} "
          f"eng_rel={e_rel:.3e} vir_rel={v_rel:.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"LJ kernel disagrees with its plain version "
                             f"at {label}")
    return err


def compare_lj_list(label, geom, params, x, typ, cutneigh):
    """The LJ closures' Verlet list (csrc/lj_list.cu) at one shape: its
    entries and lengths against the plain mirror (pairgrid.verlet_lists,
    where the mirror's walk of M x 27*C fits LIST_MIRROR_CELLS), and the
    force over a fresh list against the cell-walk kernel bit for bit (f,
    eng and virial with ev; f without). A geometry whose list does not fit
    (lj_cuda.list_fits) keeps the cell walk: said so."""
    import torch

    from minimd_torch.cells import VALID_BELOW
    from minimd_torch.ops import lj_cuda
    from minimd_torch.ops.pairgrid import verlet_lists

    C = geom.capacity
    if not lj_cuda.list_fits(geom, x.device):
        phase("compare", f"lj_list {label} nb={geom.nb} C={C}: no list "
              f"(27*C={27 * C}), the cell walk")
        return
    k_ev, k_noev = lj_cuda.make_lj_force_cuda(geom, params, torch.float32,
                                              "cuda", cutneigh=cutneigh)
    same = []
    for evflag, fn in ((True, k_ev), (False, k_noev)):
        got = fn(x, typ, layout=0)
        want = lj_cuda.cell_walk(geom, params, x, evflag)
        same += [torch.equal(a, b) for a, b in zip(got, want)]
    nl = k_ev.verlet
    count = nl.count.long()
    mirror = "skipped (too large)"
    if geom.nslots * 27 * C <= LIST_MIRROR_CELLS:
        entries, want = verlet_lists(geom, x, cutneigh ** 2, VALID_BELOW,
                                     chunk=64)
        K = entries.shape[0]
        got = nl.entries[:K].long() & 0xFFFF
        live = torch.arange(K, device=x.device)[:, None] < want[None, :]
        mirror = (torch.equal(count, want) and torch.equal(
            torch.where(live, got, -1), entries))
    valid = x[0] < VALID_BELOW
    ok = all(same) and mirror is not False
    phase("compare", f"lj_list {label} nb={geom.nb} C={C}: list force "
          f"bit-identical to the cell walk={all(same)} ({same}); lists = "
          f"mirror's={mirror}; mean length {count[valid].double().mean():.2f}"
          f" longest {int(nl.longest)} of {lj_cuda.list_rows(C)} rows, "
          f"{nl.entries.numel() * 2 / 2**30:.3f} GiB -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the LJ Verlet list disagrees at {label}")


def near_cut(geom, x, cut, rel=1e-6):
    """(M,) bool: slots with a pair whose rsq is within rel*cut^2 of the
    cutoff, on the plain grid. Where two f32 versions round rsq
    differently, such a pair can be inside one version's cutoff and outside
    the other's, and the truncated LJ force jumps by |F(rc)| there."""
    import torch

    from minimd_torch.ops.pairgrid import (halo_extent, stencil_slice,
                                           to_padded_soa)

    h = halo_extent(geom)
    Xp = to_padded_soa(x, geom, h)
    Xi = [stencil_slice(g, (0, 0, 0), h, geom.nb)[..., :, None] for g in Xp]
    near = torch.zeros(geom.nb[::-1] + (geom.capacity,), dtype=torch.bool,
                       device=x.device)
    for off in geom.stencil:
        d = [Xi[k] - stencil_slice(Xp[k], off, h, geom.nb)[..., None, :]
             for k in range(3)]
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        near |= ((rsq - cut * cut).abs() < rel * cut * cut).any(dim=-1)
    return near.reshape(geom.nslots)


def compare_lj_step(label, geom, params, x, v, valid, dt, dtf):
    """max|dx'| of the fused-step kernel against its plain version after 4
    chained ev steps from seed(x, v, f); raises on any check that fails.

    (A) against the plain step's kicks and drift on the LJ force kernel's
    own force (the pair loop both kernels share, so the same pairs inside
    the cutoff), every slot; (B) against the plain step, on the atoms with
    no pair within ~13 f32 roundings of the cutoff in any of the 4 steps
    (near_cut), where the two versions may count a pair the other leaves
    out."""
    import torch

    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_grid import make_lj_force_grid
    from minimd_torch.ops.lj_step import make_lj_step_plain
    from minimd_torch.ops.lj_step_cuda import make_lj_step_cuda

    k_step, seed = make_lj_step_cuda(geom, params, dt, dtf)
    p_step, _ = make_lj_step_plain(geom, params, dt, dtf, device="cuda")
    k_force, _ = make_lj_force_cuda(geom, params)
    f = make_lj_force_grid(geom, params, device="cuda")[1](x, None)[0]
    x1, w1 = seed(x, v, f)
    cut = float(params.cutforcesq[0]) ** 0.5
    rel = {"eng": 0.0, "vir": 0.0, "vsq": 0.0}
    same_in = kept = True
    xk, wk, xp, wp, xa, wa = x1.clone(), w1.clone(), x1, w1, x1, w1
    near = torch.zeros_like(valid)
    a_err = [0.0, 0.0]
    for _ in range(4):
        near |= near_cut(geom, xp, cut)
        x_in, x_copy = xk, xk.clone()
        xk, wk, *evk = k_step(xk, wk, True)
        xp, wp, *evp = p_step(xp, wp, True)
        # (A): the plain kicks and drift, one torch op each, on the force
        # kernel's force
        fa, ea, va = k_force(xa, None)
        va_k = wa + dtf * fa
        wa = va_k + dtf * fa
        xa = xa + dt * wa
        for q, (a, b) in enumerate(((xk, xa), (wk, wa))):
            a_err[q] = max(a_err[q], (a - b).abs().max().item()
                           / b[:, valid].abs().max().item())
        same_in &= torch.equal(x_in, x_copy)
        kept &= torch.equal(xk[:, ~valid], x_copy[:, ~valid])
        for name, a, b in zip(rel, evk, evp):
            rel[name] = max(rel[name], abs(a.item() - b.item()) / abs(b.item()))
    # one noev call: the same state update, zero eng, vir, vsq
    xn, wn, *zk = k_step(x1.clone(), w1.clone(), False)
    xq, wq, *_ = p_step(x1, w1, False)
    torch.cuda.synchronize()
    far = valid & ~near
    n_near = int((valid & near).sum())

    def err(a, b):
        return ((a - b)[:, far].abs().max().item()
                / b[:, valid].abs().max().item())

    x_err = (xk - xp)[:, far].abs().max().item()
    x_rel, w_rel = err(xk, xp), err(wk, wp)
    nx_rel, nw_rel = err(xn, xq), err(wn, wq)
    w_all = ((wk - wp)[:, valid].abs().max().item()
             / wp[:, valid].abs().max().item())
    zeros = all(z.item() == 0.0 for z in zk)
    ok = (a_err[0] <= X_TOL and a_err[1] <= W_TOL
          and x_rel <= X_TOL and w_rel <= W_TOL
          and rel["eng"] <= ENG_TOL and rel["vir"] <= VIR_TOL
          and rel["vsq"] <= VSQ_TOL and nx_rel <= X_TOL and nw_rel <= W_TOL
          and zeros and same_in and kept and bool(torch.isfinite(xk).all()))
    phase("compare", f"lj_step {label} nb={geom.nb} C={geom.capacity}: "
          f"(A) vs kicks on the force kernel's f: dx={a_err[0]:.3e} "
          f"dw={a_err[1]:.3e}; "
          f"(B) vs plain, 4 steps, {n_near} atom(s) near the cutoff left "
          f"out: max|dx|/max|x|={x_rel:.3e} max|dw|/max|w|={w_rel:.3e} "
          f"(all atoms {w_all:.3e}) eng_rel={rel['eng']:.3e} "
          f"vir_rel={rel['vir']:.3e} vsq_rel={rel['vsq']:.3e} "
          f"noev dx={nx_rel:.3e} dw={nw_rel:.3e} zeros={zeros} "
          f"input unchanged={same_in} empty slots kept={kept} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused-step kernel disagrees with its plain "
                             f"version at {label}")
    return x_err


def compare_eam_rows(label, geom, tables, x, typ):
    """(max|drho|, max|df|) of the gather-table kernels against their plain
    versions; raises on any check that fails."""
    import torch

    from minimd_torch.cells import is_valid
    from minimd_torch.ops import eam_grid, eam_rows, eam_rows_cuda
    from minimd_torch.ops.eam import spline_columns

    k_rho = eam_rows_cuda.make_eam_rho_rows_cuda(geom, tables)
    p_rho = eam_rows.make_eam_rho_rows(geom, tables, device="cuda")
    rk, fpk, ek = k_rho(x, True)
    rp, _, ep = p_rho(x, True)
    frho = spline_columns(tables.frho_spline, torch.float32, "cuda")
    fp_own, _ = eam_grid.embedding(rk, frho, 1.0 / tables.drho)
    _, fpk_noev, ek_noev = k_rho(x, False)

    k_ev, k_noev = eam_rows_cuda.make_eam_force_rows_cuda(geom, tables)
    p_ev, _ = eam_rows.make_eam_force_rows(geom, tables, device="cuda")
    fk, engk, virk = k_ev(x, typ)
    fn, engn, virn = k_noev(x, typ)
    fpl, engp, virp = p_ev(x, typ)
    torch.cuda.synchronize()

    valid = is_valid(x)
    rho_err = (rk - rp).abs().max().item()
    rho_rel = rho_err / rp[valid].abs().max().item()
    fp_same = torch.equal(fpk, fp_own) and torch.equal(fpk_noev, fp_own)
    e_emb = abs(ek.item() - ep.item()) / abs(ep.item())
    scale = fpl.abs().max().item()
    err = (fk - fpl).abs().max().item()
    err_noev = (fn - fpl).abs().max().item()
    e_rel = abs(engk.item() - engp.item()) / abs(engp.item())
    v_rel = abs(virk.item() - virp.item()) / abs(virp.item())
    zeros = (ek_noev.item() == 0.0 and engn.item() == 0.0
             and virn.item() == 0.0)
    ok = (rho_rel <= RHO_TOL and fp_same and e_emb <= EMBED_TOL
          and err / scale <= F_TOL and err_noev / scale <= F_TOL
          and e_rel <= ENG_TOL and v_rel <= VIR_TOL and zeros
          and bool(torch.isfinite(fk).all()))
    phase("compare", f"eam_rows {label} nb={geom.nb} C={geom.capacity}: "
          f"rho max rel={rho_rel:.3e} fp bit-identical={fp_same} "
          f"sumF rel={e_emb:.3e} max|df|/max|f| ev={err / scale:.3e} "
          f"noev={err_noev / scale:.3e} eng_rel={e_rel:.3e} "
          f"vir_rel={v_rel:.3e} noev zeros={zeros} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"gather-table EAM kernels disagree with their "
                             f"plain versions at {label}")
    return rho_err, err


def compare_rebin(label, geom, st, xp):
    """The rebin kernels against cells.rebin_local, bit for bit (x, v,
    typ, overflow); the overflow must be above 0 just where the case
    overflows."""
    import torch

    from minimd_torch import cells
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    rk = make_rebin_cuda(geom, "cuda")(xp, st.v, st.typ)
    rp = cells.rebin_local(xp, st.v, st.typ, geom)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(rk, rp))
    overflows = int(rp[3]) > 0
    phase("compare", f"rebin {label} nb={geom.nb} C={geom.capacity} "
          f"types={int(st.typ[st.valid].unique().numel())}: "
          f"bit-identical={same} overflow={int(rk[3])}/{int(rp[3])} "
          f"atoms={int(cells.is_valid(rk[0]).sum())}/"
          f"{int(cells.is_valid(xp).sum())}")
    if not (same and overflows == (label in REBIN_OVERFLOWS)):
        raise AssertionError(f"rebin kernels differ from rebin_local (or "
                             f"the overflow is wrong) at {label}")
    return 0.0


def compare_eam(label, geom, tables, x, typ):
    """(max|drho|, max|df|) of the EAM kernels against their plain
    versions; raises on any check that fails."""
    import torch

    from minimd_torch.cells import is_valid
    from minimd_torch.ops import eam_cuda, eam_grid
    from minimd_torch.ops.eam import spline_columns

    k_rho = eam_cuda.make_eam_rho_cuda(geom, tables, device="cuda")
    p_rho = eam_grid.make_eam_rho_grid(geom, tables, device="cuda")
    rk, fpk, ek = k_rho(x, True)
    rp, _, ep = p_rho(x, True)
    frho = spline_columns(tables.frho_spline, torch.float32, "cuda")
    fp_own, _ = eam_grid.embedding(rk, frho, 1.0 / tables.drho)
    _, fpk_noev, ek_noev = k_rho(x, False)

    k_ev, k_noev = eam_cuda.make_eam_force_cuda(
        geom, tables, device="cuda")
    p_ev, _ = eam_grid.make_eam_force_grid(geom, tables, device="cuda")
    fk, engk, virk = k_ev(x, typ)
    fn, engn, virn = k_noev(x, typ)
    fpl, engp, virp = p_ev(x, typ)
    torch.cuda.synchronize()

    valid = is_valid(x)
    rho_err = (rk - rp).abs().max().item()
    rho_rel = rho_err / rp[valid].abs().max().item()
    fp_same = torch.equal(fpk, fp_own) and torch.equal(fpk_noev, fp_own)
    e_emb = abs(ek.item() - ep.item()) / abs(ep.item())
    scale = fpl.abs().max().item()
    err = (fk - fpl).abs().max().item()
    err_noev = (fn - fpl).abs().max().item()
    e_rel = abs(engk.item() - engp.item()) / abs(engp.item())
    v_rel = abs(virk.item() - virp.item()) / abs(virp.item())
    zeros = (ek_noev.item() == 0.0 and engn.item() == 0.0
             and virn.item() == 0.0)
    ok = (rho_rel <= RHO_TOL and fp_same and e_emb <= EMBED_TOL
          and err / scale <= F_TOL and err_noev / scale <= F_TOL
          and e_rel <= ENG_TOL and v_rel <= VIR_TOL and zeros
          and bool(torch.isfinite(fk).all()))
    phase("compare", f"eam {label} nb={geom.nb} C={geom.capacity}: "
          f"rho max rel={rho_rel:.3e} fp bit-identical={fp_same} "
          f"sumF rel={e_emb:.3e} max|df|/max|f| ev={err / scale:.3e} "
          f"noev={err_noev / scale:.3e} eng_rel={e_rel:.3e} "
          f"vir_rel={v_rel:.3e} noev zeros={zeros} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"EAM kernels disagree with their plain "
                             f"versions at {label}")
    return rho_err, err


def candidate_counts(label, geom, params, x, n_cut):
    """The LJ pair loop's work at one shape, from the plain mirror of its
    prune (ops/pairgrid.kept_candidates) on the card: per own atom the
    27*C stencil slots, the valid candidates, the kept ones and the pairs
    inside the cutoff (n_cut); warp-iterations per cell, the kept list
    times the warps that hold an atom, against the plain walk's 27*C times
    every warp."""
    from minimd_torch.cells import VALID_BELOW
    from minimd_torch.ops.pairgrid import kept_candidates, walk_candidates

    n, C = geom.ncells, geom.capacity
    keep = kept_candidates(geom, x, float(params.cutforcesq[0]), VALID_BELOW)
    _, raw = walk_candidates(geom, x)
    own = (x[0] < VALID_BELOW).reshape(n, C)
    n_own = own.sum(dim=1).double()
    natoms = float(n_own.sum())
    warps = -(-C // 32)
    pad = own.new_zeros((n, warps * 32))
    pad[:, :C] = own
    active = pad.reshape(n, warps, 32).any(dim=2).sum(dim=1).double()
    kept = keep.sum(dim=1).double()
    got = {"slots": 27 * C,
           "valid": float((n_own * (raw < VALID_BELOW).sum(dim=1)).sum())
           / natoms,
           "kept": float((n_own * kept).sum()) / natoms,
           "in_cut": n_cut / natoms,
           "warp_iters": float((active * kept).sum()) / n,
           "warp_iters_plain": warps * 27 * C}
    got["kept_share"] = got["kept"] / got["slots"]
    phase("candidates", f"lj {label} C={C}: per atom 27*C={got['slots']} "
          f"valid={got['valid']:.1f} kept={got['kept']:.1f} "
          f"(share {got['kept_share']:.3f}) in-cut={got['in_cut']:.1f}; "
          f"warp-iterations per cell {got['warp_iters']:.1f} (plain walk "
          f"{got['warp_iters_plain']})")
    if not got["kept_share"] <= 0.6:
        raise AssertionError(f"candidates {label}: the prune keeps "
                             f"{got['kept_share']:.3f} of 27*C")
    return got


def stage_handover(label, kind, geom, x, cut):
    """How the pair kernels hand a "stage" shape's kept candidates over,
    from the plain mirror (pairgrid.kept_candidates): the LJ pair loop
    walks each round of 9 cells in parts of STAGE_MAX slots, so the shape
    must need more than one part a round (C > 512); the EAM passes hand
    their stage over when the next 32 slots might overfill it, so the
    shape's stencil must keep more than STAGE_MAX - 32. Prints the most
    candidates kept in one part (LJ) or one stencil (EAM)."""
    import torch

    from minimd_torch.cells import VALID_BELOW
    from minimd_torch.ops.pairgrid import kept_candidates

    keep = kept_candidates(geom, x, cut * cut, VALID_BELOW)
    n, C = geom.ncells, geom.capacity
    if kind == "lj":
        rounds = keep.reshape(n, 3, 9 * C)
        parts = -(-9 * C // STAGE_MAX)
        most = int(torch.stack([
            rounds[:, :, p * STAGE_MAX:(p + 1) * STAGE_MAX].sum(dim=2)
            for p in range(parts)]).max())
        ok = parts > 1
        what = f"{parts} parts a round, at most {most} kept in one"
    else:
        most = int(keep.sum(dim=1).max())
        ok = most > STAGE_MAX - 32
        what = f"at most {most} kept in one stencil"
    phase("stage", f"{kind} {label} nb={geom.nb} C={C}: {what}, against "
          f"a stage of {STAGE_MAX}: handed over in parts={ok}")
    if not ok:
        raise AssertionError(f"{kind} {label}: the shape does not hand "
                             "its stage over")
    return most


def eam_candidate_counts(label, geom, tables, x, max_share=EAM_KEPT_SHARE):
    """The EAM kernels' work at one shape, from the plain mirror of their
    stage and lists (ops/eam_cuda.in_cut_lists, list_steps) on the card:
    per own atom the 27*C stencil slots, the valid candidates, the kept
    ones and the pairs inside the cutoff; per cell the warp-steps of the
    pair functions over the lanes' lists and the longest lists (more
    steps than the longest lists: a stage or a list was handed over
    early), against the first design's, which ran them for every
    candidate inside the cutoff of any lane of a warp. The gather-table
    kernels stage and list the same candidates at the same f32 cutoff
    (checked here), so the counts are theirs too. Fails above a kept
    share of max_share."""
    from minimd_torch.cells import VALID_BELOW
    from minimd_torch.ops import eam_cuda, eam_rows_cuda
    from minimd_torch.ops.pairgrid import kept_candidates, walk_candidates

    n, C = geom.ncells, geom.capacity
    cutsq = tables.cut * tables.cut
    rows_cutsq = eam_rows_cuda.row_map(tables.rows, tables.cut).cutsq
    if rows_cutsq != eam_cuda.pair_params(tables.polys, tables.cut)[0].cutsq:
        raise AssertionError("the two EAM forms' kernels cut at different "
                             "f32 cutsq; the mirror counts one of them")
    keep = kept_candidates(geom, x, cutsq, VALID_BELOW)
    lists = eam_cuda.in_cut_lists(geom, x, cutsq)
    steps, any_lane = eam_cuda.list_steps(geom, lists, keep)
    _, raw = walk_candidates(geom, x)
    n_own = (x[0] < VALID_BELOW).reshape(n, C).sum(dim=1).double()
    natoms = float(n_own.sum())
    got = {"slots": 27 * C,
           "valid": float((n_own * (raw < VALID_BELOW).sum(dim=1)).sum())
           / natoms,
           "kept": float((n_own * keep.sum(dim=1)).sum()) / natoms,
           "in_cut": float(lists.sum()) / natoms,
           "steps": float(steps.double().mean()),
           "longest_list": float(lists.sum(dim=2).amax(dim=1)
                                 .double().mean()),
           "steps_any_lane": float(any_lane.double().mean())}
    got["kept_share"] = got["kept"] / got["slots"]
    phase("candidates", f"eam {label} C={C}: per atom 27*C={got['slots']} "
          f"valid={got['valid']:.1f} kept={got['kept']:.1f} (share "
          f"{got['kept_share']:.3f}) in-cut={got['in_cut']:.1f}; Horner "
          f"warp-steps per cell {got['steps']:.1f} on the lists (longest "
          f"list {got['longest_list']:.1f}) against "
          f"{got['steps_any_lane']:.1f} on any lane's cut (first design); "
          f"gather-table kernels: kept={got['kept']:.1f}, cubic warp-steps "
          f"per cell {got['steps']:.1f} against {got['steps_any_lane']:.1f}"
          f" (the same stage and lists, cutsq {rows_cutsq:.9g} in both)")
    del keep, lists
    if not got["kept_share"] <= max_share:
        raise AssertionError(f"eam candidates {label}: the prune keeps "
                             f"{got['kept_share']:.3f} of 27*C")
    return got


def time_kernels(label, inp, geom, st, xp, iters, plain_iters):
    """LJ, fused-step and rebin kernels against their plain versions at
    one shape: ms per call, and each kernel's bound from this input."""
    import torch

    from minimd_torch import cells
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_grid import make_lj_force_grid
    from minimd_torch.ops.lj_step import make_lj_step_plain
    from minimd_torch.ops.lj_step_cuda import make_lj_step_cuda
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    params = lj_params(inp)
    x, v, typ, _ = cells.rebin_local(xp, st.v, st.typ, geom)
    k_ev, k_noev = make_lj_force_cuda(geom, params, torch.float32, "cuda",
                                      cutneigh=inp.neigh_cut)
    _, p_noev = make_lj_force_grid(geom, params, torch.float32, "cuda")
    t = lj_list_times(geom, params, x, typ, k_ev, k_noev, iters)
    t["lj_plain"] = cuda_ms(lambda: p_noev(x, typ), plain_iters)
    # the fused step (noev, the plain-step variant) from seed(x, v, f);
    # LJ units, mass 1: dtforce = dt/2. w is updated in place call after
    # call, which changes no work.
    k_step, seed = make_lj_step_cuda(geom, params, inp.dt, 0.5 * inp.dt)
    p_step, _ = make_lj_step_plain(geom, params, inp.dt, 0.5 * inp.dt,
                                   device="cuda")
    x1, w1 = seed(x, v, k_noev(x, typ)[0])
    wk, spare = w1.clone(), torch.empty_like(x1)
    t["step"] = cuda_ms(lambda: k_step(x1, wk, False, out=spare), iters)
    t["step_ev"] = cuda_ms(lambda: k_step(x1, wk, True, out=spare), iters)
    t["step_plain"] = cuda_ms(lambda: p_step(x1, w1, False), plain_iters)
    # the whole rebin: its kernels against rebin_local on constants built
    # once (as a Simulation holds them), on the perturbed state
    rebin = make_rebin_cuda(geom, "cuda")
    consts = cells.RebinConstants.build(geom, torch.float32, "cuda")
    # what the host spends to issue each launch of a plain step, of a
    # fused step and of a rebin
    hosts = {"lj": lambda: k_noev(x, typ, layout=0),
             "step": lambda: k_step(x1, wk, False, out=spare),
             "kick": lambda: wk.add_(x1, alpha=0.0),
             "rebin": lambda: rebin(xp, st.v, st.typ)}
    host = {k: host_us(fn, iters) for k, fn in hosts.items()}
    t["rebin"] = queued_ms(lambda: rebin(xp, st.v, st.typ), iters)
    # the kernels' own time (torch.profiler), without the gaps between them
    t["rebin_busy"] = profiled(lambda: [rebin(xp, st.v, st.typ)
                                        for _ in range(iters)])[1] / iters
    t["rebin_plain"] = cuda_ms(lambda: cells.rebin_local(
        xp, st.v, st.typ, geom, consts=consts), plain_iters)
    M = geom.nslots
    n_cut, _ = count_pairs(geom, x, inp.force_cut)
    t["candidates"] = candidate_counts(label, geom, params, x, n_cut)
    t["lj_bound"] = bound(24 * M, n_cut * _LJ_PAIR_OPS)
    # x, w in; x', w' out
    t["step_bound"] = bound(48 * M, n_cut * _LJ_PAIR_OPS + _STEP_SLOT_OPS * M)
    # x, v, typ in and out: 7 words a slot each way
    t["rebin_bound"] = bound(56 * M, 0)
    phase("kernel-time", f"lj {label} nb={geom.nb} C={geom.capacity} "
          f"pairs={n_cut}: " + " ".join(
              f"{k}={v:.4f}ms" if isinstance(v, float) else
              f"{k}={v[0]:.5f}ms({v[1]})" for k, v in t.items()
              if k != "candidates"))
    phase("host-time", f"lj {label}: host us per call " + " ".join(
        f"{k}={v:.1f}" for k, v in host.items()))
    t["host_us"] = host
    return t


def time_eam_kernels(label, inp, geom, st, xp, iters, plain_iters):
    """The EAM kernels, polynomial and gather-table (noev), against their
    plain versions at one shape: ms per call, and each kernel's bound from
    this input."""
    from minimd_torch.ops import eam_cuda, eam_grid, eam_rows, eam_rows_cuda
    from minimd_torch.ops.eam import EAMTables

    tables = EAMTables.from_funcfl()
    x = rebinned(geom, st, xp)
    k_rho = eam_cuda.make_eam_rho_cuda(geom, tables, device="cuda")
    k_pair = eam_cuda.make_eam_pair_cuda(geom, tables, device="cuda")
    p_rho = eam_grid.make_eam_rho_grid(geom, tables, device="cuda")
    p_pair = eam_grid.make_eam_pair_grid(geom, tables, device="cuda")
    _, fp, _ = k_rho(x, False)
    t = {
        "rho": cuda_ms(lambda: k_rho(x, False), iters),
        "rho_ev": cuda_ms(lambda: k_rho(x, True), iters),
        "force": cuda_ms(lambda: k_pair(x, fp, False), iters),
        "force_ev": cuda_ms(lambda: k_pair(x, fp, True), iters),
        "rho_plain": cuda_ms(lambda: p_rho(x, False), plain_iters),
        "force_plain": cuda_ms(lambda: p_pair(x, fp, False), plain_iters),
    }
    k_rho = eam_rows_cuda.make_eam_rho_rows_cuda(geom, tables)
    k_pair = eam_rows_cuda.make_eam_pair_rows_cuda(geom, tables)
    p_rho = eam_rows.make_eam_rho_rows(geom, tables, device="cuda")
    p_pair = eam_rows.make_eam_pair_rows(geom, tables, device="cuda")
    t.update({
        "rho_rows": cuda_ms(lambda: k_rho(x, False), iters),
        "rho_rows_ev": cuda_ms(lambda: k_rho(x, True), iters),
        "force_rows": cuda_ms(lambda: k_pair(x, fp, False), iters),
        "force_rows_ev": cuda_ms(lambda: k_pair(x, fp, True), iters),
        "rho_rows_plain": cuda_ms(lambda: p_rho(x, False), plain_iters),
        "force_rows_plain": cuda_ms(lambda: p_pair(x, fp, False),
                                    plain_iters),
    })
    polys = tables.polys
    n_cut, n_body = count_pairs(geom, x, tables.cut, polys.split)
    t["candidates"] = eam_candidate_counts(label, geom, tables, x)
    M = geom.nslots
    embed_ops = 3 + 4 + 4            # p, m, pf; fp's two FMA
    t["rho_bound"] = bound(4 * (3 * M + 2 * M),
                           eam_pair_ops(polys, ("R",), n_cut, n_body)
                           + embed_ops * M)
    t["force_bound"] = bound(4 * (3 * M + M + 3 * M),
                             eam_pair_ops(polys, ("G1", "G2"), n_cut, n_body))
    tab = 16 * tables.rows.n_entries    # one float4 per piece and function
    t["rho_rows_bound"] = bound(4 * (3 * M + 2 * M) + tab,
                                rows_pair_ops(("R",), n_cut) + embed_ops * M)
    t["force_rows_bound"] = bound(4 * (3 * M + M + 3 * M) + 2 * tab,
                                  rows_pair_ops(("G1", "G2"), n_cut))
    phase("kernel-time", f"eam {label} nb={geom.nb} C={geom.capacity} "
          f"pairs={n_cut} (r<split {n_body}): " + " ".join(
              f"{k}={v:.4f}ms" if isinstance(v, float) else
              f"{k}={v[0]:.5f}ms({v[1]})" for k, v in t.items()
              if k != "candidates"))
    return t


def timed_run(sim, steps):
    """Matom-steps/s of sim.run(steps) on CUDA events, after a warm run."""
    import torch

    sim.run(steps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    trace = sim.run(steps)       # ends in a host sync
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    return trace, ms, sim.natoms * steps / (ms * 1e-3) / 1e6


def _dev_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3


def profiled(fn):
    """(wall ms, device busy ms, key_averages) of fn() under
    torch.profiler (CUDA activity), the card synchronized before and
    after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    return wall, sum(_dev_ms(e) for e in events), events


def device_share(label, sim, steps):
    """Wall and device kernel time of sim.run(steps) under torch.profiler
    (CUDA activity only, after a warm run): the device's busy share and
    its five longest kernels. Prints "not measured" where the profiler
    records no device time."""
    sim.run(steps)
    wall, busy, events = profiled(lambda: sim.run(steps))
    top = sorted(events, key=_dev_ms, reverse=True)[:5]
    phase(f"profile-{label}", f"{steps} steps wall {wall:.2f}ms "
          + (f"device {busy:.2f}ms busy {busy / wall:.3f} idle "
             f"{1 - busy / wall:.3f}; " + "; ".join(
                 f"{e.key[:40]} {_dev_ms(e):.2f}ms x{e.count}" for e in top)
             if busy > 0 else "device time not measured"))


def idle_split(label, sim, steps):
    """Where the card's idle time in run(steps) goes. The idle (wall minus
    device busy, torch.profiler) of run(steps) and of run(2*steps) split
    it into a part per run (its start and end: the state copy, the first
    launches, the final copy of the trace) and a part in the step loop.
    Per rebin and per plain step (kick, drift, noev force, kick; on a copy
    of the state) the host's time to issue it (host_us) against the
    card's busy time: the loop waits on the host where an interval's
    host time exceeds its card time."""
    sim.run(steps)
    wa, ba, _ = profiled(lambda: sim.run(steps))
    wb, bb, _ = profiled(lambda: sim.run(2 * steps))
    ia, ib = wa - ba, wb - bb
    x, v, typ = (sim.state.x.clone(), sim.state.v.clone(),
                 sim.state.typ.clone())
    dt, dtf = sim.inp.dt, sim.dtforce
    f = sim.force_fn_noev(x, typ)[0]

    def step():
        v.add_(f, alpha=dtf)
        x.add_(v, alpha=dt)
        v.add_(sim.force_fn_noev(x, typ)[0], alpha=dtf)

    def rebin():
        sim.rebin_fn(x, v, typ)

    per = {}
    for name, fn, n in (("rebin", rebin, 10), ("step", step, 40)):
        host = host_us(fn, n)
        _, busy, _ = profiled(lambda: [fn() for _ in range(n)])
        per[name] = (host, busy / n * 1e3)
    every = sim.inp.neigh_every
    host_iv = (every * per["step"][0] + per["rebin"][0]) / 1e3
    card_iv = (every * per["step"][1] + per["rebin"][1]) / 1e3
    got = {"idle_ms": ia, "idle_2x_ms": ib, "per_run_ms": 2 * ia - ib,
           "loop_ms": ib - ia, "rebin_us": per["rebin"],
           "step_us": per["step"], "interval_ms": (host_iv, card_iv)}
    phase(f"idle-split-{label}", f"idle of run({steps}) {ia:.2f}ms, of "
          f"run({2 * steps}) {ib:.2f}ms: {got['per_run_ms']:.2f}ms per run "
          f"(start and end) + {got['loop_ms']:.2f}ms per {steps} steps of "
          "the loop; " + " ".join(
              f"per {k}: host {h:.1f}us card {d:.1f}us;" for k, (h, d)
              in per.items()) + f" per interval of {every} steps: host "
          f"{host_iv:.3f}ms card {card_iv:.3f}ms")
    return got


def rates_in_turns(label, sims, steps):
    """Matom-steps/s of two Simulations timed in turns a, b, b, a (each a
    warm run and a timed run): {name: (first, second)}."""
    a, b = sims
    got = {name: [] for name in sims}
    for name in (a, b, b, a):
        _, ms, rate = timed_run(sims[name], steps)
        got[name].append(rate)
        phase(f"rate-{label}", f"{name}: {steps} steps {ms:.1f}ms = "
              f"{rate:.3f} Matom-steps/s")
    for name, sim in sims.items():
        if sim.state.overflow or sim._regrows:
            raise AssertionError(f"{label} {name}: timed runs regrew or "
                                 "overflowed")
    return got


def micro_phase():
    """The FMA and copy probes (minimd_torch/micro.py, csrc/micro.cu):
    both kernels against their plain versions; then the probes' own main
    path, exp_micro.py's timing loop at the TPU's rep counts, with the launches
    counted over exactly that run; the copy slope again on a 256 MB array,
    4x the L2 less likely to hold it; kernel, plain and torch.add times.
    Returns (kernels' JSON rows, pins)."""
    import torch

    from minimd_torch import micro

    xf, xc = micro.probe_inputs("cuda")
    err = {}
    for reps, tol in FMA_ATOL.items():
        err[reps] = (micro.fma_chain(xf, reps)
                     - micro.fma_chain_plain(xf, reps)).abs().max().item()
    same = torch.equal(micro.copy_add(xc, 2), micro.copy_add_plain(xc, 2))
    torch.cuda.synchronize()
    ok = same and all(err[r] <= tol for r, tol in FMA_ATOL.items())
    phase("compare", "fma_chain (16384, 128) " + " ".join(
        f"reps={r}: max|dy|={e:.3e} (tol {FMA_ATOL[r]:g})"
        for r, e in err.items()) + f"; copy_add (131072, 128) reps=2 "
        f"bit-identical={same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a micro-probe kernel disagrees with its plain "
                             "version")

    reset_counters()
    pins = micro.measure("cuda")       # prints exp_micro.py's two lines
    launches = {k: n for k, n in counters().items() if n}
    big = torch.rand((4 * micro.CB * micro.SUB, micro.LANE), device="cuda")
    s_big = micro.slope(micro.copy_add, 100, 400, big)
    pins["copy_gbps_256mb"] = 2 * big.numel() * 4 / s_big / 1e9
    del big
    want = {"fma_chain": 12, "copy_add": 12}
    phase("micro", f"fma {pins['fma_us_per_rep']:.3f} us/rep = "
          f"{pins['fma_gops']:.1f} GFMA/s ({pins['fma_peak_share']:.4f} of "
          f"33.5 TFMA/s); copy {pins['copy_us_per_rep']:.3f} us/rep = "
          f"{pins['copy_gbps']:.1f} GB/s ({pins['copy_peak_share']:.4f} of "
          f"3.35 TB/s), 256 MB array {pins['copy_gbps_256mb']:.1f} GB/s; "
          f"launches={launches}")
    if not (launches == want and pins["fma_peak_share"] < 1.0
            and 0 < pins["copy_gbps"] and 0 < pins["fma_gops"]):
        raise AssertionError(f"micro: launches {launches} != {want} or a "
                             "rate out of range")

    n, nc = xf.numel(), xc.numel()
    y = torch.empty_like(xc)
    t = {"fma": cuda_ms(lambda: micro.fma_chain(xf, 100), 20),
         "fma_plain": cuda_ms(lambda: micro.fma_chain_plain(xf, 100), 2),
         "copy": cuda_ms(lambda: micro.copy_add(xc, 1), 50),
         "copy_plain": cuda_ms(lambda: micro.copy_add_plain(xc, 1), 50),
         "copy_library": cuda_ms(lambda: torch.add(xc, 1.0, out=y), 50)}
    # an FMA counts 2 operations; one add per element of the sweep
    t["fma_bound"] = bound(8 * n, 2 * micro.DEPTH * 100 * n)
    t["copy_bound"] = bound(8 * nc, nc)
    phase("kernel-time", "micro fma_chain reps=100, copy_add one sweep: "
          + " ".join(f"{k}={v:.4f}ms" if isinstance(v, float) else
                     f"{k}={v[0]:.5f}ms({v[1]})" for k, v in t.items()))
    rows = [
        {"name": "fma_chain", "route": "cuda",
         "source": "minimd_torch/csrc/micro.cu",
         "replaces": "scripts/exp_micro.py:61",
         "launches": launches["fma_chain"], "max_abs_err": max(err.values()),
         "ms": t["fma"], "plain_ms": t["fma_plain"],
         "bound_ms": t["fma_bound"][0], "bound_by": t["fma_bound"][1],
         "library_ms": None, "shape": "(16384, 128) f32, reps=100"},
        {"name": "copy_add", "route": "cuda",
         "source": "minimd_torch/csrc/micro.cu",
         "replaces": "scripts/exp_micro.py:84",
         "launches": launches["copy_add"], "max_abs_err": 0.0,
         "ms": t["copy"], "plain_ms": t["copy_plain"],
         "bound_ms": t["copy_bound"][0], "bound_by": t["copy_bound"][1],
         "library_ms": t["copy_library"],
         "shape": "(131072, 128) f32, one sweep"},
    ]
    return rows, pins


def _row_close(got, want, floor=0.0):
    """Largest |got - want| / max(|want|, floor) over T, U, P."""
    return max(abs(g - w) / max(abs(w), floor)
               for g, w in zip(got[1:], want[1:]))


def half_path(label, deck, gn, full_rows, steps=100):
    """The half-neighbor path at full width on a shipped deck: run(steps)
    with the launches counted, step 0 and the last row held against the
    full path's rows from the same start, atoms kept, the rate, peak
    memory and the time per force. Returns its numbers."""
    import numpy as np
    import torch

    from minimd_torch.config import parse_deck
    from minimd_torch.output import lost_atom_check
    from minimd_torch.sim import Simulation

    inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim = Simulation.from_input(inp, device="cuda", half_neigh=True,
                                ghost_newton=gn)
    reset_counters()
    trace = sim.run(steps)
    launches = {k: n for k, n in counters().items() if n}
    wall = time.time() - t0
    rows = sim.thermo_trace(trace)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lost = lost_atom_check(sim)
    x, typ = sim.state.x, sim.state.typ
    f_ms = cuda_ms(lambda: sim.force_fn_noev(x, typ), 5)
    f_ev_ms = cuda_ms(lambda: sim.force_fn(x, typ), 5)
    _, ms, rate = timed_run(sim, steps)
    d0 = _row_close(rows[0], full_rows[0])
    d1 = _row_close(rows[1], full_rows[1], floor=1.0)
    want = {"rebin_pull": steps // inp.neigh_every}
    ok = (d0 <= HALF_STEP0_RTOL[deck] and d1 <= HALF_STEPN_RTOL
          and rows[0][1] == full_rows[0][1] and launches == want
          and [r[0] for r in rows] == [0, steps] == [r[0] for r in
                                                     full_rows[:2]]
          and sim.state.overflow == 0 and sim._regrows == 0 and lost == 0
          and bool(np.isfinite(trace).all()))
    phase(label, f"natoms={sim.natoms} nb={sim.geom.nb} C={sim.geom.capacity}"
          f" gn={int(gn)} {steps} steps in {wall:.1f}s (setup included) "
          f"rows={rows} full={full_rows[:2]} step0 max rel={d0:.3e} (tol "
          f"{HALF_STEP0_RTOL[deck]:g}) step{steps} max rel={d1:.3e} (tol "
          f"{HALF_STEPN_RTOL:g}) launches={launches} overflow="
          f"{sim.state.overflow} lost={lost}; force {f_ms:.3f}ms (ev "
          f"{f_ev_ms:.3f}ms); run({steps}) {ms:.1f}ms = {rate:.3f} "
          f"Matom-steps/s; peak {peak:.2f}GiB -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the half path failed its checks")
    return {"rate": rate, "force_ms": f_ms, "force_ev_ms": f_ev_ms,
            "peak_gib": peak, "rows": rows}


def cli_phase(label, deck, argv, workdir):
    """cli.main on a shipped deck at full width (in workdir, where the YAML
    goes): PERF_SUMMARY's t_force and t_neigh above 0, the YAML's
    lost_atoms: 0, and the rows equal to run()'s on the same deck."""
    import contextlib
    import io
    import os

    from minimd_torch import cli
    from minimd_torch.config import parse_deck
    from minimd_torch.sim import Simulation

    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        reset_counters()
        with contextlib.redirect_stdout(buf):
            sim, rows = cli.main(["-i", str(REPO / f"inputs/in.{deck}.miniMD"),
                                  *argv])
        launches = {k: n for k, n in counters().items() if n}
    finally:
        os.chdir(cwd)
    out = buf.getvalue().splitlines()
    perf = next(ln for ln in out if "PERF_SUMMARY" in ln
                and not ln.startswith("#")).split()
    t_total, t_force, t_neigh = (float(v) for v in perf[4:7])
    yaml_ok = True
    if "-o" in argv:
        path = next(ln for ln in out if ln.startswith("# YAML report: "))
        text = (pathlib.Path(workdir) / path.split(": ", 1)[1]).read_text()
        yaml_ok = "lost_atoms: 0" in text.splitlines()
    ref = Simulation.from_input(parse_deck(REPO / f"inputs/in.{deck}.miniMD"),
                                device="cuda")
    ref_rows = ref.thermo_trace(ref.run())
    same = rows == ref_rows
    ok = (t_force > 0 and t_neigh > 0 and yaml_ok and same
          and "# WARNING" not in buf.getvalue())
    phase(label, f"{' '.join(argv)}: t_total={t_total:.4f}s "
          f"t_force={t_force:.4f}s t_neigh={t_neigh:.4f}s yaml lost_atoms 0="
          f"{yaml_ok} rows={rows} equal to run()'s={same} "
          f"launches={launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the CLI run failed its checks")
    return launches


def cli_envelope_phase(label, deck, argv, want_launches, force_module):
    """cli.main on a shipped deck at -s 10 outside the kernels' envelope
    (argv: --precision 2, or -b 12 for a stencil reach of 2): the force
    closures from force_module (the JAX package's choice on its
    accelerator), exactly the want_launches kernel launches, and the rows
    at steps 0 and 100 against tests/golden/4k.<deck> (precision 8 in
    float64, 4 in float32)."""
    import contextlib
    import io

    import torch

    from minimd_torch import cli
    from minimd_torch.validate import compare_traces, parse_golden

    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        sim, rows = cli.main(["-i", str(REPO / f"inputs/in.{deck}.miniMD"),
                              "-s", "10", "-n", "100", *argv])
    launches = {k: n for k, n in counters().items() if n}
    golden = parse_golden(REPO / f"tests/golden/4k.{deck}").rows
    f64 = "--precision" in argv
    res = compare_traces(rows, golden, natoms=4000, system=deck,
                         precision=8 if f64 else 4)
    module = sim.force_fn.__module__
    ok = (res.passed and res.nsteps == 2 and launches == want_launches
          and module == force_module and sim.state.overflow == 0
          and (sim.dtype == torch.float64) == f64
          and "# WARNING" not in buf.getvalue())
    phase(label, f"{' '.join(argv)}: nb={sim.geom.nb} C={sim.geom.capacity}"
          f" {sim.dtype} force {module} rows={rows} {res} launches="
          f"{launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the CLI run outside the kernels' "
                             "envelope failed its checks")


def checkpoint_phase(workdir, steps=100):
    """Save the LJ deck at 131k after `steps`, resume it, run `steps` more
    and hold the rows against the uninterrupted run's
    (tests/test_checkpoint.py:11-31, in f32)."""
    from minimd_torch import checkpoint
    from minimd_torch.config import parse_deck
    from minimd_torch.sim import Simulation

    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    sim = Simulation.from_input(inp, device="cuda")
    sim.run(steps)
    path = pathlib.Path(workdir) / "ck.npz"
    checkpoint.save(path, sim, step=steps)
    orig = sim.thermo_trace(sim.run(steps))
    res, step = checkpoint.resume(path, device="cuda")
    rows = res.thermo_trace(res.run(steps))
    d = _row_close(rows[1], orig[1], floor=1.0)
    ok = (step == steps and rows[0] == orig[0] and res.natoms == sim.natoms
          and d <= CHECKPOINT_RTOL and res.state.overflow == 0
          and int(res.state.valid.sum()) == res.natoms)
    phase("checkpoint-131k", f"saved at step {step} ({path.stat().st_size} "
          f"bytes), resumed {steps} steps: rows={rows} uninterrupted="
          f"{orig} max rel={d:.3e} (tol {CHECKPOINT_RTOL:g}) provenance "
          f"kept={rows[0] == orig[0]} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("checkpoint-131k: the resumed run failed its "
                             "checks")


# ----------------------------------------------------------------------
# the decomposed run (minimd_torch/parallel): the sharded kernel forms
# ----------------------------------------------------------------------

# the 131k lattices split over one card's domains: (px, py, pz)
SHARD_SPLITS = {"222": (2, 2, 2), "421": (4, 2, 1)}


@functools.lru_cache(maxsize=4)
def sharded_lattice(deck, grid, s=32):
    """The deck's lattice of size s (perturbed, rebinned, f32 on the card)
    on a grid that the mesh (px, py, pz) divides, as ShardedSimulation
    picks it, and its domains: (inp, geom, x, st, mesh, router, nb_local,
    ShardedState). Cached: the callers read it and change none of it."""
    import numpy as np
    import torch

    from minimd_torch import cells
    from minimd_torch.parallel import mesh as pmesh
    from minimd_torch.parallel import step as pstep
    from minimd_torch.state import sharded_from_grid

    inp, (prd, x_np, _, _, _) = _setup(deck, s)
    nb = cells.autotune_grid(prd, inp.neigh_cut, x_np, solid=deck == "eam",
                             multiple_of=grid)
    _, geom, st, xp = lattice(s, nb, deck=deck,
                              kick=0.12 if deck == "lj" else 0.08)
    x = rebinned(geom, st, xp)
    m = pmesh.make_mesh(["cuda"] * int(np.prod(grid)), prd, grid)
    router = pmesh.Router(m)
    nl = pstep.local_grid_shape(geom, m)
    nbx, nby, nbz = geom.nb
    C = geom.capacity

    def g(t):
        return t.reshape(((3,) if t.dim() == 2 else ()) + (nbz, nby, nbx, C))

    ss = sharded_from_grid(g(x), g(st.v), g(torch.zeros_like(x)), g(st.typ),
                           g(cells.is_valid(x)), m, geom)
    return inp, geom, x, st, m, router, nl, ss


def _gather(parts, m, geom, what=2):
    """Per-domain (Dg, 3, M_local) or (Dg, M_local) tensors as one global
    (3, M) or (M,) CUDA tensor in the global cell layout."""
    import torch

    from minimd_torch.state import ShardedState, sharded_to_grid

    vec = parts[0].dim() == 3
    ss = ShardedState(*([parts] * 5))
    g = torch.from_numpy(sharded_to_grid(ss, m, geom)[what])
    return g.reshape((3, -1) if vec else (-1,)).cuda()


def compare_sharded(deck, label, grid, timing=False):
    """The sharded pair kernels on every domain of a split 131k lattice:
    per atom bit for bit the one-device kernel on the same cells, and
    against their plain versions (lj_pair_loop / the padded EAM passes on
    the kernels' padded input, on the card) within the one-device
    tolerances. With timing: one domain's ms per call, its plain ms and
    its bound, at this split. Returns ({kernel: max|err|}, times)."""
    import torch

    from minimd_torch.ops import eam_cuda, eam_grid
    from minimd_torch.ops.eam import EAMTables
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.pairgrid import plain_padded
    from minimd_torch.ops.lj_grid import lj_pair_loop
    from minimd_torch.parallel import step as pstep

    inp, geom, x, st, m, router, nl, ss = sharded_lattice(deck, grid)
    dec = m.decomposed
    kh = pstep.Halo(geom, m, router, 1, nl, torch.float32, wrap=False)
    xk = router.split(kh.positions(ss.x))
    D = m.size
    Ml = ss.x[0].shape[-1]
    err, t = {}, {}
    if timing:   # every domain's halo, one gather and one add
        t[f"halo_{deck}_ms"] = cuda_ms(lambda: kh.positions(ss.x), 50)
    if deck == "lj":
        params = lj_params(inp)
        f1, e1, w1 = make_lj_force_cuda(geom, params)[0](x, st.typ)
        k_ev, k_noev = make_lj_force_cuda(geom, params, nb_local=nl,
                                          decomposed=dec)
        X = kh.positions(ss.x)[0]          # (D, 3, stored), one group
        fs, es, ws = k_ev(X, None)
        outs = list(fs)
        same = torch.equal(_gather([fs], m, geom), f1)
        noev_same = torch.equal(k_noev(X, None)[0], fs)
        e, w = float(es.sum()), float(ws.sum())
        e_rel = abs(e - float(e1)) / abs(float(e1))
        w_rel = abs(w - float(w1)) / abs(float(w1))

        def plain(k, evflag=True):
            fg, pe, pw = lj_pair_loop(plain_padded(geom, nl, dec, xk[k]),
                                      None, geom, params, torch.float32,
                                      evflag, nb_local=nl)
            return torch.stack([a.reshape(Ml) for a in fg]), pe, pw

        perr = scale = 0.0
        for k in range(D):
            fp_, _, _ = plain(k)
            perr = max(perr, (fp_ - outs[k]).abs().max().item())
            scale = max(scale, fp_.abs().max().item())
        err["lj_force_sharded"] = perr
        ok = (same and noev_same and perr / scale < F_TOL
              and e_rel < 1e-5 and w_rel < 1e-5)
        phase("compare", f"lj_force_sharded {label} mesh={grid} "
              f"nb={geom.nb} local={nl} C={geom.capacity}: per-atom "
              f"bit-identical to the one-device kernel={same} "
              f"noev={noev_same} eng_rel={e_rel:.2e} vir_rel={w_rel:.2e}; "
              f"vs plain max|df|/max|f|={perr / scale:.3e} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sharded LJ kernel disagrees at {label}")
        if timing:
            n_cut, _ = count_pairs(geom, x, inp.force_cut)
            M_in = xk[0].shape[-1]
            # every domain in one launch; per domain: / D
            t["lj_force_sharded"] = cuda_ms(lambda: k_noev(X, None), 50)
            t["lj_force_sharded_plain"] = cuda_ms(
                lambda: [plain(k, False) for k in range(D)], 2)
            t["lj_force_sharded_bound"] = bound(
                D * (12 * M_in + 12 * Ml), n_cut * _LJ_PAIR_OPS)
        return err, t

    tables = EAMTables.from_funcfl()
    r1, fp1, _ = eam_cuda.make_eam_rho_cuda(geom, tables)(x, True)
    f1, e1, w1 = eam_cuda.make_eam_pair_cuda(geom, tables)(x, fp1, True)
    k_rho = eam_cuda.make_eam_rho_cuda(geom, tables, nb_local=nl,
                                       decomposed=dec)
    k_pair = eam_cuda.make_eam_pair_cuda(geom, tables, nb_local=nl,
                                         decomposed=dec)
    X = kh.positions(ss.x)[0]              # (D, 3, stored), one group
    rho_b, fp_b, _ = k_rho(X, True)
    FP = kh.scalars([fp_b])[0]             # the fp halo
    fp_pad = list(FP)
    f_b, p_b, w_b = k_pair(X, FP, True)
    rhos = [(rho_b[k], fp_b[k]) for k in range(D)]
    pairs = [(f_b[k],) for k in range(D)]
    same = {"rho": torch.equal(_gather([rho_b], m, geom), r1),
            "fp": torch.equal(_gather([fp_b], m, geom), fp1),
            "f": torch.equal(_gather([f_b], m, geom), f1)}
    e_rel = abs(float(p_b.sum()) - float(e1)) / abs(float(e1))
    w_rel = abs(float(w_b.sum()) - float(w1)) / abs(float(w1))
    p_rho = eam_grid.make_eam_rho_grid(geom, tables, device="cuda",
                                       nb_local=nl, padded=True)
    p_pair = eam_grid.make_eam_pair_grid(geom, tables, device="cuda",
                                         nb_local=nl, padded=True)

    def plain_rho(k, evflag=True):
        Xp = plain_padded(geom, nl, dec, xk[k])
        return p_rho(Xp, eam_cuda._interior_valid(geom, nl, Xp), evflag)

    def plain_pair(k, evflag=True):
        return p_pair(plain_padded(geom, nl, dec, xk[k]),
                      plain_padded(geom, nl, dec, fp_pad[k], coord=False),
                      evflag)

    rerr = rscale = ferr = fscale = 0.0
    for k in range(D):
        rp = plain_rho(k)[0]
        fpl = plain_pair(k)[0]
        rerr = max(rerr, (rp - rhos[k][0]).abs().max().item())
        rscale = max(rscale, rp.abs().max().item())
        ferr = max(ferr, (fpl - pairs[k][0]).abs().max().item())
        fscale = max(fscale, fpl.abs().max().item())
    err["eam_rho_sharded"], err["eam_force_sharded"] = rerr, ferr
    ok = (all(same.values()) and rerr / rscale <= RHO_TOL
          and ferr / fscale <= F_TOL and e_rel < 1e-5 and w_rel < 1e-4)
    phase("compare", f"eam_sharded {label} mesh={grid} nb={geom.nb} "
          f"local={nl} C={geom.capacity}: per-atom bit-identical to the "
          f"one-device kernels {same} P_rel={e_rel:.2e} "
          f"vir_rel={w_rel:.2e}; vs plain rho rel={rerr / rscale:.3e} "
          f"max|df|/max|f|={ferr / fscale:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sharded EAM kernels disagree at {label}")
    if timing:
        polys = tables.polys
        n_cut, n_body = count_pairs(geom, x, tables.cut, polys.split)
        M_in = xk[0].shape[-1]
        t["eam_rho_sharded"] = cuda_ms(lambda: k_rho(X, False), 50)
        t["eam_rho_sharded_plain"] = cuda_ms(
            lambda: [plain_rho(k, False) for k in range(D)], 1)
        t["eam_rho_sharded_bound"] = bound(
            D * 4 * (3 * M_in + 2 * Ml),
            eam_pair_ops(polys, ("R",), n_cut, n_body) + 11 * Ml * D)
        t["eam_force_sharded"] = cuda_ms(lambda: k_pair(X, FP, False), 50)
        t["eam_force_sharded_plain"] = cuda_ms(
            lambda: [plain_pair(k, False) for k in range(D)], 1)
        t["eam_force_sharded_bound"] = bound(
            D * 4 * (3 * M_in + M_in + 3 * Ml),
            eam_pair_ops(polys, ("G1", "G2"), n_cut, n_body))
    return err, t


def compare_sharded_rebin(deck, label, grid, teleport=False, timing=False):
    """The migration with the sharded rebin kernels placing the residents
    against the plain exchange_rebin (place_residents), bit for bit: x, v,
    typ, valid and the [movement, capacity, buffer] overflow of every
    domain, on the split lattice with its atoms kicked (many cross the
    domains); teleport: one atom moved two cells inside its domain
    (movement overflow 1)."""
    import torch

    from minimd_torch.parallel import comm

    inp, geom, x, st, m, router, nl, ss = sharded_lattice(deck, grid)
    rng = torch.Generator(device="cuda").manual_seed(5)
    xs = [t + (torch.rand(t.shape, generator=rng, device="cuda") - 0.5)
          * 0.8 * (t[:, :1] < 5e5) for t in ss.x]
    if teleport:
        # an atom of cell (3, 0, 0) of domain 0 moved to cell (5, 0, 0)
        C = geom.capacity
        v0 = 3 * C + int(ss.valid[0][0, 3 * C:4 * C].nonzero()[0, 0])
        xs[0][0, 0, v0] += 2.0 * geom.binsize[0]
    res = {}
    for form in ("plain", "kernel", "graph"):
        ex = comm.make_exchange_rebin(geom, m, router, nl, torch.float32,
                                      kernel=form != "plain",
                                      graph=form == "graph")
        for _ in range(2 if form == "graph" else 1):  # capture, replay
            res[form] = ex([t.clone() for t in xs], ss.v, ss.typ, ss.valid)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for form in ("kernel", "graph")
               for i in range(5)
               for a, b in zip(res[form][i], res["plain"][i]))
    ovf = router.domain_sum(res["graph"][4]).tolist()
    kept = int(sum(int(t.sum()) for t in res["graph"][3]))
    phase("compare", f"rebin_sharded {label} mesh={grid} nb={geom.nb} "
          f"local={nl} C={geom.capacity}: kernels and their CUDA graph "
          f"bit-identical to the plain exchange_rebin={same} overflow "
          f"[move, cap, buf]={ovf} atoms={kept}/{int(st.valid.sum())}")
    if not (same and ovf == [int(teleport), 0, 0]):
        raise AssertionError(f"sharded rebin differs from the plain "
                             f"exchange_rebin (or the overflow is wrong) "
                             f"at {label}")
    t = {}
    if timing:
        from minimd_torch.ops.rebin_cuda import make_rebin_cuda

        Ml = ss.x[0].shape[-1]
        placer = make_rebin_cuda(geom, "cuda", nb_local=nl,
                                 decomposed=m.decomposed)
        from minimd_torch.parallel.comm import (dead_pads, domain_sentinels,
                                                place_residents)
        xr = xs[0][0].contiguous()
        vr, tr = ss.v[0][0], ss.typ[0][0]
        o = tuple(0 for _ in range(3))
        t["rebin_sharded"] = queued_ms(lambda: placer(xr, vr, tr, o, 0), 50)
        sent = domain_sentinels(Ml, 0, torch.float32, "cuda")
        pads = dead_pads(m.decomposed)
        t["rebin_sharded_plain"] = cuda_ms(lambda: place_residents(
            xr, vr, tr, xr[0] < 5e5, geom, nl, o, m.decomposed, pads,
            sent), 3)
        t["rebin_sharded_bound"] = bound(56 * Ml, 0)
        # the whole migration, graphed as a run takes it
        t["migration_ms"] = cuda_ms(lambda: ex(
            [a.clone() for a in xs], ss.v, ss.typ, ss.valid), 5)
        t["migration_host_us"] = host_us(lambda: ex(
            [a.clone() for a in xs], ss.v, ss.typ, ss.valid), 5)
    return t


def sharded_gate(deck, grid=(2, 2, 2), steps=10000):
    """ShardedSimulation on a mesh of one card's domains, 4k/steps f32,
    against tests/golden/4k.<deck> with the reference's criterion, the
    sharded kernels' launches counted over exactly that run."""
    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation
    from minimd_torch.validate import compare_traces, parse_golden

    golden4k = parse_golden(REPO / f"tests/golden/4k.{deck}")
    inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
    inp.nx = inp.ny = inp.nz = 10
    t0 = time.time()
    sim = ShardedSimulation.from_input(inp, devices=["cuda"] * 8)
    reset_counters()
    trace = sim.run(steps)
    launches = {k: n for k, n in counters().items() if n}
    rows = sim.thermo_trace(trace)
    res = compare_traces(rows, golden4k.rows, natoms=4000, system=deck,
                         precision=4)
    need = (("lj_force_sharded",) if deck == "lj" else
            ("eam_rho_sharded", "eam_force_sharded")) + ("rebin_sharded",)
    kept = int(sim.state.valid.sum())
    phase(f"gate-4k-{deck}-sharded", f"mesh={sim.mesh.shape} "
          f"nb={sim.geom.nb} C={sim.geom.capacity} {steps} steps in "
          f"{time.time() - t0:.1f}s: {res}; launches={launches} "
          f"atoms={kept} last={rows[-1]}")
    if not (res.passed and all(launches.get(k, 0) > 0 for k in need)
            and kept == 4000 and len(rows) == steps // 100 + 1):
        raise AssertionError(f"4k/{steps} f32 sharded {deck} gate failed")


def sharded_main_path(deck, s, steps, devices):
    """ShardedSimulation.from_input on the deck at size s over `devices`,
    counters set to 0 after construction, run(steps): (sim, rows,
    nonzero launches, seconds)."""
    import numpy as np

    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation

    inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
    inp.nx = inp.ny = inp.nz = s
    t0 = time.time()
    sim = ShardedSimulation.from_input(inp, devices=devices)
    reset_counters()
    trace = sim.run(steps)
    launches = {k: n for k, n in counters().items() if n}
    rows = sim.thermo_trace(trace)
    kept = int(sim.state.valid.sum())
    phase(f"sharded-{deck}-{s}", f"natoms={sim.natoms} mesh={sim.mesh.shape}"
          f" nb={sim.geom.nb} C={sim.geom.capacity} {steps} steps in "
          f"{time.time() - t0:.1f}s (setup included) launches={launches} "
          f"atoms={kept} rows={rows}")
    if not (bool(np.isfinite(trace).all()) and kept == sim.natoms):
        raise AssertionError(f"sharded {deck} s={s}: the run failed")
    return sim, rows, launches


def sharded_rates(deck, s, steps):
    """Matom-steps/s of Simulation and of ShardedSimulation on one domain
    (the sharded_1chip_ratio of bench.py:117-135) in turns a, b, b, a,
    then of a (2,2,2) mesh on the one card, and its host time per step:
    {name: [rates]}, host_us."""
    import torch

    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation
    from minimd_torch.sim import Simulation

    inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
    inp.nx = inp.ny = inp.nz = s
    sims = {"single": Simulation.from_input(inp, device="cuda"),
            "sharded1": ShardedSimulation.from_input(inp,
                                                     devices=["cuda"])}
    got = {name: [] for name in sims}
    for name in ("single", "sharded1", "sharded1", "single"):
        _, ms, rate = timed_run(sims[name], steps)
        got[name].append(rate)
        phase(f"rate-sharded-{deck}-{s}", f"{name}: {steps} steps "
              f"{ms:.1f}ms = {rate:.3f} Matom-steps/s")
    del sims
    torch.cuda.empty_cache()
    sh1, one = got["sharded1"], got["single"]
    sim8 = ShardedSimulation.from_input(inp, devices=["cuda"] * 8)
    _, ms, rate = timed_run(sim8, steps)
    got["sharded8"] = [rate]
    # the host's time to issue the steps: the run without waiting for the
    # card at the end (its one sync is the trace's)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ovf, trace = sim8.run_fn(sim8.state_.clone(), steps, 0)
    host_us = (time.perf_counter() - t0) / steps * 1e6
    torch.cuda.synchronize()
    phase(f"rate-sharded-{deck}-{s}", f"mesh (2,2,2) on one card "
          f"nb={sim8.geom.nb} local={sim8.nb_local}: {steps} steps "
          f"{ms:.1f}ms = {rate:.3f} Matom-steps/s; host {host_us:.1f} "
          f"us/step; 1-domain/Simulation, adjacent turns "
          f"{[round(a / b, 4) for a, b in zip(sh1, one)]}")
    del sim8
    torch.cuda.empty_cache()
    return got, host_us


def sharded_phases():
    """Every sharded phase; returns (kernel entries, rates, host us per
    step)."""
    t0 = time.time()
    max_err = {}
    times = {}
    for deck in ("lj", "eam"):
        for label, grid in SHARD_SPLITS.items():
            e, t = compare_sharded(deck, f"{deck}-131k-{label}", grid,
                                   timing=label == "222")
            for k, v in e.items():
                max_err[k] = max(max_err.get(k, 0.0), v)
            times.update(t)
            times.update(compare_sharded_rebin(
                deck, f"{deck}-131k-{label}", grid, timing=label == "222"
                and deck == "lj"))
    compare_sharded_rebin("lj", "lj-131k-222-teleporter", (2, 2, 2),
                          teleport=True)
    max_err["rebin_sharded"] = 0.0
    phase("kernel-time", "sharded 131k (2,2,2), the pair kernels' 8 domains "
          "in one launch, the rebin's one domain: " + " ".join(
        f"{k}={v:.1f}" if k.endswith("_us") else
        f"{k}={v:.4f}ms" if isinstance(v, float) else
        f"{k}={v[0]:.5f}ms({v[1]})" for k, v in times.items()))
    for deck in ("lj", "eam"):
        sharded_gate(deck)
    launches, sharded_rows = {}, {}
    for deck in ("lj", "eam"):
        _, sharded_rows[deck], got = sharded_main_path(deck, 32, 100,
                                                       ["cuda"] * 8)
        launches.update(got)
    rates, host = {}, {}
    for deck in ("lj", "eam"):
        for s, steps in ((32, 100), (60, 50)):
            got, h = sharded_rates(deck, s, steps)
            for name, r in got.items():
                rates[f"{deck}_{name}_{'131k' if s == 32 else '864k'}"] = r
            host[f"{deck}_{'131k' if s == 32 else '864k'}"] = h

    def entry(name, source, replaces, **extra):
        b = times[f"{name}_bound"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **extra,
                "launches": launches.get(name, 0),
                "max_abs_err": max_err[name], "ms": times[name],
                "plain_ms": times[f"{name}_plain"], "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None,
                "shape": ("131k (2,2,2), noev: the 8 domains in one launch"
                          if name != "rebin_sharded" else
                          "131k (2,2,2): one domain's residents")}

    kernels = [
        entry("lj_force_sharded", "minimd_torch/csrc/lj_force.cu",
              "minimd_tpu/ops/lj_pallas.py:69",
              also_source="minimd_torch/csrc/cellgrid.cuh"),
        entry("eam_rho_sharded", "minimd_torch/csrc/eam_force.cu",
              "minimd_tpu/ops/eam_pallas.py:457"),
        entry("eam_force_sharded", "minimd_torch/csrc/eam_force.cu",
              "minimd_tpu/ops/eam_pallas.py:478"),
        entry("rebin_sharded", "minimd_torch/csrc/rebin.cu",
              "minimd_tpu/ops/rebin_pallas.py:49",
              launches_per_call=["rebin_bin", "rebin_gather"],
              migration_ms=times["migration_ms"]),
    ]
    sharded_lattice.cache_clear()
    phase("sharded-wall", f"phase 12 took {time.time() - t0:.1f}s")
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"the sharded main paths launched no {missing}")
    return kernels, rates, host, sharded_rows


# ----------------------------------------------------------------------
# the decomposed run's half paths and surface (phase 13)
# ----------------------------------------------------------------------

SHARDED_HALF = (("half-sharded-lj", "lj", True),
                ("half-sharded-lj-gn0", "lj", False),
                ("half-sharded-eam", "eam", True))


def cli_sharded_phase(label, deck, one_rows, workdir):
    """cli.main --devices 8 --timed -o 1 on a shipped deck at 131k (its 100
    steps), the 8 domains on this card: the rows within the half phase's
    tolerances of the one-device run's, lost_atoms 0 (audit and YAML),
    the per-device statistics in the YAML, the three phase times above 0
    and at most t_total together, and the sharded kernels launched in the
    run. Returns its numbers."""
    import contextlib
    import io
    import os

    from minimd_torch import cli
    from minimd_torch.output import lost_atom_check

    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        reset_counters()
        with contextlib.redirect_stdout(buf):
            ssim, rows = cli.main(["-i", str(REPO / f"inputs/in.{deck}.miniMD"),
                                   "--devices", "8", "--timed", "-o", "1"])
        launches = {k: n for k, n in counters().items() if n}
        out = buf.getvalue().splitlines()
        path = next(ln for ln in out if ln.startswith("# YAML report: "))
        text = (pathlib.Path(workdir) / path.split(": ", 1)[1]).read_text()
    finally:
        os.chdir(cwd)
    perf = next(ln for ln in out if "PERF_SUMMARY" in ln
                and not ln.startswith("#")).split()
    t_total, t_force, t_neigh, t_comm = (float(perf[k]) for k in (4, 5, 6, 7))
    lines = text.splitlines()
    yaml_ok = ("lost_atoms: 0" in lines and "  mpi_processes: 8" in lines
               and all(f"  {k}:" in lines for k in (
                   "atoms_per_device", "swap_atoms_x_per_device",
                   "time_comm_per_device", "time_neigh_intervals")))
    need = (("lj_force_sharded",) if deck == "lj" else
            ("eam_rho_sharded", "eam_force_sharded")) + ("rebin_sharded",)
    d0 = _row_close(rows[0], one_rows[0])
    d1 = _row_close(rows[1], one_rows[1], floor=1.0)
    lost = lost_atom_check(ssim)
    intervals = [tuple(round(t * 1e3, 3) for t in iv)
                 for iv in ssim.interval_stamps]
    ok = (perf[:4] == ["8", "1", "100", str(ssim.natoms)]
          and min(t_force, t_neigh, t_comm) > 0
          and t_force + t_neigh + t_comm <= t_total and yaml_ok
          and lost == 0 and all(launches.get(k, 0) > 0 for k in need)
          and [r[0] for r in rows] == [0, 100] == [r[0] for r in one_rows[:2]]
          and d0 <= HALF_STEP0_RTOL[deck] and d1 <= HALF_STEPN_RTOL
          and len(ssim.interval_stamps) == 5
          and "# WARNING" not in buf.getvalue())
    phase(label, f"--devices 8 --timed -o 1: mesh={ssim.mesh.shape} "
          f"nb={ssim.geom.nb} C={ssim.geom.capacity} devices="
          f"{sorted(set(ssim.devices))} t_total={t_total:.4f}s t_force="
          f"{t_force:.4f}s t_comm={t_comm:.4f}s t_neigh={t_neigh:.4f}s "
          f"per interval (force, comm, neigh) ms={intervals} "
          f"perf={float(perf[9]) / 1e6:.3f} Matom-steps/s (timed, a sync at "
          f"each stamp) rows={rows} one-device={one_rows[:2]} step0 max "
          f"rel={d0:.3e} step100 max rel={d1:.3e} lost={lost} yaml ok="
          f"{yaml_ok} launches={launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the decomposed CLI run failed its "
                             "checks")
    return {"t_total": t_total, "t_force": t_force, "t_comm": t_comm,
            "t_neigh": t_neigh, "rate_timed": float(perf[9]) / 1e6,
            "interval_ms": intervals, "launches": launches}


def half_sharded_phase(label, deck, gn, sharded_rows, one_half):
    """ShardedSimulation(half_neigh=True) on the deck at 131k, (2,2,2) on
    this card, run(100) with the launches counted (the migration's
    sharded rebin only: the half force is plain torch, as the JAX
    package's sharded half path is XLA): rows against the decomposed full
    path's and the one-device half path's, every atom kept, the rate
    (after a warm run) and the peak memory. Returns its numbers."""
    import numpy as np
    import torch

    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation

    inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim = ShardedSimulation.from_input(inp, devices=["cuda"] * 8,
                                       half_neigh=True, ghost_newton=gn)
    start = sim.state_.clone()
    reset_counters()
    trace = sim.run(100)
    launches = {k: n for k, n in counters().items() if n}
    wall = time.time() - t0
    rows = sim.thermo_trace(trace)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the folds sum each slot's images in a fixed order: a repeat of the
    # run gives the same bits
    end = sim.state_
    sim.state_ = start
    repeat = bool(np.array_equal(sim.run(100), trace)) and all(
        torch.equal(a, b) for a, b in zip(sim.state_.x, end.x))
    _, ms, rate = timed_run(sim, 100)
    d_full = [_row_close(rows[0], sharded_rows[0]),
              _row_close(rows[1], sharded_rows[1], floor=1.0)]
    d_one = [_row_close(rows[0], one_half[0]),
             _row_close(rows[1], one_half[1], floor=1.0)]
    kept = int(sim.state.valid.sum())
    ok = (list(launches) == ["rebin_sharded"] and kept == sim.natoms
          and bool(np.isfinite(trace).all()) and repeat
          and [r[0] for r in rows] == [0, 100]
          and max(d_full[0], d_one[0]) <= HALF_STEP0_RTOL[deck]
          and max(d_full[1], d_one[1]) <= HALF_STEPN_RTOL)
    phase(label, f"natoms={sim.natoms} mesh={sim.mesh.shape} nb="
          f"{sim.geom.nb} local={sim.nb_local} C={sim.geom.capacity} "
          f"gn={int(gn)} 100 steps in {wall:.1f}s (setup included) rows="
          f"{rows} sharded full={sharded_rows[:2]} max rel step0/100="
          f"{d_full[0]:.3e}/{d_full[1]:.3e}; one-device half={one_half[:2]}"
          f" {d_one[0]:.3e}/{d_one[1]:.3e} launches={launches} atoms={kept}"
          f" repeat bit for bit={repeat}; run(100) {ms:.1f}ms = {rate:.3f} Matom-steps/s; peak "
          f"{peak:.2f}GiB -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the sharded half path failed its "
                             "checks")
    return {"rate": rate, "peak_gib": peak, "ms_100": ms}


def sharded_half_gate(steps=10000):
    """The 4k/steps f32 LJ gate of the sharded half path (gn=1) on (2,2,2)
    of this card against tests/golden/4k.lj with the reference's
    criterion (precision 4)."""
    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation
    from minimd_torch.validate import compare_traces, parse_golden

    golden4k = parse_golden(REPO / "tests/golden/4k.lj")
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = 10
    t0 = time.time()
    sim = ShardedSimulation.from_input(inp, devices=["cuda"] * 8,
                                       half_neigh=True)
    rows = sim.thermo_trace(sim.run(steps))
    res = compare_traces(rows, golden4k.rows, natoms=4000, system="lj",
                         precision=4)
    kept = int(sim.state.valid.sum())
    secs = time.time() - t0
    phase("gate-sharded-half", f"LJ gn=1 mesh={sim.mesh.shape} nb="
          f"{sim.geom.nb} C={sim.geom.capacity} {steps} steps in "
          f"{secs:.1f}s: {res}; atoms={kept} last={rows[-1]}")
    if not (res.passed and kept == 4000 and len(rows) == steps // 100 + 1):
        raise AssertionError(f"4k/{steps} f32 sharded half LJ gate failed")
    return {"passed": True, "seconds": secs, "result": str(res)}


def resume_sharded_phase(workdir, steps=50):
    """ShardedSimulation of the LJ deck at 131k on (2,2,2): save at step
    `steps`, checkpoint.resume_sharded, `steps` more, against the
    uninterrupted run (CHECKPOINT_RTOL), the step-0 row kept."""
    from minimd_torch import checkpoint
    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation

    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    sim = ShardedSimulation.from_input(inp, devices=["cuda"] * 8)
    sim.run(steps)
    path = pathlib.Path(workdir) / "ck_sharded.npz"
    checkpoint.save(path, sim, step=steps)
    orig = sim.thermo_trace(sim.run(steps))
    res, step = checkpoint.resume_sharded(path, devices=["cuda"] * 8)
    rows = res.thermo_trace(res.run(steps))
    d = _row_close(rows[1], orig[1], floor=1.0)
    ok = (step == steps and rows[0] == orig[0] == sim.row0
          and d <= CHECKPOINT_RTOL and res.natoms == sim.natoms
          and int(res.state.valid.sum()) == res.natoms)
    phase("resume-sharded-131k", f"saved at step {step}, resume_sharded, "
          f"{steps} steps: rows={rows} uninterrupted={orig} max rel="
          f"{d:.3e} (tol {CHECKPOINT_RTOL:g}) row0 kept={rows[0] == orig[0]}"
          f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("resume-sharded-131k: the resumed run failed "
                             "its checks")
    return d


def sharded_surface_phases(full_rows, sharded_rows, half, workdir):
    """Phase 13: the CLI's --devices 8 on both decks, the sharded half
    paths at 131k, the sharded half 4k/10000 gate, resume_sharded and the
    dryrun, on this card. Returns their numbers."""
    import torch

    from minimd_torch.parallel.dryrun import dryrun_multichip

    t0 = time.time()
    out = {}
    for deck in ("lj", "eam"):
        out[f"cli_{deck}"] = cli_sharded_phase(f"cli-sharded-{deck}", deck,
                                               full_rows[deck], workdir)
    torch.cuda.empty_cache()
    one = {"lj": "half-lj-131k", "lj-gn0": "half-lj-gn0-131k",
           "eam": "half-eam-131k"}
    for label, deck, gn in SHARDED_HALF:
        key = deck if gn else "lj-gn0"
        out[label] = half_sharded_phase(label, deck, gn, sharded_rows[deck],
                                        half[one[key]]["rows"])
        torch.cuda.empty_cache()
    out["gate"] = sharded_half_gate()
    out["resume_max_rel"] = resume_sharded_phase(workdir)
    reset_counters()
    dryrun_multichip(8)
    launches = {k: n for k, n in counters().items() if n}
    phase("dryrun", f"dryrun_multichip(8) on {torch.cuda.get_device_name(0)}"
          f": launches={launches}")
    if not (launches.get("lj_force_sharded", 0) > 0
            and launches.get("rebin_sharded", 0) > 0):
        raise AssertionError("dryrun: the sharded kernels did not run")
    phase("sharded-surface-wall", f"phase 13 took {time.time() - t0:.1f}s")
    return out


# ----------------------------------------------------------------------
# past the kernels' capacity; a mesh across the card and the host (14)
# ----------------------------------------------------------------------

def capacity_phases(card_line, steps=40):
    """The 4k LJ and EAM decks at capacity=520, past cells.MAX_CAPACITY,
    f32 on the card, the LJ deck through the fused step, and both decks
    as a (2,2,2) ShardedSimulation on the card's domains: the kernels run
    as at any capacity (each kernel of the path launched, no other),
    `steps` steps (two rebins), step 0 within HALF_STEP0_RTOL and the
    last row within HALF_STEPN_RTOL of the default-capacity card run's
    (the same atoms in the same walk order; the thermo sums run over more
    slots), every atom kept. Returns {label: numbers}."""
    import numpy as np
    import torch

    from minimd_torch.config import parse_deck
    from minimd_torch.parallel import ShardedSimulation
    from minimd_torch.sim import Simulation

    def make(inp, kind, **kw):
        if kind == "sharded":
            return ShardedSimulation.from_input(inp, devices=["cuda"] * 8,
                                                **kw)
        return Simulation.from_input(inp, device="cuda",
                                     fused_step=kind == "fused", **kw)

    out = {}
    for deck, kind, want in (
            ("lj", "", {"lj_force", "rebin_pull"}),
            ("eam", "", {"eam_rho", "eam_force", "rebin_pull"}),
            ("lj", "fused", {"lj_force", "lj_step", "rebin_pull"}),
            ("lj", "sharded", {"lj_force_sharded", "rebin_sharded"}),
            ("eam", "sharded", {"eam_rho_sharded", "eam_force_sharded",
                                "rebin_sharded"})):
        label = f"capacity-520-{deck}{'-' + kind if kind else ''}"
        inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
        inp.nx = inp.ny = inp.nz = 10
        ref = make(inp, kind)
        ref_rows = ref.thermo_trace(ref.run(steps))
        t0 = time.time()
        sim = make(inp, kind, capacity=520)
        reset_counters()
        trace = sim.run(steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: n for k, n in counters().items() if n}
        rows = sim.thermo_trace(trace)
        d0 = _row_close(rows[0], ref_rows[0])
        d1 = _row_close(rows[-1], ref_rows[-1], floor=1.0)
        kept = int(sim.state.valid.sum())
        ok = (set(launches) == want and sim.geom.capacity == 520
              and d0 <= HALF_STEP0_RTOL[deck] and d1 <= HALF_STEPN_RTOL
              and [r[0] for r in rows] == [0, steps]
              == [r[0] for r in ref_rows]
              and bool(np.isfinite(trace).all()) and kept == sim.natoms
              and sim.state.overflow == 0
              and getattr(sim, "_regrows", 0) == 0)
        phase(label, f"natoms={sim.natoms} nb={sim.geom.nb} C=520 against "
              f"C={ref.geom.capacity}: {steps} steps in {wall:.2f}s (setup "
              f"included) rows={rows} ref={ref_rows} step0 max rel="
              f"{d0:.3e} (tol {HALF_STEP0_RTOL[deck]:g}) step{steps} max "
              f"rel={d1:.3e} (tol {HALF_STEPN_RTOL:g}) launches={launches}"
              f" atoms={kept} {card_line} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the run past cells.MAX_CAPACITY "
                                 "failed its checks")
        out[label] = {"wall_s": wall, "step0_max_rel": d0,
                      f"step{steps}_max_rel": d1, "launches": launches,
                      "ref_capacity": ref.geom.capacity}
        del ref, sim
    torch.cuda.empty_cache()
    return out


MIXED_RTOL = 1e-10


def mesh_mixed_phase(card_line, steps=40):
    """A 4k LJ float64 ShardedSimulation on ["cuda:0", "cpu"] * 4: two
    device groups (the x parities), so every step copies between the card
    and the host, through the routes: `steps` steps (two migrations), a
    row every 10, within MIXED_RTOL of the one-group card run's, every
    atom kept. Prints, read from the halo's routes, the elements a step
    ships to each group (the distinct boundary slots, 3 values each)
    beside the whole other group's positions that the copies moved
    before, and the values each group ships back per fold component.
    Returns its numbers."""
    import numpy as np
    import torch

    from minimd_torch.config import parse_deck
    from minimd_torch.ops.pairgrid import halo_extent
    from minimd_torch.parallel import ShardedSimulation
    from minimd_torch.parallel.step import Halo

    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = 10
    inp.thermo_nstat = 10
    one = ShardedSimulation.from_input(inp, devices=["cuda"] * 8,
                                       dtype=torch.float64)
    want = one.thermo_trace(one.run(steps))
    t0 = time.time()
    sim = ShardedSimulation.from_input(inp, devices=["cuda:0", "cpu"] * 4,
                                       dtype=torch.float64)
    reset_counters()
    trace = sim.run(steps)
    wall = time.time() - t0
    launches = {k: n for k, n in counters().items() if n}
    rows = sim.thermo_trace(trace)
    d = max(_row_close(a, b, floor=1.0) for a, b in zip(rows, want))
    groups = sim.router.groups
    geom, D = sim.geom, sim.mesh.size
    halo = Halo(geom, sim.mesh, sim.router, halo_extent(geom), sim.nb_local,
                torch.float64)
    Ml = halo.nlocal
    ship = {str(dev): {"halo_elements": 3 * halo.received(g),
                       "all_n_elements": 3 * (D - len(ks)) * Ml,
                       "fold_values": halo.returned(g)}
            for g, (dev, ks) in enumerate(groups)}
    kept = int(sim.state.valid.sum())
    ok = (len(groups) == 2 and d <= MIXED_RTOL and not launches
          and kept == sim.natoms == 4000 and bool(np.isfinite(trace).all())
          and [r[0] for r in rows] == [r[0] for r in want]
          and all(v["halo_elements"] <= v["all_n_elements"]
                  for v in ship.values()))
    phase("mesh-mixed", f"natoms={sim.natoms} mesh={sim.mesh.shape} nb="
          f"{geom.nb} local={sim.nb_local} C={geom.capacity} groups="
          f"{[(str(dev), ks) for dev, ks in groups]} {steps} steps in "
          f"{wall:.1f}s (setup included) rows max rel={d:.3e} (tol "
          f"{MIXED_RTOL:g}) against the one-group card run; per step and "
          f"group shipped {ship}; launches={launches} atoms={kept} "
          f"{card_line} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mesh-mixed: the two-group run failed its "
                             "checks")
    return {"rows_max_rel": d, "wall_s": wall, "shipped": ship}


# ----------------------------------------------------------------------
# the host runtime, the set-up split, the large sweep, the -f path (15)
# ----------------------------------------------------------------------

def in_turns(fns):
    """Each of two calls twice, in turns (a b b a): ({name: [host s, host
    s]}, {name: its last result})."""
    names = list(fns)
    secs, out = {k: [] for k in names}, {}
    for name in names + names[::-1]:
        t0 = time.perf_counter()
        out[name] = fns[name]()
        secs[name].append(time.perf_counter() - t0)
    return secs, out


def _bits_equal(a, b):
    """Two tuples of arrays (or numbers) equal bit for bit, dtypes too."""
    import numpy as np

    return len(a) == len(b) and all(
        np.asarray(p).dtype == np.asarray(q).dtype
        and np.array_equal(np.asarray(p), np.asarray(q)) for p, q in zip(a, b))


def _secs(v):
    return ",".join(f"{t:.4f}" for t in v)


def native_phase(card_line, path, s=60):
    """The host runtime (csrc/native.cpp through minimd_torch.native)
    against its numpy bodies on the LJ deck at -s s, bit for bit: the type
    stream, the lattice of the whole box and of one sub-box, and the data
    file at path; host seconds of each, native and plain in turns."""
    from minimd_torch import create, lammps_data
    from minimd_torch.config import builtin_deck

    rho = builtin_deck("lj").rho
    box = create.create_box(s, s, s, rho)
    n = 4 * s ** 3
    sub = (0.25 * box.xprd, 0.75 * box.xprd, 0.0, 0.5 * box.yprd,
           0.5 * box.zprd, box.zprd)

    def read(fn):
        b, x, v, mass = fn(path)
        return b.prd, x, v, mass

    cases = {
        "rand_types": (lambda: (create.assign_types(n, 4),),
                       lambda: (create.assign_types_plain(n, 4),)),
        "create_atoms": (
            lambda: create.create_atoms(s, s, s, rho, box),
            lambda: create.create_atoms_plain(s, s, s, rho, box)),
        "create_atoms_subbox": (
            lambda: create.create_atoms(s, s, s, rho, box, sub),
            lambda: create.create_atoms_plain(s, s, s, rho, box, sub)),
        "read_lammps_data": (
            lambda: read(lammps_data.read_lammps_data),
            lambda: read(lammps_data.read_lammps_data_plain)),
    }
    out = {}
    for label, (native, plain) in cases.items():
        secs, got = in_turns({"native": native, "plain": plain})
        rows = got["native"][1 if label == "read_lammps_data" else 0]
        out[label] = {"rows": len(rows),
                      "bit_identical": _bits_equal(got["native"],
                                                   got["plain"]),
                      "native_s": secs["native"], "plain_s": secs["plain"]}
    ok = (all(v["bit_identical"] for v in out.values())
          and out["rand_types"]["rows"] == out["create_atoms"]["rows"] == n
          and out["read_lammps_data"]["rows"] == n
          and 0 < out["create_atoms_subbox"]["rows"] < n)
    phase("native", f"-s {s} ({n} atoms), native against plain in turns "
          "(n p p n), host s: " + "; ".join(
              f"{k} rows={v['rows']} bit-identical={v['bit_identical']} "
              f"native={_secs(v['native_s'])} plain={_secs(v['plain_s'])}"
              for k, v in out.items()) + f" {card_line} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("native: the host runtime differs from the "
                             "numpy bodies")
    return out


def setup_split_phase(card_line, device="cuda", systems=None):
    """Simulation.from_input on each system (label: deck, -s or None for
    the deck's size), then its pieces, each to a card sync: setup_system
    native and plain in turns (n p p n; the arrays bit-identical),
    cells.build_geometry (the grid autotune and capacity), init_state with
    the upload, and Simulation.from_state (force closures, the EAM tables'
    fit, the first force). Returns {label: seconds}."""
    import torch

    from minimd_torch import cells, create
    from minimd_torch.config import FORCE_EAM, parse_deck
    from minimd_torch.sim import Simulation
    from minimd_torch.state import init_state

    if systems is None:
        systems = {"lj_131k": ("in.lj.miniMD", None),
                   "lj_864k": ("in.lj.miniMD", 60),
                   "lj_2048k": ("in.lj.miniMD.80", None),
                   "eam_864k": ("in.eam.miniMD", 60)}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        return got, time.perf_counter() - t0

    out = {}
    for label, (deck, s) in systems.items():
        inp = parse_deck(REPO / "inputs" / deck)
        if s:
            inp.nx = inp.ny = inp.nz = s
        sim, whole = timed(lambda: Simulation.from_input(inp, device=device))
        natoms = sim.natoms
        del sim
        secs, got = in_turns({
            "native": lambda: create.setup_system(inp),
            "plain": lambda: create.setup_system(inp, native=False)})
        prd, x, v, typ, mass = got["native"]
        same = _bits_equal(got["native"], got["plain"])
        solid = inp.forcetype == FORCE_EAM and inp.datafile is None
        geom, t_geom = timed(lambda: cells.build_geometry(
            prd, inp.neigh_cut, x, solid=solid))
        state, t_init = timed(lambda: init_state(x, v, typ, geom,
                                                 device=device))
        sim, t_force = timed(lambda: Simulation.from_state(
            inp, geom, state, mass, ntypes=4, device=device))
        ok = same and sim.natoms == natoms == len(x)
        out[label] = {"natoms": natoms, "from_input_s": whole,
                      "setup_system_native_s": secs["native"],
                      "setup_system_plain_s": secs["plain"],
                      "bit_identical": same, "build_geometry_s": t_geom,
                      "init_state_s": t_init, "first_force_s": t_force,
                      "nb": list(geom.nb), "capacity": geom.capacity}
        phase("setup-split", f"{label} natoms={natoms} from_input="
              f"{whole:.3f}s: setup_system native={_secs(secs['native'])}"
              f" plain={_secs(secs['plain'])} (n p p n, bit-identical="
              f"{same}), build_geometry={t_geom:.3f}s (nb={geom.nb} "
              f"C={geom.capacity}), init_state with the upload="
              f"{t_init:.3f}s, from_state with the first force="
              f"{t_force:.3f}s {card_line} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"setup-split {label}: the native and plain "
                                 "set-up differ")
        del sim, state, got
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def sweep_large_phase(card_line, cases=None, device="cuda"):
    """minimd_torch.run_tests' card `large` scope (f32, precision 4), one
    device: each case's status (PASS, or XFAIL for a case of
    run_tests.XFAIL_F32 that fails), T/U/P fractions, the kernels'
    launches over the case (set-up included) and its seconds. A FAIL fails
    the phase. Returns {case: numbers}."""
    import torch

    from minimd_torch import run_tests

    cuda = device != "cpu"
    if cases is None:
        cases = run_tests.scope_cases("large", cuda=True)
    precision = 4 if cuda else 8
    out, failed = {}, []
    for name, size, steps in cases:
        reset_counters()
        t0 = time.perf_counter()
        res, rows, skip = run_tests.run_case(name, size, steps, precision,
                                             device=device)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in counters().items() if n}
        if skip:
            failed.append(f"{name} -s {size}: {skip}")
            continue
        status = ("PASS" if res.passed else "XFAIL"
                  if cuda and (name, size) in run_tests.XFAIL_F32 else "FAIL")
        force = ({"lj_force"} if name.startswith("lj")
                 else {"eam_rho", "eam_force"})
        ran = not cuda or all(launches.get(k, 0) > 0
                              for k in force | {"rebin_pull"})
        if status == "FAIL" or not ran:
            failed.append(f"{name} -s {size}")
        key = f"{name}_{size}_{steps}"
        out[key] = {"status": status, "frac_t": res.frac_t,
                    "frac_u": res.frac_e, "frac_p": res.frac_p,
                    "nsteps": res.nsteps, "launches": launches,
                    "wall_s": wall, "last_row": rows[-1]}
        phase("sweep-large", f"{status} {name} -s {size} -n {steps} "
              f"(precision {precision}): {res} T/U/P {res.frac_t:.3f} / "
              f"{res.frac_e:.3f} / {res.frac_p:.3f} launches={launches} "
              f"{wall:.1f}s (set-up included) last={rows[-1]} {card_line}")
        if cuda:
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"sweep-large: {failed} failed")
    return out


def data_864k_phase(card_line, workdir, s=60, steps=100, device="cuda"):
    """The LJ deck at -s s written with lammps_data.write_lammps_data (its
    setup_system arrays: lattice, scaled velocities), [native] on that
    file, then the file read through Simulation.from_input (the -f path,
    native reader) and `steps` steps on the card: rows bit for bit the
    deck run's (.17g round-trips, the types come from the same stream, the
    box is the same), every atom kept. Returns its numbers."""
    import numpy as np
    import torch

    from minimd_torch import create, lammps_data
    from minimd_torch.config import parse_deck
    from minimd_torch.sim import Simulation

    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = s
    path = pathlib.Path(workdir) / f"lj{s}.data"
    prd, x, v, _, mass = create.setup_system(inp)
    box = create.create_box(s, s, s, inp.rho)
    t0 = time.perf_counter()
    lammps_data.write_lammps_data(path, box, x, v, mass=mass)
    t_write = time.perf_counter() - t0
    native = native_phase(card_line, path, s)
    runs = {}
    for label, datafile in (("data", str(path)), ("deck", None)):
        inp.datafile = datafile
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = Simulation.from_input(inp, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        reset_counters()
        trace = sim.run(steps)
        launches = {k: n for k, n in counters().items() if n}
        runs[label] = {"from_input_s": t_setup, "launches": launches,
                       "rows": sim.thermo_trace(trace),
                       "kept": int(sim.state.valid.sum()),
                       "natoms": sim.natoms, "finite":
                       bool(np.isfinite(trace).all()),
                       "clean": sim.state.overflow == 0 and sim._regrows == 0,
                       "prd": np.asarray(sim.geom.prd)}
        del sim
    path.unlink()
    d, k = runs["data"], runs["deck"]
    same = d["rows"] == k["rows"]
    ok = (same and d["kept"] == d["natoms"] == 4 * s ** 3 and d["finite"]
          and d["clean"] and np.array_equal(d["prd"], k["prd"])
          and np.array_equal(d["prd"], prd)
          and (device == "cpu" or (d["launches"].get("lj_force", 0) > 0
                                   and d["launches"].get("rebin_pull", 0)
                                   > 0)))
    rd = native["read_lammps_data"]
    phase("data-864k", f"-s {s} ({4 * s ** 3} atoms): write "
          f"{t_write:.3f}s, read native={_secs(rd['native_s'])}s plain="
          f"{_secs(rd['plain_s'])}s, from_input (-f) "
          f"{d['from_input_s']:.3f}s (deck {k['from_input_s']:.3f}s); "
          f"{steps} steps launches={d['launches']} rows={d['rows']} "
          f"bit-identical to the deck run's={same} atoms={d['kept']} "
          f"{card_line} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("data-864k: the data-file run differs from "
                             "the deck run")
    return {"write_s": t_write, "from_input_s": d["from_input_s"],
            "deck_from_input_s": k["from_input_s"],
            "launches": d["launches"], "rows_bit_identical": same,
            "native": native}


def data_1m_phase(card_line, workdir, n=(64, 32, 128), rho=0.058464,
                  steps=100, device="cuda"):
    """`python -m minimd_torch.make_data --nx 64 --ny 32 --nz 128 --rho
    0.058464` (1,048,576 atoms in the 261.76 x 130.88 x 523.52 box of
    tests/golden/1049k.lj-data), then the CLI's `-i
    inputs/in.lj-data.miniMD -f <file> -n steps -o 1` (cli.main, in this
    process): every atom kept, lost_atoms: 0 in its YAML, no regrow, and
    rows bit for bit those of Simulation.from_arrays on the arrays
    make_data wrote (make_data.make_system, the same calls). Returns its
    numbers."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from minimd_torch import cli, create, make_data
    from minimd_torch.config import parse_deck
    from minimd_torch.sim import Simulation

    nx, ny, nz = n
    natoms = 4 * nx * ny * nz
    path = pathlib.Path(workdir) / "1m.data"
    t0 = time.perf_counter()
    made = subprocess.run(
        [sys.executable, "-m", "minimd_torch.make_data", "--nx", str(nx),
         "--ny", str(ny), "--nz", str(nz), "--rho", str(rho), "-o",
         str(path)], cwd=REPO, capture_output=True, text=True, check=True)
    t_make = time.perf_counter() - t0
    deck = REPO / "inputs/in.lj-data.miniMD"
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            sim, rows = cli.main(["-i", str(deck), "-f", str(path), "-n",
                                  str(steps), "-o", "1", "--device", device])
        if device != "cpu":
            torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = {k: c for k, c in counters().items() if c}
    finally:
        os.chdir(cwd)
    out = buf.getvalue().splitlines()
    yaml = next(ln for ln in out if ln.startswith("# YAML report: "))
    yaml_path = pathlib.Path(workdir) / yaml.split(": ", 1)[1]
    lost0 = "lost_atoms: 0" in yaml_path.read_text().splitlines()
    yaml_path.unlink()
    path.unlink()
    kept = int(sim.state.valid.sum())
    clean = sim.state.overflow == 0 and sim._regrows == 0
    geom = (sim.geom.nb, sim.geom.capacity)
    prd_run = np.asarray(sim.geom.prd)
    del sim
    box, x, v = make_data.make_system(nx, ny, nz, rho, 1.44, 1.0)
    inp = parse_deck(deck)
    inp.datafile, inp.ntimes = str(path), steps
    ref = Simulation.from_arrays(inp, box.prd, x, v,
                                 create.assign_types(len(x), 4), 1.0,
                                 device=device)
    ref_rows = ref.thermo_trace(ref.run(steps))
    same = rows == ref_rows
    ok = (same and kept == natoms == len(x) and lost0 and clean
          and np.array_equal(prd_run, box.prd)
          and "# WARNING" not in buf.getvalue()
          and f"{natoms} atoms" in made.stdout
          and (device == "cpu" or (launches.get("lj_force", 0) > 0
                                   and launches.get("rebin_pull", 0) > 0)))
    phase("data-1m", f"make_data {made.stdout.strip()} in {t_make:.1f}s; "
          f"-f {steps} steps through cli.main in {t_cli:.1f}s (set-up "
          f"included): nb={geom[0]} C={geom[1]} atoms={kept} lost_atoms 0="
          f"{lost0} no regrow={clean} launches={launches} rows={rows} equal "
          f"to from_arrays'={same} {card_line} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("data-1m: the 1M-atom data-file run failed its "
                             "checks")
    return {"natoms": natoms, "make_data_s": t_make, "cli_s": t_cli,
            "nb": list(geom[0]), "capacity": geom[1], "launches": launches,
            "rows": rows, "rows_equal_from_arrays": same}


# python -m minimd_torch.bench's last line: bench.py's keys, and the rates
# among them (bench.py:122-137)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "companions"}
BENCH_RATES = ("lj_864k", "eam_131k", "eam_864k", "lj_131k_sharded_1chip")


def bench_line(label, lines, card, metric, rates):
    """The JSON object of a bench run's last line, after its checks: the
    keys of bench.py's line, the metric, every rate finite and above 0,
    the card's name and power limit under companions.device."""
    got = json.loads(lines[-1])
    comp = got["companions"]
    values = [got["value"], *(comp[k] for k in rates)]
    ok = (set(got) == BENCH_KEYS and got["metric"] == metric
          and got["unit"] == "Matom_steps_per_sec"
          and all(isinstance(v, (int, float)) and math.isfinite(v)
                  and v > 0 for v in values) and comp["device"] == card)
    if not ok:
        raise AssertionError(f"{label}: last line {lines[-1]!r} fails its "
                             "checks")
    return got


def bench_phase(card, timed_131k):
    """[bench]: python -m minimd_torch.bench, its --devices 8 line and
    python -m minimd_torch.perf --style eam --n 32, each in a subprocess
    that must exit 0; every line they print, the checks of bench_line and
    of perf's two lines; the bench's lj_131k beside the rates that
    timed_run read at 131k in this call (the slope cancels each run()'s
    start and end, which timed_run counts)."""
    runs = {}
    for label, argv in (
            ("bench", ["minimd_torch.bench"]),
            ("bench-devices-8", ["minimd_torch.bench", "--devices", "8"]),
            ("perf-eam-32", ["minimd_torch.perf", "--style", "eam", "--n",
                             "32"])):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        for line in lines:
            phase(label, line)
        if out.returncode != 0 or not lines:
            print(out.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"{label}: exit {out.returncode}")
        runs[label] = (lines, time.time() - t0)
    lines, _ = runs["bench"]
    head = bench_line("bench", lines, card, "lj_131k_throughput",
                      BENCH_RATES)
    slopes = [ln for ln in lines if ln.startswith("[slope] ")]
    lines, _ = runs["bench-devices-8"]
    dev8 = bench_line("bench --devices 8", lines, card,
                      "lj_131k_sharded_throughput", ())
    first, second = runs["perf-eam-32"][0][-2:]
    m = re.fullmatch(r"per_step=([0-9.]+) ms  throughput=([0-9.]+) "
                     r"Matom_steps/s  overflow=0", second)
    if not (len(slopes) == 15 and dev8["companions"]["devices"] == 8
            and first.startswith("natoms=131072 grid=(")
            and " C=" in first and first.endswith(f"device={card}")
            and m and float(m.group(2)) > 0):
        raise AssertionError("bench: slopes, --devices 8 or perf's lines "
                             "fail their checks")
    ratios = [head["value"] / r for r in timed_131k]
    phase("bench", f"lj_131k {head['value']} (best slope) against "
          f"timed_run's {' '.join(f'{r:.3f}' for r in timed_131k)} at 131k "
          f"in this call: ratio {' '.join(f'{q:.3f}' for q in ratios)}; "
          "seconds " + " ".join(f"{k}={t:.1f}" for k, (_, t) in
                                runs.items()) + f" [{card}]")
    return {"bench": head, "bench_devices_8": dev8, "slopes": slopes,
            "perf_eam_32": [first, second],
            "lj_131k_over_timed_run": ratios,
            "seconds": {k: t for k, (_, t) in runs.items()}}


def main():
    import numpy as np
    import torch

    wall0 = time.time()
    if not (REPO / "minimd_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (minimd_torch/ not found beside it)")
    sys.path.insert(0, str(REPO))

    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from minimd_torch import _build

    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    regs = ptxas_summary((_build.BUILD_DIR / "ptxas.log").read_text())
    phase("build", f"{lib_path.name} in {time.time() - t0:.1f}s; "
          + "; ".join(regs))

    from minimd_torch import cells
    from minimd_torch.config import parse_deck
    from minimd_torch.ops.eam import EAMTables
    from minimd_torch.sim import Simulation
    from minimd_torch.validate import compare_traces, parse_golden

    # 3. kernels against their plain versions
    max_err = dict.fromkeys(("lj_force", "rebin_pull", "lj_step", "eam_rho",
                             "eam_force", "eam_rho_rows", "eam_force_rows"),
                            0.0)
    for label, (s, nbins, cap) in LJ_SHAPES.items():
        inp, geom, st, xp = lattice(s, nbins, cap,
                                    kick=LJ_KICK.get(label, 0.12))
        if min(geom.nb) >= 3:
            max_err["rebin_pull"] = max(max_err["rebin_pull"],
                                        compare_rebin(label, geom, st, xp))
        rebin = cells.rebin_local if min(geom.nb) >= 3 else cells.rebin_lean
        x, v, typ, _ = rebin(xp, st.v, st.typ, geom)
        if label == "stage":
            stage_handover(label, "lj", geom, x, inp.force_cut)
        max_err["lj_force"] = max(max_err["lj_force"], compare_lj(
            label, geom, lj_params(inp), x, typ))
        compare_lj_list(label, geom, lj_params(inp), x, typ, inp.neigh_cut)
        # the fused step chains 4 steps from a +-0.04 lattice: larger kicks
        # bring pairs to r < 1 sigma, where the LJ force is stiff enough
        # (dF/dr ~ 700 at +-0.08) that a pair counted by one version and
        # not the other (near_cut) moves its neighbors' w past the
        # tolerance within 4 steps; LJ units, mass 1: dtforce = dt/2
        _, geom, st, xp = lattice(s, nbins, cap, kick=0.04)
        x, v, _, _ = rebin(xp, st.v, st.typ, geom)
        max_err["lj_step"] = max(max_err["lj_step"], compare_lj_step(
            label, geom, lj_params(inp), x, v, cells.is_valid(x), inp.dt,
            0.5 * inp.dt))
    for label in REBIN_SHAPES:
        compare_rebin(label, *rebin_case(label))
    tables = EAMTables.from_funcfl()
    for label, (s, nbins, cap) in EAM_SHAPES.items():
        _, geom, st, xp = lattice(s, nbins, cap, deck="eam", kick=0.08,
                                  rho_scale=EAM_RHO_SCALE.get(label, 1.0))
        x = rebinned(geom, st, xp)
        if label in EAM_RHO_SCALE:
            eam_candidate_counts(label, geom, tables, x, max_share=1.0)
        if label == "stage":
            stage_handover(label, "eam", geom, x, tables.cut)
        for kind, compare in (("", compare_eam), ("_rows", compare_eam_rows)):
            e_rho, e_f = compare(label, geom, tables, x, st.typ)
            max_err[f"eam_rho{kind}"] = max(max_err[f"eam_rho{kind}"], e_rho)
            max_err[f"eam_force{kind}"] = max(max_err[f"eam_force{kind}"],
                                             e_f)
        torch.cuda.empty_cache()

    # 4. the 4k/10000-step f32 acceptance gates: each deck on its default
    # path, LJ through the fused step, EAM through the gather tables
    def gate(deck, label, need, fused=False, rows=False, half=False,
             gn=True, steps=10000):
        golden4k = parse_golden(REPO / f"tests/golden/4k.{deck}")
        inp = parse_deck(REPO / f"inputs/in.{deck}.miniMD")
        inp.nx = inp.ny = inp.nz = 10
        t0 = time.time()
        sim = Simulation.from_input(inp, device="cuda", fused_step=fused,
                                    half_neigh=half, ghost_newton=gn)
        if rows:
            through_rows(sim)
        reset_counters()
        trace = sim.run(steps)
        launches = counters()
        rows_ = sim.thermo_trace(trace)
        res = compare_traces(rows_, golden4k.rows, natoms=4000, system=deck,
                             precision=4)
        # the same criterion over rows 0-2000 of this run, a witness of
        # how a short gate would read (not a condition of this one)
        short = compare_traces([r for r in rows_ if r[0] <= 2000],
                               golden4k.rows, natoms=4000, system=deck,
                               precision=4)
        phase(f"gate-4k-{label}", f"{steps} steps in {time.time() - t0:.1f}s:"
              f" {res}; first 2000 steps: {short}; launches={launches} "
              f"overflow={sim.state.overflow} regrows={sim._regrows} "
              f"last={rows_[-1]}")
        # the half path runs no force kernel: only the rebin kernels
        others = [k for k, n in launches.items() if n and k not in need]
        if not (res.passed and all(launches[k] > 0 for k in need)
                and not (half and others)
                and sim.state.overflow == 0 and sim._regrows == 0
                and len(rows_) == steps // 100 + 1):
            raise AssertionError(f"4k/{steps} f32 {label} acceptance gate "
                                 "failed")

    gate("lj", "lj", ("lj_force", "rebin_pull"))
    gate("eam", "eam", ("eam_rho", "eam_force", "rebin_pull"))
    gate("lj", "lj-fused", ("lj_step", "lj_force", "rebin_pull"), fused=True)
    gate("eam", "eam-rows", ("eam_rho_rows", "eam_force_rows", "rebin_pull"),
         rows=True)
    # the half-neighbor paths (plain torch forces, the rebin kernels)
    for deck, label, gn in (("lj", "lj-half", True),
                            ("lj", "lj-half-gn0", False),
                            ("eam", "eam-half", True)):
        gate(deck, label, ("rebin_pull",), half=True, gn=gn,
             steps=HALF_GATE_STEPS)

    setup_s = {}     # the seconds of each main path's from_input

    def main_path(label, inp, steps, fused=False, rows=False):
        """Simulation.from_input on the deck, counters set to 0 after
        construction, run(steps): (sim, thermo rows, nonzero launches)."""
        torch.cuda.synchronize()
        t0 = time.time()
        sim = Simulation.from_input(inp, device="cuda", fused_step=fused)
        torch.cuda.synchronize()
        setup_s[label] = time.time() - t0
        if rows:
            through_rows(sim)
        reset_counters()
        trace = sim.run(steps)
        launches = {k: n for k, n in counters().items() if n}
        rows_ = sim.thermo_trace(trace)
        phase(label, f"natoms={sim.natoms} nb={sim.geom.nb} "
              f"C={sim.geom.capacity} {steps} steps in "
              f"{time.time() - t0:.1f}s (setup {setup_s[label]:.3f}s) "
              f"launches={launches} overflow={sim.state.overflow} "
              f"regrows={sim._regrows} rows={rows_}")
        if not (trace.shape == (steps, 3) and bool(np.isfinite(trace).all())
                and sim.state.overflow == 0 and sim._regrows == 0
                and int(sim.state.valid.sum()) == sim.natoms):
            raise AssertionError(f"{label}: the run failed its checks")
        return sim, rows_, launches

    # 5a. the LJ main path at full width: the benchmark deck, counted
    # launches, on the default path and through the fused step
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    # the reference's own -s 32 smoke values after 100 steps
    # (BASELINE.md:21, which checks them to 1e-1; held here to 1e-2)
    ref100 = (8.200912e-01, -5.852703e+00, -1.873937e-01)
    every = inp.neigh_every
    want = {
        "main-131k": {"lj_force": 200, "rebin_pull": 200 // every},
        "main-131k-fused": {"lj_step": 200 - 200 // every,
                            "lj_force": 200 // every,
                            "rebin_pull": 200 // every},
    }
    sims, path = {}, {}
    for label, fused in (("main-131k", False), ("main-131k-fused", True)):
        sim, rows, got = main_path(label, inp, 200, fused=fused)
        if not (sim.natoms == 131072 and rows[1][0] == 100
                and all(abs(r - g) <= 1e-2 * abs(g)
                        for r, g in zip(rows[1][1:], ref100))
                and got == want[label]):
            raise AssertionError(f"{label}: step-100 row or launches "
                                 f"{got} != {want[label]}")
        sims["fused" if fused else "plain"] = sim
        path[label] = got
        if not fused:
            full_rows = {"lj": rows}
    rates = {}
    for name, got in rates_in_turns("131k", sims, 200).items():
        rates[f"lj{'_fused' if name == 'fused' else ''}_131k"] = got
    for name, sim in sims.items():
        device_share(f"131k-{name}", sim, 200)
    idle = {"lj_131k": idle_split("131k-plain", sims["plain"], 200)}
    relaxed = {"131k": time_lj_relaxed("131k", sims["plain"], 1000, 50)}
    del sims, sim
    times = {"131k": time_kernels("131k", *lattice(32), 50, 5)}

    # 5b. 864,000 atoms against the golden trace, both paths
    golden864 = parse_golden(REPO / "tests/golden/864k.lj")
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = 60
    torch.cuda.reset_peak_memory_stats()
    sims = {}
    for label, fused in (("check-864k", False), ("check-864k-fused", True)):
        sim, rows, _ = main_path(label, inp, 100, fused=fused)
        res = compare_traces(rows, golden864.rows, natoms=864000,
                             system="lj", precision=4)
        g0, r0 = golden864.rows[0], rows[0]
        step0_ok = all(abs(r0[q] - g0[q]) <= 1e-5 * abs(g0[q]) + 1e-5
                       for q in (1, 2, 3))
        phase(label, f"golden={golden864.rows[:2]} {res} "
              f"step0_ok={step0_ok}")
        if not (res.passed and step0_ok and sim.natoms == 864000):
            raise AssertionError(f"{label}: disagrees with "
                                 "tests/golden/864k.lj")
        sims["fused" if fused else "plain"] = sim
    for name, got in rates_in_turns("864k", sims, 100).items():
        rates[f"lj{'_fused' if name == 'fused' else ''}_864k"] = got
    for name, sim in sims.items():
        device_share(f"864k-{name}", sim, 100)
    phase("memory-864k", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          "GiB with both Simulations")
    relaxed["864k"] = time_lj_relaxed("864k", sims["plain"], 1000, 20)
    del sims, sim
    times["864k"] = time_kernels("864k", *lattice(60), 20, 3)

    # 6a. the EAM main path at full width: the Cu deck, launches counted
    # over exactly run(100), polynomial kernels and gather tables
    golden_eam = parse_golden(REPO / "tests/golden/4k.eam").rows[0]
    inp = parse_deck(REPO / "inputs/in.eam.miniMD")
    sims = {}
    for label, rows_on in (("main-eam-131k", False),
                           ("main-eam-131k-rows", True)):
        sim, rows, got = main_path(label, inp, 100, rows=rows_on)
        r0 = rows[0]
        # T is the requested 600 K; U and P to the golden's printed
        # digits (4k.eam and 864k.eam differ in P's 6th digit)
        step0_ok = (abs(r0[1] - 600.0) <= 1e-4
                    and abs(r0[2] - golden_eam[2]) <= 1e-6 * abs(golden_eam[2])
                    and abs(r0[3] - golden_eam[3])
                    <= 2e-5 * abs(golden_eam[3]))
        kind = "_rows" if rows_on else ""
        need = {f"eam_rho{kind}": 100, f"eam_force{kind}": 100,
                "rebin_pull": 100 // inp.neigh_every}
        phase(label, f"golden0={golden_eam} step0_ok={step0_ok}")
        if not (sim.natoms == 131072 and step0_ok and got == need
                and [r[0] for r in rows] == [0, 100]):
            raise AssertionError(f"{label}: step-0 row or launches {got} "
                                 f"!= {need}")
        sims["rows" if rows_on else "poly"] = sim
        path[label] = got
        if not rows_on:
            full_rows["eam"] = rows
    for name, got in rates_in_turns("eam-131k", sims, 100).items():
        rates[f"eam{'_rows' if name == 'rows' else ''}_131k"] = got
    for name, sim in sims.items():
        device_share(f"eam-131k-{name}", sim, 100)
    idle["eam_131k"] = idle_split("eam-131k-poly", sims["poly"], 100)
    del sims, sim
    eam_times = {"131k": time_eam_kernels(
        "131k", *lattice(32, deck="eam", kick=0.08), 50, 3)}

    # 6b. 864,000 Cu atoms against tests/golden/864k.eam, both forms
    golden864 = parse_golden(REPO / "tests/golden/864k.eam")
    inp = parse_deck(REPO / "inputs/in.eam.miniMD")
    inp.nx = inp.ny = inp.nz = 60
    torch.cuda.reset_peak_memory_stats()
    sims = {}
    for label, rows_on in (("check-eam-864k", False),
                           ("check-eam-864k-rows", True)):
        sim, rows, _ = main_path(label, inp, 100, rows=rows_on)
        res = compare_traces(rows, golden864.rows, natoms=864000,
                             system="eam", precision=4)
        g0, r0 = golden864.rows[0], rows[0]
        step0_ok = (abs(r0[1] - g0[1]) <= 1e-4
                    and abs(r0[2] - g0[2]) <= 1e-6 * abs(g0[2])
                    and abs(r0[3] - g0[3]) <= 2e-5 * abs(g0[3]))
        phase(label, f"golden={golden864.rows[:2]} {res} "
              f"step0_ok={step0_ok}")
        if not (res.passed and res.nsteps == 2 and step0_ok
                and sim.natoms == 864000):
            raise AssertionError(f"{label}: disagrees with "
                                 "tests/golden/864k.eam")
        sims["rows" if rows_on else "poly"] = sim
    for name, got in rates_in_turns("eam-864k", sims, 100).items():
        rates[f"eam{'_rows' if name == 'rows' else ''}_864k"] = got
    phase("memory-eam-864k", f"peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB with both "
          "Simulations")
    del sims, sim
    torch.cuda.empty_cache()
    eam_times["864k"] = time_eam_kernels(
        "864k", *lattice(60, deck="eam", kick=0.08), 20, 1)

    card_line = f"[{card}]"
    phase("setup", "Simulation.from_input seconds (host set-up and the "
          "first force, to a card sync) " + " ".join(
              f"{k}={v:.3f}s" for k, v in setup_s.items()) + f" {card_line}")

    # 7. the micro-probes; 8. the half-neighbor paths at full width;
    # 9. the CLI's timed run and YAML report; 10. checkpoint and resume
    micro_rows, pins = micro_phase()
    torch.cuda.empty_cache()
    half = {label: half_path(label, deck, gn, full_rows[deck])
            for label, deck, gn in (("half-lj-131k", "lj", True),
                                    ("half-lj-gn0-131k", "lj", False),
                                    ("half-eam-131k", "eam", True))}
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        cli_phase("cli-131k", "lj", ["--timed", "-o", "1"], workdir)
        cli_phase("cli-eam-131k", "eam", ["--timed"], workdir)
        checkpoint_phase(workdir)
    # the CLI outside the kernels' envelope: float64, and a stencil reach
    # of 2 (-b 12: LJ 16.8/12 = 1.40 sigma < 2.8, EAM 38.45/12 = 3.2 A <
    # 5.95), each on the JAX package's accelerator path
    for label, deck, argv, want, module in (
            ("cli-lj-f64", "lj", ["--precision", "2"], {},
             "minimd_torch.ops.lj_grid"),
            ("cli-lj-b12", "lj", ["-b", "12"], {"rebin_pull": 5},
             "minimd_torch.ops.lj_grid"),
            ("cli-eam-f64", "eam", ["--precision", "2"], {},
             "minimd_torch.ops.eam"),
            ("cli-eam-b12", "eam", ["-b", "12"], {"rebin_pull": 5},
             "minimd_torch.ops.eam_grid")):
        cli_envelope_phase(label, deck, argv, want, module)

    # 12. the decomposed run (minimd_torch/parallel) on this card's domains
    sharded_kernels, sharded_rates_, sharded_host, sharded_rows = \
        sharded_phases()

    # 13. the decomposed run's half paths and surface on this card
    with tempfile.TemporaryDirectory() as workdir:
        surface = sharded_surface_phases(full_rows, sharded_rows, half,
                                         workdir)

    # 14. past the kernels' capacity, and a mesh across the card and the
    # host
    capacity = capacity_phases(card_line)
    mixed = mesh_mixed_phase(card_line)

    # 15. the host runtime against its numpy bodies, the set-up split, the
    # run_tests large scope, and the -f path at 864k and 1,048,576 atoms
    t15 = time.time()
    setup_split = setup_split_phase(card_line)
    sweep_large = sweep_large_phase(card_line)
    with tempfile.TemporaryDirectory() as workdir:
        data = {"864k": data_864k_phase(card_line, workdir),
                "1m": data_1m_phase(card_line, workdir)}
    data["native"] = data["864k"].pop("native")
    torch.cuda.empty_cache()
    phase("host-wall", f"phase 15 took {time.time() - t15:.1f}s")

    # 16. the port's bench (python -m minimd_torch.bench, --devices 8) and
    # python -m minimd_torch.perf, each in a process of its own
    t16 = time.time()
    bench = bench_phase(card, rates["lj_131k"])
    phase("bench-wall", f"phase 16 took {time.time() - t16:.1f}s")

    def entry(name, source, replaces, t, key, **extra):
        k131, k864 = t["131k"], t["864k"]
        b131, b864 = k131[f"{key}_bound"], k864[f"{key}_bound"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **extra, "launches": launches[name],
                "max_abs_err": max_err[name], "ms": k131[key],
                "plain_ms": k131[f"{key}_plain"], "bound_ms": b131[0],
                "bound_by": b131[1], "library_ms": None,
                "shape": "131k noev", "ms_ev": k131.get(f"{key}_ev"),
                "ms_864k": k864[key], "plain_ms_864k": k864[f"{key}_plain"],
                "bound_ms_864k": b864[0], "bound_by_864k": b864[1]}

    # each kernel's launches over the main path that runs it
    launches = {**path["main-131k"], **path["main-eam-131k"],
                **path["main-eam-131k-rows"],
                "rebin_pull": path["main-131k"]["rebin_pull"],
                "lj_step": path["main-131k-fused"]["lj_step"]}
    kernels = [
        entry("lj_force", "minimd_torch/csrc/lj_list.cu",
              "minimd_tpu/ops/lj_pallas.py:69", times, "lj",
              build_ms=times["131k"]["lj_build"],
              build_ms_864k=times["864k"]["lj_build"],
              repair_ms=times["131k"]["lj_repair"],
              repair_ms_864k=times["864k"]["lj_repair"],
              cell_walk_ms=times["131k"]["lj_walk"],
              cell_walk_ms_864k=times["864k"]["lj_walk"],
              relaxed=relaxed),
        entry("rebin_pull", "minimd_torch/csrc/rebin.cu",
              "minimd_tpu/ops/rebin_pallas.py:217", times, "rebin",
              also_replaces=["minimd_tpu/ops/rebin_pallas.py:49",
                             "minimd_tpu/ops/rebin_pallas.py:370"],
              launches_per_call=["rebin_bin", "rebin_gather"],
              host_us=times["131k"]["host_us"]["rebin"],
              host_us_864k=times["864k"]["host_us"]["rebin"]),
        entry("eam_rho", "minimd_torch/csrc/eam_force.cu",
              "minimd_tpu/ops/eam_pallas.py:457", eam_times, "rho",
              also_replaces="minimd_tpu/ops/eam_pallas.py:621"),
        entry("eam_force", "minimd_torch/csrc/eam_force.cu",
              "minimd_tpu/ops/eam_pallas.py:478", eam_times, "force"),
        entry("lj_step", "minimd_torch/csrc/lj_step.cu",
              "minimd_tpu/ops/lj_step_pallas.py:90", times, "step"),
        entry("eam_rho_rows", "minimd_torch/csrc/eam_rows.cu",
              "minimd_tpu/ops/eam_pallas.py:188", eam_times, "rho_rows",
              also_replaces="minimd_tpu/ops/eam_pallas.py:72"),
        entry("eam_force_rows", "minimd_torch/csrc/eam_rows.cu",
              "minimd_tpu/ops/eam_pallas.py:209", eam_times, "force_rows"),
        *micro_rows,
        *sharded_kernels,
    ]
    phase("wall", f"chip_smoke.py {time.time() - wall0:.1f}s in all")
    print(json.dumps({"kernels": kernels, "matom_steps_per_s": rates,
                      "pins": pins, "half_131k": half,
                      "lj_candidates": {k: t["candidates"]
                                        for k, t in times.items()},
                      "eam_candidates": {k: t["candidates"]
                                         for k, t in eam_times.items()},
                      "idle_split": idle,
                      "sharded_matom_steps_per_s": sharded_rates_,
                      "sharded_host_us_per_step": sharded_host,
                      "sharded_surface": surface,
                      "setup_s": setup_s, "capacity_520": capacity,
                      "mesh_mixed": mixed, "setup_split": setup_split,
                      "sweep_large": sweep_large, "data": data,
                      "bench": bench}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
