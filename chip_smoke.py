#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimd_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels of minimd_torch/csrc with nvcc (one process per
   source, side by side);
3. hold each kernel against its plain PyTorch version on the card, f32:
   the LJ force (ev and noev) at 4k, 131k, 864k, a pinned capacity=64
   grid, s=6 on a (2,2,2) grid (image aliasing) and the largest capacity
   (512, the LJ kernels only); the pull rebin, bit-identical, on the
   4k, 131k, 864k and capacity=64 grids, on a perturbed state;
   the two EAM kernels (density + embedding, force) on the same five
   shapes of the EAM deck, cap512 and a lattice of twice the density
   (where the kernels hand their stage and lists over early): rho, fp
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
   against its plain version at both sizes and the host's time to issue
   one launch of each LJ wrapper;
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
   rows against tests/golden/4k.*.

Each kernel's bound is the least time the card could take for its work:
the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its FP32 operations (for the pair kernels on the in-cut
pairs of the timed input) over 67 TFLOP/s (an FMA counts 2, a compare,
select, min, max, square root, conversion or divide 1), the published
H100 SXM peaks. No single PyTorch call computes any of the pair, rebin or
FMA-chain functions, so their library_ms is null; copy_add's is
torch.add(x, 1.0, out=y).

Prints a JSON line of the 9 ported kernels, the rates, the probes' pins
and the half paths' numbers, the card line, and last {"ok": true,
"device": {...}}. Any failure raises: the exit code is then not 0 and no
result line is printed.
"""

import functools
import json
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
# the LJ kernels also at the largest capacity (cells.MAX_CAPACITY): their
# staged candidates take 73.7 KB of shared memory there, past the 48 KB
# that a kernel gets without opting in
LJ_SHAPES = {**SHAPES, "cap512": (10, None, 512)}
# lj_force's compare at cap512 takes the fused step's +-0.04 lattice: in
# the +-0.12 draw of that layout the positive and negative pair energies
# nearly cancel, so f32 sums in two orders (the plain version's and the
# kernel's, or the plain version's and its own f64 value) differ past
# ENG_TOL, while forces and virial agree as at the other shapes
# (PERF.md, the LJ pair loop findings)
LJ_KICK = {"cap512": 0.04}
# the EAM kernels (both forms) also at the largest capacity (the force
# passes' stage of 9*C candidates with fp takes 92 KB of shared memory
# there, opted in)
# and on a lattice of twice the deck's density, where a cell keeps more
# candidates than its stage holds (up to 357 against 9*C - 32 = 328)
# and atoms have up to 78 pairs in the cutoff against a list of 64: the
# kernels hand their stage over and run their lists early there
EAM_SHAPES = {**SHAPES, "cap512": (10, None, 512), "dense": (10, None, None)}
EAM_RHO_SCALE = {"dense": 2.0}
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
            args = [a if a.isdigit() else ("noev", "ev")[int(a[1])]
                    for a in re.findall(r"Li(\d+)E|L(b[01])E", mangled)
                    for a in a if a]
            name = (m.group(1) if m else mangled) + (
                f"<{','.join(args)}>" if args else "")
        elif "spill stores" in ln:
            spill = ln.strip().split(", ", 1)[1]
        elif "Used" in ln:
            out.append(f"{name}: {ln.split('Used ')[1]}, {spill}")
    return out


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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
            **eam_rows_cuda.LAUNCHES, **micro.LAUNCHES}


def reset_counters():
    from minimd_torch import micro
    from minimd_torch.ops import (eam_cuda, eam_rows_cuda, lj_cuda,
                                  lj_step_cuda, rebin_cuda)

    lj_cuda.LAUNCHES = rebin_cuda.LAUNCHES = lj_step_cuda.LAUNCHES = 0
    for d in (eam_cuda.LAUNCHES, eam_rows_cuda.LAUNCHES, micro.LAUNCHES):
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
    import torch

    from minimd_torch import cells
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    rk = make_rebin_cuda(geom, "cuda")(xp, st.v, st.typ)
    rp = cells.rebin_local(xp, st.v, st.typ, geom)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(rk, rp))
    phase("compare", f"rebin_pull {label} nb={geom.nb} C={geom.capacity}: "
          f"bit-identical={same} overflow={int(rk[3])}/{int(rp[3])} "
          f"atoms={int(cells.is_valid(rk[0]).sum())}")
    if not same:
        raise AssertionError(f"rebin kernel differs from its plain version "
                             f"at {label}")
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
    """LJ, fused-step and pull rebin kernels against their plain versions
    at one shape: ms per call, and each kernel's bound from this input."""
    import torch

    from minimd_torch import cells
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_grid import make_lj_force_grid
    from minimd_torch.ops.lj_step import make_lj_step_plain
    from minimd_torch.ops.lj_step_cuda import make_lj_step_cuda
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    params = lj_params(inp)
    x, v, typ, _ = cells.rebin_local(xp, st.v, st.typ, geom)
    k_ev, k_noev = make_lj_force_cuda(geom, params, torch.float32, "cuda")
    _, p_noev = make_lj_force_grid(geom, params, torch.float32, "cuda")
    t = {
        "lj_ev": cuda_ms(lambda: k_ev(x, typ), iters),
        "lj": cuda_ms(lambda: k_noev(x, typ), iters),
        "lj_plain": cuda_ms(lambda: p_noev(x, typ), plain_iters),
    }
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
    # what the host spends to issue each launch of a plain step and of a
    # fused step (the step loop at 131k is host-bound, PERF.md)
    hosts = {"lj": lambda: k_noev(x, typ),
             "step": lambda: k_step(x1, wk, False, out=spare),
             "kick": lambda: wk.add_(x1, alpha=0.0)}
    host = {k: host_us(fn, iters) for k, fn in hosts.items()}
    # the pull alone (the kernel's share of the rebin), same inputs
    xw = cells.pbc_wrap(xp, geom.prd)
    cid, xs = cells.coord_to_cell(xw, geom)
    cid = torch.where(cells.is_valid(xp), cid, -1)
    chans = [xs[0], xs[1], xs[2], st.v[0], st.v[1], st.v[2], st.typ]
    pull = make_rebin_cuda(geom, "cuda").pull
    t["pull"] = cuda_ms(lambda: pull(cid, chans), iters)
    t["pull_plain"] = cuda_ms(lambda: cells.rebin_pull(cid, chans, geom),
                              plain_iters)
    M = geom.nslots
    n_cut, _ = count_pairs(geom, x, inp.force_cut)
    t["candidates"] = candidate_counts(label, geom, params, x, n_cut)
    t["lj_bound"] = bound(24 * M, n_cut * _LJ_PAIR_OPS)
    # x, w in; x', w' out
    t["step_bound"] = bound(48 * M, n_cut * _LJ_PAIR_OPS + _STEP_SLOT_OPS * M)
    # cid + 7 channels in, 7 channels + counts + overflow out
    t["pull_bound"] = bound(4 * (8 * M + 7 * M + geom.ncells + 1), 0)
    phase("kernel-time", f"lj {label} nb={geom.nb} C={geom.capacity} "
          f"pairs={n_cut}: " + " ".join(
              f"{k}={v:.4f}ms" if isinstance(v, float) else
              f"{k}={v[0]:.5f}ms({v[1]})" for k, v in t.items()
              if k != "candidates"))
    phase("host-time", f"lj {label}: host us per call " + " ".join(
        f"{k}={v:.1f}" for k, v in host.items()))
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
            "peak_gib": peak}


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
        if label in SHAPES and min(geom.nb) >= 3:
            max_err["rebin_pull"] = max(max_err["rebin_pull"],
                                        compare_rebin(label, geom, st, xp))
        rebin = cells.rebin_local if min(geom.nb) >= 3 else cells.rebin_lean
        x, v, typ, _ = rebin(xp, st.v, st.typ, geom)
        max_err["lj_force"] = max(max_err["lj_force"], compare_lj(
            label, geom, lj_params(inp), x, typ))
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
    tables = EAMTables.from_funcfl()
    for label, (s, nbins, cap) in EAM_SHAPES.items():
        _, geom, st, xp = lattice(s, nbins, cap, deck="eam", kick=0.08,
                                  rho_scale=EAM_RHO_SCALE.get(label, 1.0))
        x = rebinned(geom, st, xp)
        if label in EAM_RHO_SCALE:
            eam_candidate_counts(label, geom, tables, x, max_share=1.0)
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
        # the half path runs no force kernel: only the pull rebin
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
    # the half-neighbor paths (plain torch forces, the pull rebin kernel)
    for deck, label, gn in (("lj", "lj-half", True),
                            ("lj", "lj-half-gn0", False),
                            ("eam", "eam-half", True)):
        gate(deck, label, ("rebin_pull",), half=True, gn=gn,
             steps=HALF_GATE_STEPS)

    def main_path(label, inp, steps, fused=False, rows=False):
        """Simulation.from_input on the deck, counters set to 0 after
        construction, run(steps): (sim, thermo rows, nonzero launches)."""
        t0 = time.time()
        sim = Simulation.from_input(inp, device="cuda", fused_step=fused)
        if rows:
            through_rows(sim)
        reset_counters()
        trace = sim.run(steps)
        launches = {k: n for k, n in counters().items() if n}
        rows_ = sim.thermo_trace(trace)
        phase(label, f"natoms={sim.natoms} nb={sim.geom.nb} "
              f"C={sim.geom.capacity} {steps} steps in "
              f"{time.time() - t0:.1f}s (setup included) "
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
        entry("lj_force", "minimd_torch/csrc/lj_force.cu",
              "minimd_tpu/ops/lj_pallas.py:69", times, "lj"),
        entry("rebin_pull", "minimd_torch/csrc/rebin_pull.cu",
              "minimd_tpu/ops/rebin_pallas.py:217", times, "pull",
              also_replaces="minimd_tpu/ops/rebin_pallas.py:49"),
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
    ]
    phase("wall", f"chip_smoke.py {time.time() - wall0:.1f}s in all")
    print(json.dumps({"kernels": kernels, "matom_steps_per_s": rates,
                      "pins": pins, "half_131k": half,
                      "lj_candidates": {k: t["candidates"]
                                        for k, t in times.items()},
                      "eam_candidates": {k: t["candidates"]
                                         for k, t in eam_times.items()},
                      "idle_split": idle}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
