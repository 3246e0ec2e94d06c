#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimd_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels of minimd_torch/csrc with nvcc;
3. hold each kernel against its plain PyTorch version on the card, f32:
   the LJ force (ev and noev) at 4k, 131k, 864k, a pinned capacity=64
   grid and s=6 on a (2,2,2) grid (image aliasing); the pull rebin,
   bit-identical, on the same grids but the last, on a perturbed state;
4. the 4k/10000-step f32 acceptance gate against tests/golden/4k.lj with
   the reference's statistical criterion (validate.compare_traces);
5. the main path at full width: Simulation.from_input on the benchmark
   deck inputs/in.lj.miniMD (131,072 atoms), run(200), with the kernels'
   launch counts taken over exactly that run and its step-100 row held
   against the reference's -s 32 smoke values; then -s 60 (864,000 atoms,
   100 steps) against tests/golden/864k.lj; timed runs (CUDA events,
   after a warm run) and each kernel timed against its plain version at
   both sizes.

Prints a JSON line of kernels, the card line, and last
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
not 0 and no result line is printed.
"""

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

F_TOL, ENG_TOL, VIR_TOL = 2e-5, 1e-5, 1e-4   # tests/test_lj_trace.py:314-316


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


def lattice(s, nbins=None, capacity=None, seed=7):
    """(deck, geometry, LJ parameters, f32 CUDA state, perturbed positions)
    of the LJ deck at size s; every atom moved by ±0.12 per coordinate
    (tests/test_cells.py:94-96), so a rebin has atoms to move."""
    import numpy as np
    import torch

    from minimd_tpu import create
    from minimd_tpu.config import builtin_deck
    from minimd_torch import cells
    from minimd_torch.ops.lj import LJParams
    from minimd_torch.state import init_state

    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = s
    prd, x, v, typ, _ = create.setup_system(inp)
    geom = cells.build_geometry(prd, inp.neigh_cut, x, nbins=nbins,
                                capacity=capacity)
    st = init_state(x, v, typ, geom, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed)
    kick = torch.as_tensor(0.12 * np.sign(rng.normal(size=(3, geom.nslots))),
                           dtype=torch.float32, device="cuda")
    xp = st.x + kick * st.valid
    params = LJParams.from_deck(1, inp.epsilon, inp.sigma, inp.force_cut)
    return inp, geom, params, st, xp


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


def time_kernels(label, geom, params, st, xp, iters, plain_iters):
    """(lj kernel ev, lj kernel noev, lj plain noev, pull kernel, pull
    plain) in ms per call at one shape."""
    import torch

    from minimd_torch import cells
    from minimd_torch.ops.lj_cuda import make_lj_force_cuda
    from minimd_torch.ops.lj_grid import make_lj_force_grid
    from minimd_torch.ops.rebin_cuda import make_rebin_cuda

    x, _, typ, _ = cells.rebin_local(xp, st.v, st.typ, geom)
    k_ev, k_noev = make_lj_force_cuda(geom, params, torch.float32, "cuda")
    _, p_noev = make_lj_force_grid(geom, params, torch.float32, "cuda")
    t = {
        "lj_ev": cuda_ms(lambda: k_ev(x, typ), iters),
        "lj_noev": cuda_ms(lambda: k_noev(x, typ), iters),
        "lj_plain_noev": cuda_ms(lambda: p_noev(x, typ), plain_iters),
    }
    # the pull alone (the kernel's share of the rebin), same inputs
    xw = cells.pbc_wrap(xp, geom.prd)
    cid, xs = cells.coord_to_cell(xw, geom)
    cid = torch.where(cells.is_valid(xp), cid, -1)
    chans = [xs[0], xs[1], xs[2], st.v[0], st.v[1], st.v[2], st.typ]
    pull = make_rebin_cuda(geom, "cuda").pull
    t["pull"] = cuda_ms(lambda: pull(cid, chans), iters)
    t["pull_plain"] = cuda_ms(lambda: cells.rebin_pull(cid, chans, geom),
                              plain_iters)
    phase("kernel-time", f"{label} nb={geom.nb} C={geom.capacity}: " +
          " ".join(f"{k}={v:.4f}ms" for k, v in t.items()))
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


def main():
    import numpy as np
    import torch

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
    regs = [ln.split("ptxas info    : ")[-1] for ln in
            (_build.BUILD_DIR / "ptxas.log").read_text().splitlines()
            if "Used" in ln]
    phase("build", f"{lib_path.name} in {time.time() - t0:.1f}s; "
          + "; ".join(regs))

    from minimd_torch import cells
    from minimd_torch.ops import lj_cuda, rebin_cuda
    from minimd_torch.sim import Simulation
    from minimd_tpu.config import parse_deck
    from minimd_tpu.validate import compare_traces, parse_golden

    # 3. kernels against their plain versions
    max_err = {"lj": 0.0, "rebin": 0.0}
    shapes = {"4k": (10, None, None), "131k": (32, None, None),
              "864k": (60, None, None), "cap64": (10, None, 64),
              "s6_nb2": (6, (2, 2, 2), None)}
    for label, (s, nbins, cap) in shapes.items():
        inp, geom, params, st, xp = lattice(s, nbins, cap)
        if min(geom.nb) >= 3:
            max_err["rebin"] = max(max_err["rebin"],
                                   compare_rebin(label, geom, st, xp))
            x = cells.rebin_local(xp, st.v, st.typ, geom)[0]
        else:
            x = cells.rebin_lean(xp, st.v, st.typ, geom)[0]
        max_err["lj"] = max(max_err["lj"],
                            compare_lj(label, geom, params, x, st.typ))

    # 4. the 4k/10000-step f32 acceptance gate
    golden4k = parse_golden(REPO / "tests/golden/4k.lj")
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = 10
    lj_cuda.LAUNCHES = rebin_cuda.LAUNCHES = 0
    t0 = time.time()
    sim = Simulation.from_input(inp, device="cuda")
    trace = sim.run(10000)
    rows = sim.thermo_trace(trace)
    res = compare_traces(rows, golden4k.rows, natoms=4000, system="lj",
                         precision=4)
    phase("gate-4k", f"10000 steps in {time.time() - t0:.1f}s: {res}; "
          f"launches lj={lj_cuda.LAUNCHES} rebin={rebin_cuda.LAUNCHES} "
          f"overflow={sim.state.overflow} last={rows[-1]}")
    if not (res.passed and lj_cuda.LAUNCHES > 0 and rebin_cuda.LAUNCHES > 0
            and sim.state.overflow == 0 and len(rows) == 101):
        raise AssertionError("4k/10000 f32 acceptance gate failed")

    # 5a. the main path at full width: the benchmark deck, counted launches
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    lj_cuda.LAUNCHES = rebin_cuda.LAUNCHES = 0
    t0 = time.time()
    sim = Simulation.from_input(inp, device="cuda")
    trace = sim.run(200)
    launches = {"lj": lj_cuda.LAUNCHES, "rebin": rebin_cuda.LAUNCHES}
    rows = sim.thermo_trace(trace)
    # the reference's own -s 32 smoke values after 100 steps
    # (BASELINE.md:21, which checks them to 1e-1; held here to 1e-2)
    ref100 = (8.200912e-01, -5.852703e+00, -1.873937e-01)
    ok = (sim.natoms == 131072 and trace.shape == (200, 3)
          and bool(np.isfinite(trace).all()) and sim.state.overflow == 0
          and int(sim.state.valid.sum()) == sim.natoms
          and rows[1][0] == 100
          and all(abs(r - g) <= 1e-2 * abs(g)
                  for r, g in zip(rows[1][1:], ref100))
          and launches["lj"] > 0 and launches["rebin"] > 0)
    phase("main-131k", f"natoms={sim.natoms} nb={sim.geom.nb} "
          f"C={sim.geom.capacity} 200 steps in {time.time() - t0:.1f}s "
          f"(setup included) launches={launches} "
          f"overflow={sim.state.overflow} rows={rows}")
    if not ok:
        raise AssertionError("131k main path failed its checks")
    _, ms, rate = timed_run(sim, 200)
    phase("rate-131k", f"200 steps {ms:.1f}ms = {rate:.3f} Matom-steps/s "
          f"(overflow={sim.state.overflow})")
    rates = {"131k": rate}
    times = {"131k": time_kernels("131k", *lattice(32)[1:], 50, 5)}

    # 5b. 864,000 atoms against the golden trace
    golden864 = parse_golden(REPO / "tests/golden/864k.lj")
    inp = parse_deck(REPO / "inputs/in.lj.miniMD")
    inp.nx = inp.ny = inp.nz = 60
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation.from_input(inp, device="cuda")
    trace = sim.run(100)
    rows = sim.thermo_trace(trace)
    res = compare_traces(rows, golden864.rows, natoms=864000, system="lj",
                         precision=4)
    g0, r0 = golden864.rows[0], rows[0]
    step0_ok = all(abs(r0[q] - g0[q]) <= 1e-5 * abs(g0[q]) + 1e-5
                   for q in (1, 2, 3))
    phase("check-864k", f"nb={sim.geom.nb} C={sim.geom.capacity} rows={rows} "
          f"golden={golden864.rows[:2]} {res} step0_ok={step0_ok} "
          f"overflow={sim.state.overflow}")
    if not (res.passed and step0_ok and sim.state.overflow == 0
            and int(sim.state.valid.sum()) == 864000):
        raise AssertionError("864k run disagrees with tests/golden/864k.lj")
    _, ms, rate = timed_run(sim, 100)
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("rate-864k", f"100 steps {ms:.1f}ms = {rate:.3f} Matom-steps/s "
          f"peak_mem={peak:.2f}GiB (overflow={sim.state.overflow})")
    rates["864k"] = rate
    del sim
    times["864k"] = time_kernels("864k", *lattice(60)[1:], 20, 3)

    kernels = [
        {"name": "lj_force", "route": "cuda",
         "source": "minimd_torch/csrc/lj_force.cu",
         "replaces": "minimd_tpu/ops/lj_pallas.py:69",
         "launches": launches["lj"], "max_abs_err": max_err["lj"],
         "ms": times["131k"]["lj_noev"],
         "plain_ms": times["131k"]["lj_plain_noev"],
         "shape": "131k noev", "ms_ev": times["131k"]["lj_ev"],
         "ms_864k": times["864k"]["lj_noev"],
         "plain_ms_864k": times["864k"]["lj_plain_noev"]},
        {"name": "rebin_pull", "route": "cuda",
         "source": "minimd_torch/csrc/rebin_pull.cu",
         "replaces": "minimd_tpu/ops/rebin_pallas.py:217",
         "also_replaces": "minimd_tpu/ops/rebin_pallas.py:49",
         "launches": launches["rebin"], "max_abs_err": max_err["rebin"],
         "ms": times["131k"]["pull"], "plain_ms": times["131k"]["pull_plain"],
         "shape": "131k",
         "ms_864k": times["864k"]["pull"],
         "plain_ms_864k": times["864k"]["pull_plain"]},
    ]
    print(json.dumps({"kernels": kernels, "matom_steps_per_s": rates}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
