"""Post-run reporting: the lost-atom audit, the YAML report and its run
statistics, and a decomposed run's per-device statistics
(ref/output.cpp:48-547; a port of minimd_tpu/output.py).

Two faults of the JAX package's module are not copied: its
lost_atom_check counts valid slots without looking at the positions, and
its run_statistics drops the neighbor statistics silently on any error.
Here the audit is the reference's (positions inside the box), and a
statistic that is skipped is named in the report with the reason. Each
function takes a Simulation or a ShardedSimulation (whose `state` is the
gathered state on the host).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import cells
from .config import FORCE_LJ, UNITS_LJ
from .timer import TIME_COMM, TIME_FORCE, TIME_NEIGH, TIME_TOTAL

VARIANT = "miniMD-torch (PyTorch/CUDA)"


def lost_atom_check(sim) -> int:
    """The reference's audit (output.cpp:60-85): count the atoms whose
    positions lie inside the box, [0, prd) on every axis; returns the
    number lost (0 is the only acceptable answer). A position that drifted
    past a face since the last rebin is first wrapped by one image, as the
    reference's pbc() wraps it at every reneighbor step; an atom that is
    not finite, or further out than one box length, is lost."""
    x = sim.state.x
    prd = torch.as_tensor(sim.geom.prd, dtype=x.dtype,
                          device=x.device)[:, None]
    xw = torch.where(x < 0, x + prd, torch.where(x >= prd, x - prd, x))
    inside = ((xw >= 0) & (xw < prd)).all(dim=0) & cells.is_valid(x)
    return sim.natoms - int(inside.sum())


def tail_corrections(rho: float, cutforce: float) -> tuple[float, float]:
    """LJ long-range energy and pressure tail corrections
    (output.cpp:89-92), which the reference computes and never prints;
    the YAML report shows them."""
    c3 = 1.0 / (3.0 * cutforce ** 3)
    c9 = 1.0 / (9.0 * cutforce ** 9)
    engcorr = 8.0 * math.pi * rho * (c9 - c3)
    prscorr = 8.0 * math.pi * rho * rho * (4.0 * c9 - 2.0 * c3)
    return engcorr, prscorr


def conservation_ratio(rows) -> float:
    """(1.5 T + U) of the last thermo row over the first's
    (output.cpp:172-174)."""
    first, last = rows[0], rows[-1]
    e0 = 1.5 * first[1] + first[2]
    e1 = 1.5 * last[1] + last[2]
    return e1 / e0 if e0 else float("nan")


def _dist(arr) -> dict:
    """min, max, average and a 10-bin histogram (output.cpp:496-547)."""
    arr = np.asarray(arr, dtype=float)
    if arr.size == 0:
        return {"min": 0, "max": 0, "ave": 0, "histogram": []}
    lo, hi = float(arr.min()), float(arr.max())
    hist, _ = np.histogram(arr, bins=10, range=(lo, hi if hi > lo else lo + 1))
    return {"min": lo, "max": hi, "ave": float(arr.mean()),
            "histogram": hist.tolist()}


def run_statistics(sim) -> dict:
    """Distributions over the final state: cell occupancy and neighbor
    counts within the force cutoff (the reference's cross-rank statistics,
    output.cpp:496-547, over cells and atoms). A statistic that cannot be
    taken is listed under "skipped" with the reason."""
    x = sim.state.x.cpu().numpy()
    valid = sim.state.valid.cpu().numpy()
    occ = valid.reshape(-1, sim.geom.capacity).sum(axis=1)
    stats = {"cell_occupancy": _dist(occ)}
    skipped = {}
    try:
        from scipy.spatial import cKDTree
    except ImportError as e:
        skipped["neighbors_within_cutoff"] = f"scipy is not installed ({e})"
        cKDTree = None
    if cKDTree is not None and valid.any():
        prd = np.asarray(sim.geom.prd)
        xw = np.mod(x.T[valid], prd)
        # every 1 in n atoms for at most ~20k queries
        sample = xw[:: max(1, len(xw) // 20000)]
        counts = cKDTree(xw, boxsize=prd).query_ball_point(
            sample, sim.inp.force_cut, return_length=True) - 1
        stats["neighbors_within_cutoff"] = _dist(counts)
    elif cKDTree is not None:
        skipped["neighbors_within_cutoff"] = "no valid atoms"
    if skipped:
        stats["skipped"] = skipped
    return stats


def per_device_statistics(ssim) -> dict:
    """A decomposed run's per-domain distributions (the reference's
    per-rank statistics, output.cpp:280-475), with the keys of the JAX
    package's: the atoms each domain owns, its halo shell in cells, the
    atoms in its h-wide boundary slabs per decomposed axis (what a halo
    exchange ships to the two neighbors along that axis; an atom within h
    of both faces counts in both, an undecomposed axis ships nothing),
    and, after run_timed, the phase times."""
    from .ops.pairgrid import halo_extent
    from .state import sharded_to_grid

    valid = sharded_to_grid(ssim.state_, ssim.mesh, ssim.geom)[4]
    nbz, nby, nbx, C = valid.shape
    pz, py, px = (ssim.mesh.shape["z"], ssim.mesh.shape["y"],
                  ssim.mesh.shape["x"])
    lz, ly, lx = nbz // pz, nby // py, nbx // px
    blocks = valid.reshape(pz, lz, py, ly, px, lx, C)
    nlocal = blocks.sum(axis=(1, 3, 5, 6)).reshape(-1)
    h = halo_extent(ssim.geom)
    shell_cells = ((lz + 2 * h) * (ly + 2 * h) * (lx + 2 * h)
                   - lz * ly * lx)
    occ = blocks.sum(axis=6)        # (pz, lz, py, ly, px, lx) atoms a cell
    hz, hy, hx = min(h, lz), min(h, ly), min(h, lx)
    zeros = np.zeros(pz * py * px, dtype=occ.dtype)
    swaps = {
        "z": ((occ[:, :hz].sum(axis=(1, 3, 5))
               + occ[:, lz - hz:].sum(axis=(1, 3, 5))).reshape(-1)
              if pz > 1 else zeros),
        "y": ((occ[:, :, :, :hy].sum(axis=(1, 3, 5))
               + occ[:, :, :, ly - hy:].sum(axis=(1, 3, 5))).reshape(-1)
              if py > 1 else zeros),
        "x": ((occ[..., :hx].sum(axis=(1, 3, 5))
               + occ[..., lx - hx:].sum(axis=(1, 3, 5))).reshape(-1)
              if px > 1 else zeros),
    }
    out = {
        "atoms_per_device": _dist(nlocal),
        "atoms_per_device_list": nlocal.tolist(),
        "ghost_cells_per_device": shell_cells,
        "halo_extent_cells": h,
    }
    for ax, sizes in swaps.items():
        out[f"swap_atoms_{ax}_per_device"] = _dist(sizes)
    if ssim.interval_stamps:
        arr = np.asarray(ssim.interval_stamps, dtype=float)  # (intervals, 3)
        for i, name in enumerate(("force", "comm", "neigh")):
            out[f"time_{name}_per_device"] = _dist(
                np.full(pz * py * px, float(arr[:, i].sum())))
            out[f"time_{name}_intervals"] = _dist(arr[:, i])
        out["time_per_device_note"] = (
            "one process issues every domain's work in turn and each stamp "
            "follows a sync of the mesh's cards, so a phase's time is the "
            "same for every domain (the run's total); the interval "
            "distributions carry the run's variance")
        out["time_attribution_note"] = (
            "measured stamps of run_timed: comm is the halo (with the fp "
            "halo and the half paths' Newton folds), neigh the migration, "
            "force the rest")
    return out


def yaml_report(sim, rows, timer, *, nprocs=1, screen=False,
                extra_stats=None) -> str:
    """Write the YAML run report (output.cpp:105-493) to
    miniMD-<date>-<time>.yaml in the working directory; returns its path.
    nprocs: the domains of a decomposed run; extra_stats: more statistics
    (per_device_statistics)."""
    inp = sim.inp
    t = timer.array
    t_total, t_force, t_neigh, t_comm = (t[TIME_TOTAL], t[TIME_FORCE],
                                         t[TIME_NEIGH], t[TIME_COMM])
    t_other = max(t_total - t_force - t_neigh - t_comm, 0.0)
    devices = ([sim.device] if hasattr(sim, "device") else
               [dev for dev, _ in sim.router.groups])
    device = ", ".join(torch.cuda.get_device_name(d) if d.type == "cuda"
                       else "cpu" for d in devices)

    lines = []
    a = lines.append
    a("run_configuration:")
    a(f"  variant: {VARIANT}")
    a(f"  device: {device}")
    a(f"  mpi_processes: {nprocs}")
    a("  host_threads: 1")
    a(f"  inputfile: {getattr(inp, 'source', 'deck')}")
    a(f"  datafile: {inp.datafile or 'None'}")
    a(f"  units: {'LJ' if inp.units == UNITS_LJ else 'METAL'}")
    a(f"  atoms: {sim.natoms}")
    a(f"  system_size: [{sim.geom.prd[0]:.2f}, {sim.geom.prd[1]:.2f}, "
      f"{sim.geom.prd[2]:.2f}]")
    a(f"  unit_cells: [{inp.nx}, {inp.ny}, {inp.nz}]")
    a(f"  density: {inp.rho}")
    a(f"  force_type: {'LJ' if inp.forcetype == FORCE_LJ else 'EAM'}")
    a(f"  force_params: [{inp.epsilon}, {inp.sigma}]")
    a(f"  force_cutoff: {inp.force_cut}")
    a(f"  neighbor_cutoff: {inp.neigh_cut}")
    a(f"  half_neighbor: {int(sim.half_neigh)}")
    a(f"  ghost_newton: {int(sim.ghost_newton)}")
    a(f"  neighbor_bins: [{sim.geom.nb[0]}, {sim.geom.nb[1]}, "
      f"{sim.geom.nb[2]}]")
    a(f"  cell_capacity: {sim.geom.capacity}")
    a(f"  neighbor_frequency: {inp.neigh_every}")
    a(f"  timestep_size: {inp.dt}")
    a(f"  thermo_frequency: {inp.thermo_nstat}")
    a("")
    a("thermodynamic_output:")
    for r in rows:
        a(f"  - {{step: {int(r[0])}, T: {r[1]:.6e}, U: {r[2]:.6e}, "
          f"P: {r[3]:.6e}}}")
    a("")
    a(f"conservation_ratio: {conservation_ratio(rows):.6f}")
    if inp.forcetype == FORCE_LJ:
        engcorr, prscorr = tail_corrections(inp.rho, inp.force_cut)
        a(f"long_range_tail_corrections: {{energy: {engcorr:.6e}, "
          f"pressure: {prscorr:.6e}}}")
    a(f"lost_atoms: {lost_atom_check(sim)}")
    a("")
    a("time:")
    a(f"  total: {t_total:.6f}")
    a(f"  force: {t_force:.6f}")
    a(f"  neigh: {t_neigh:.6f}")
    a(f"  comm: {t_comm:.6f}")
    a(f"  other: {t_other:.6f}")
    a("")
    a("performance:")
    if t_total > 0:
        a(f"  atom_steps_per_second: {sim.natoms * inp.ntimes / t_total:.1f}")
    a("")
    a("statistics:")
    stats = run_statistics(sim)
    stats.update(extra_stats or {})
    for name, vals in stats.items():
        if isinstance(vals, dict):
            a(f"  {name}:")
            for k, vv in vals.items():
                a(f"    {k}: {vv}")
        else:
            a(f"  {name}: {vals}")
    text = "\n".join(lines) + "\n"

    path = f"miniMD-{time.strftime('%Y%m%d-%H%M%S')}.yaml"
    with open(path, "w") as f:
        f.write(text)
    if screen:
        print(text)
    return path
