"""A short decomposed run on a small mesh: the port's counterpart of the
JAX package's dryrun_multichip (the repository's __graft_entry__.py).

    python -m minimd_torch.parallel.dryrun [N] [--device cuda|cpu]

The LJ deck at 16^3 unit cells (16,384 atoms) on N domains (default 8),
a cell grid that the mesh divides, reneighboring (and so migrating) every
step, two steps. It checks that the rows are finite, that nothing
overflowed and that no atom was lost, and prints one `ok` line. With
--device cuda the domains go to the visible cards in turn (one card may
hold them all: the mesh is a list of domains in one process); --device
cpu runs them on the CPU (the plain paths).
"""

from __future__ import annotations

import argparse

import numpy as np


def dryrun_multichip(n_devices: int = 8, device: str = "cuda"):
    """Two steps of ShardedSimulation on n_devices domains with a
    migration at each; raises AssertionError when a check fails and
    returns the ShardedSimulation."""
    from ..config import builtin_deck
    from . import ShardedSimulation
    from .mesh import mesh_devices, min_surface_grid

    inp = builtin_deck("lj")
    inp.nx = inp.ny = inp.nz = 16
    inp.neigh_every = 1
    grid = min_surface_grid(n_devices, (1.0, 1.0, 1.0))
    nbins = tuple(g * max(1, 8 // g) for g in grid)
    ssim = ShardedSimulation.from_input(
        inp, devices=mesh_devices(n_devices, device), nbins=nbins)
    state, ovf, trace = ssim.run_fn(ssim.state_.clone(), 2)
    trace = trace.double().cpu().numpy()
    ovf = ovf.cpu().numpy()
    if not np.all(np.isfinite(trace)):
        raise AssertionError(f"rows not finite: {trace}")
    # [movement, capacity, buffer] counts (parallel/comm.py)
    if int(ovf.sum()) != 0:
        raise AssertionError(f"migration overflow: {ovf}")
    ssim.state_ = state
    kept = int(ssim.state.valid.sum())
    if kept != ssim.natoms:
        raise AssertionError(f"atoms lost in migration: {kept} of "
                             f"{ssim.natoms}")
    t, u, p = trace[-1]
    print(f"dryrun_multichip({n_devices}) ok: mesh={ssim.mesh.shape} "
          f"nb={ssim.geom.nb} devices={sorted(set(ssim.devices))} 2 steps "
          f"w/ migration, T={t:.4f} U={u:.4f} P={p:.4f}")
    return ssim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
