"""Checkpoint and resume (a port of minimd_tpu/checkpoint.py): a
Simulation or a ShardedSimulation is saved alike (the latter through its
gathered state), and resumes as either.

The reference has no checkpoint (its only state-load path is the LAMMPS
data reader). A checkpoint is a compact .npz of the valid atoms' positions
(folded into the box), velocities and types, the box, the mass, the step,
the original run's step-0 thermo row and the deck, with the JAX package's
keys: a file written by either package resumes in the other. The port
also writes the force options (half_neigh, ghost_newton), which a resume
takes unless told otherwise; the JAX package ignores them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import In


def save(path, sim, step: int = 0):
    """Write a checkpoint of the live state of a Simulation or a
    ShardedSimulation."""
    st = sim.state        # a ShardedSimulation gathers it on each read
    valid = st.valid.cpu().numpy()
    x = st.x.cpu().numpy().T[valid]
    prd = np.asarray(sim.geom.prd)
    x = x - np.floor(x / prd) * prd          # fold unfolded storage coords
    # provenance: the original trajectory's step-0 row (a Simulation's
    # _row0, a ShardedSimulation's row0), so a resumed run's numbering and
    # conservation ratio continue the original run
    row0 = getattr(sim, "_row0", None) or getattr(sim, "row0", None)
    np.savez_compressed(
        path,
        x=x,
        v=st.v.cpu().numpy().T[valid],
        typ=st.typ.cpu().numpy()[valid],
        prd=prd,
        mass=sim.mass,
        step=step,
        row0=np.asarray(row0 if row0 is not None else [0, 0.0, 0.0, 0.0],
                        dtype=np.float64),
        deck=np.array([dataclasses.asdict(sim.inp)], dtype=object),
        half_neigh=bool(sim.half_neigh),
        ghost_newton=bool(sim.ghost_newton),
    )


def _saved_options(path) -> dict:
    """The force options a checkpoint was written with (none in a file
    of the JAX package)."""
    z = np.load(path, allow_pickle=True)
    return {k: bool(z[k]) for k in ("half_neigh", "ghost_newton") if k in z}


def load(path):
    """Returns (In, box prd, x, v, typ, mass, step, row0); the deck keeps
    only the fields of this package's In."""
    z = np.load(path, allow_pickle=True)
    deck = z["deck"][0]
    inp = In(**{k: v for k, v in deck.items() if k in In.__dataclass_fields__})
    row0 = None
    if "row0" in z:
        r = z["row0"]
        row0 = (int(r[0]), float(r[1]), float(r[2]), float(r[3]))
    return (inp, z["prd"], z["x"], z["v"], z["typ"], float(z["mass"]),
            int(z["step"]), row0)


def resume(path, **sim_kwargs):
    """Rebuild a Simulation from a checkpoint; returns (sim, step). The
    keyword arguments are Simulation.from_arrays' (dtype, device, nbins,
    capacity, half_neigh, ...), so a resumed run takes the same options
    as a fresh one, grow-and-replay included; half_neigh and ghost_newton
    default to the saved run's."""
    from .sim import Simulation

    inp, prd, x, v, typ, mass, step, row0 = load(path)
    sim = Simulation.from_arrays(inp, prd, x, v, typ, mass,
                                 **{**_saved_options(path), **sim_kwargs})
    if row0 is not None:
        # step 0's row and the conservation baseline belong to the
        # original run, not to the restored instant
        sim._row0 = row0
    return sim, step


def resume_sharded(path, devices=None, **kwargs):
    """Rebuild a ShardedSimulation from a checkpoint; returns (ssim,
    step). devices: one entry per domain (ShardedSimulation.from_arrays'
    default: one domain per visible card); the keyword arguments are
    from_arrays' (dtype, nbins, half_neigh, ...); half_neigh and
    ghost_newton default to the saved run's. The original run's step-0
    row is kept."""
    from .parallel import ShardedSimulation

    inp, prd, x, v, typ, mass, step, row0 = load(path)
    ssim = ShardedSimulation.from_arrays(
        inp, prd, x, v, typ, mass, devices=devices, row0=row0,
        **{**_saved_options(path), **kwargs})
    return ssim, step
