"""Checkpoint and resume (a port of minimd_tpu/checkpoint.py's
single-device part).

The reference has no checkpoint (its only state-load path is the LAMMPS
data reader). A checkpoint is a compact .npz of the valid atoms' positions
(folded into the box), velocities and types, the box, the mass, the step,
the original run's step-0 thermo row and the deck, with the JAX package's
keys: a file written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import In


def save(path, sim, step: int = 0):
    """Write a checkpoint of the live simulation state."""
    valid = sim.state.valid.cpu().numpy()
    x = sim.state.x.cpu().numpy().T[valid]
    prd = np.asarray(sim.geom.prd)
    x = x - np.floor(x / prd) * prd          # fold unfolded storage coords
    # provenance: the original trajectory's step-0 row, so a resumed run's
    # numbering and conservation ratio continue the original run
    row0 = getattr(sim, "_row0", None)
    np.savez_compressed(
        path,
        x=x,
        v=sim.state.v.cpu().numpy().T[valid],
        typ=sim.state.typ.cpu().numpy()[valid],
        prd=prd,
        mass=sim.mass,
        step=step,
        row0=np.asarray(row0 if row0 is not None else [0, 0.0, 0.0, 0.0],
                        dtype=np.float64),
        deck=np.array([dataclasses.asdict(sim.inp)], dtype=object),
    )


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
    as a fresh one, grow-and-replay included."""
    from .sim import Simulation

    inp, prd, x, v, typ, mass, step, row0 = load(path)
    sim = Simulation.from_arrays(inp, prd, x, v, typ, mass, **sim_kwargs)
    if row0 is not None:
        # step 0's row and the conservation baseline belong to the
        # original run, not to the restored instant
        sim._row0 = row0
    return sim, step
