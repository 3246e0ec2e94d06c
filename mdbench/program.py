"""The system under test, minimd_torch, through its public entries only:
Simulation.from_arrays / run on one device, ShardedSimulation.from_arrays
/ run with one domain per device. The only module of the benchmark that
imports the program; it hands the program the benchmark's own arrays and
reads back what the program produced.
"""

from __future__ import annotations

import numpy as np
import torch

# the Simulation closures the traced run puts spans around
SPANS = ("force_fn", "force_fn_noev", "step_fn", "rebin_fn")


def deck(cfg: dict, lattice, steps: int):
    """The configuration as minimd_torch's deck record."""
    from minimd_torch.config import (FORCE_EAM, FORCE_LJ, UNITS_LJ,
                                     UNITS_METAL, In)

    return In(units={"lj": UNITS_LJ, "metal": UNITS_METAL}[cfg["units"]],
              datafile=None,
              forcetype={"lj": FORCE_LJ, "eam": FORCE_EAM}[cfg["style"]],
              epsilon=cfg["epsilon"], sigma=cfg["sigma"],
              nx=lattice[0], ny=lattice[1], nz=lattice[2], ntimes=steps,
              dt=cfg["dt"], t_request=cfg["temperature"], rho=cfg["density"],
              neigh_every=cfg["neigh_every"], force_cut=cfg["force_cut"],
              neigh_cut=cfg["force_cut"] + cfg["skin"],
              thermo_nstat=cfg["thermo_every"])


class Program:
    """One simulation of the program on `devices` (one entry: a
    Simulation; more: a ShardedSimulation, one domain each)."""

    def __init__(self, cfg, lattice, inputs, devices, steps,
                 potential=None):
        inp = deck(cfg, lattice, steps)
        self.devices = [torch.device(d) for d in devices]
        args = (inp, inputs.box, inputs.x, inputs.v, inputs.typ,
                inputs.mass)
        pot = None if potential is None else str(potential)
        if len(devices) == 1:
            from minimd_torch.sim import Simulation
            self.sim = Simulation.from_arrays(
                *args, ntypes=cfg["ntypes"], dtype=torch.float32,
                device=devices[0], potential_path=pot)
            self.sharded = False
        else:
            from minimd_torch.parallel import ShardedSimulation
            self.sim = ShardedSimulation.from_arrays(
                *args, devices=list(devices), dtype=torch.float32,
                potential_path=pot)
            self.sharded = True

    def run(self, steps: int) -> np.ndarray:
        return self.sim.run(steps)

    def row0(self, trace) -> tuple:
        return tuple(self.sim.thermo_trace(trace)[0][1:])

    def layout(self) -> tuple:
        return (tuple(self.sim.geom.nb), int(self.sim.geom.capacity))

    def overflow(self) -> int:
        return 0 if self.sharded else int(self.sim.state.overflow)

    def snapshot(self) -> dict:
        """The state in the global cell layout, as numpy: x, v, f (3, M),
        typ (M,), and the grid that lays it out."""
        st = self.sim.state
        g = self.sim.geom
        out = {k: getattr(st, k).detach().to("cpu", copy=True).numpy()
               for k in ("x", "v", "f", "typ")}
        out.update(nb=tuple(g.nb), capacity=int(g.capacity),
                   prd=tuple(g.prd), offset=tuple(g.offset))
        return out

    def add_spans(self):
        """Wrap the instance's closures in profiler ranges named
        sim.<closure> (a Simulation's; a ShardedSimulation's are inside
        its run)."""
        if self.sharded:
            return
        for name in SPANS:
            fn = getattr(self.sim, name)
            if fn is not None:
                setattr(self.sim, name, _span(f"sim.{name}", fn))

    def sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def _span(name, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call
