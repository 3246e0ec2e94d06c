"""Lennard-Jones 12-6 parameters (ref/force_lj.cpp:420-430):

    sr2 = 1/r^2; sr6 = sr2^3 * sigma6; F = 48*sr6*(sr6-0.5)*sr2*eps
    eng += sr6*(sr6-1)*eps   (x4.0 at the end)
    virial += r^2*F          (x0.5 at the end)

A copy of minimd_tpu.ops.lj.LJParams, whose module imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LJParams:
    """Per-type-pair tables, flattened (ntypes*ntypes,) like the reference."""

    ntypes: int
    epsilon: np.ndarray    # (nt*nt,)
    sigma6: np.ndarray     # (nt*nt,)
    cutforcesq: np.ndarray  # (nt*nt,)

    @property
    def uniform(self) -> bool:
        return bool(
            np.all(self.epsilon == self.epsilon[0])
            and np.all(self.sigma6 == self.sigma6[0])
            and np.all(self.cutforcesq == self.cutforcesq[0])
        )

    @staticmethod
    def from_deck(ntypes: int, epsilon: float, sigma: float, cutforce: float) -> "LJParams":
        n = ntypes * ntypes
        return LJParams(
            ntypes=ntypes,
            epsilon=np.full(n, epsilon),
            sigma6=np.full(n, sigma ** 6),
            cutforcesq=np.full(n, cutforce * cutforce),
        )
