"""Unit-system scale factors for thermodynamic reductions.

Mirrors ref/thermo.cpp:57-71 (LJ and METAL unit systems). A copy of
minimd_tpu.units.
"""

from __future__ import annotations

import dataclasses

from .config import UNITS_LJ, UNITS_METAL


@dataclasses.dataclass(frozen=True)
class ThermoScales:
    mvv2e: float
    dof_boltz: float
    t_scale: float
    p_scale: float
    e_scale: float


def thermo_scales(units: int, natoms: int, volume: float) -> ThermoScales:
    if units == UNITS_LJ:
        mvv2e = 1.0
        dof_boltz = float(natoms * 3 - 3)
        return ThermoScales(
            mvv2e=mvv2e,
            dof_boltz=dof_boltz,
            t_scale=mvv2e / dof_boltz,
            p_scale=1.0 / 3.0 / volume,
            e_scale=0.5,
        )
    if units == UNITS_METAL:
        mvv2e = 1.036427e-04
        dof_boltz = (natoms * 3 - 3) * 8.617343e-05
        return ThermoScales(
            mvv2e=mvv2e,
            dof_boltz=dof_boltz,
            t_scale=mvv2e / dof_boltz,
            p_scale=1.602176e+06 / 3.0 / volume,
            e_scale=524287.985533,  # the reference's METAL energy scale (thermo.cpp:68)
        )
    raise ValueError(f"unknown unit system {units}")
