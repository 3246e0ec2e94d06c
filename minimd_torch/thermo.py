"""Thermodynamic reductions: temperature, potential energy, pressure
(ref/thermo.cpp:119-194). They compute on the tensors' device in the
working dtype; empty slots carry zero velocity, and energy and virial come
pre-reduced from the force kernels."""

from __future__ import annotations

import torch

from minimd_tpu.units import ThermoScales


def temperature(v: torch.Tensor, mass: float, scales: ThermoScales):
    """t = sum(m * v^2) * t_scale (thermo.cpp:140-174)."""
    return torch.sum(v * v) * mass * scales.t_scale


def energy(eng_vdwl, natoms: int, scales: ThermoScales):
    """Potential energy per atom (thermo.cpp:119-136), full neighbors."""
    return eng_vdwl * scales.e_scale / natoms


def pressure(t, virial, scales: ThermoScales):
    """(T*dof_boltz + sum virial) * p_scale (thermo.cpp:181-194)."""
    return (t * scales.dof_boltz + virial) * scales.p_scale
