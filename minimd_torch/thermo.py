"""Thermodynamic reductions: temperature, potential energy, pressure
(ref/thermo.cpp:119-194). They compute on the tensors' device; empty slots
carry zero velocity, and energy and virial come pre-reduced from the force
kernels."""

from __future__ import annotations

import torch

from .units import ThermoScales


# elements a thread sums into one value in ordered_sum
SUM_BLOCK = 4096


def ordered_sum(t: torch.Tensor, lead: int = 0,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """The sum over every axis of t past the first `lead` (accumulated in
    `dtype`, default t's), in an order that no CPU thread count changes.

    A CPU reduction into one value splits its elements among the OpenMP
    threads that join it and adds their partial sums, so its bits follow
    how many joined; a reduction into many values gives each value to one
    thread. So on the CPU the elements are summed in blocks of SUM_BLOCK,
    one value a block, and the block sums again the same way until one
    block is left. A CUDA reduction's order is fixed by the shape and the
    card, so there it is one sum, the same ops as a plain torch.sum."""
    if t.device.type != "cpu":
        if lead == 0:
            return t.sum(dtype=dtype)
        return t.reshape(*t.shape[:lead], -1).sum(dim=-1, dtype=dtype)
    t = t.reshape(*t.shape[:lead], -1)
    if dtype is not None:
        t = t.to(dtype)
    while t.shape[-1] > SUM_BLOCK:
        n = t.shape[-1] // SUM_BLOCK * SUM_BLOCK
        parts = [t[..., :n].unflatten(-1, (-1, SUM_BLOCK)).sum(dim=-1)]
        if n < t.shape[-1]:
            parts.append(t[..., n:].sum(dim=-1, keepdim=True))
        t = torch.cat(parts, dim=-1)
    return t.sum(dim=-1)


def temperature(v: torch.Tensor, mass: float, scales: ThermoScales):
    """t = sum(m * v^2) * t_scale (thermo.cpp:140-174). The sum and the
    scaling are float64 in any working dtype: in float32 they would move
    the requested temperature of a fresh system (600 K for the EAM deck)
    by ~1e-7 relative, past the printed digits of a thermo row."""
    return ordered_sum(v * v, dtype=torch.float64) * (mass * scales.t_scale)


def energy(eng_vdwl, natoms: int, scales: ThermoScales):
    """Potential energy per atom (thermo.cpp:119-136), full neighbors."""
    return eng_vdwl * scales.e_scale / natoms


def pressure(t, virial, scales: ThermoScales):
    """(T*dof_boltz + sum virial) * p_scale (thermo.cpp:181-194)."""
    return (t * scales.dof_boltz + virial) * scales.p_scale
