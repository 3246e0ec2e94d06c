"""The MD state (the reference's Atom class, ref/atom.h:47, as a
fixed-capacity cell-major padded layout of tensors)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cells import CellGeometry, rebin, sentinel_positions


@dataclasses.dataclass
class MDState:
    """Cell-major padded atom state, SoA layout (coordinate-major). Slot i
    belongs to cell i // C."""

    x: torch.Tensor       # (3, M) positions; sentinels in empty slots
    v: torch.Tensor       # (3, M) velocities; zero in empty slots
    f: torch.Tensor       # (3, M) forces; zero in empty slots
    typ: torch.Tensor     # (M,)  int32 atom types
    valid: torch.Tensor   # (M,)  bool occupancy mask
    overflow: int         # cumulative cell-capacity overflows

    def clone(self) -> "MDState":
        return MDState(x=self.x.clone(), v=self.v.clone(), f=self.f.clone(),
                       typ=self.typ.clone(), valid=self.valid.clone(),
                       overflow=self.overflow)


def init_state(x_np: np.ndarray, v_np: np.ndarray, typ_np: np.ndarray,
               geom: CellGeometry, dtype=torch.float32,
               device="cpu") -> MDState:
    """Pad host arrays to capacity and stable-sort them into the cell
    layout (the same in-cell order as minimd_tpu.state.init_state)."""
    n = len(x_np)
    M = geom.nslots
    if n > M:
        raise ValueError(f"{n} atoms exceed cell layout capacity {M}")

    x = sentinel_positions(M, dtype, device)
    x[:, :n] = torch.as_tensor(np.asarray(x_np).T, dtype=dtype).to(device)
    v = torch.zeros((3, M), dtype=dtype, device=device)
    v[:, :n] = torch.as_tensor(np.asarray(v_np).T, dtype=dtype).to(device)
    typ = torch.zeros((M,), dtype=torch.int32, device=device)
    typ[:n] = torch.as_tensor(np.asarray(typ_np), dtype=torch.int32).to(device)
    valid = torch.zeros((M,), dtype=torch.bool, device=device)
    valid[:n] = True

    x, v, typ, valid, ovf = rebin(x, v, typ, valid, geom)
    f = torch.zeros((3, M), dtype=dtype, device=device)
    return MDState(x=x, v=v, f=f, typ=typ, valid=valid, overflow=int(ovf))


def state_from_numpy(x, v, f, typ, valid, overflow, device="cpu",
                     dtype=torch.float32) -> MDState:
    """A state carried across from the JAX package: its MDState fields as
    numpy arrays (x, v, f (3, M); typ, valid (M,); overflow a scalar),
    laid out in the same geometry (see geometry_from_reference)."""
    def t(a, dt):
        return torch.as_tensor(np.array(a), dtype=dt).to(device)

    return MDState(x=t(x, dtype), v=t(v, dtype), f=t(f, dtype),
                   typ=t(typ, torch.int32), valid=t(valid, torch.bool),
                   overflow=int(np.asarray(overflow)))


def state_from_reference(s, device="cpu", dtype=torch.float32) -> MDState:
    """Carry a minimd_tpu MDState (its x, v, f, typ, valid and overflow
    fields, read as numpy arrays) into the port, in the same geometry
    (see geometry_from_reference); Simulation.from_state runs it."""
    return state_from_numpy(*(np.asarray(getattr(s, k)) for k in
                              ("x", "v", "f", "typ", "valid", "overflow")),
                            device=device, dtype=dtype)


def geometry_from_reference(g) -> CellGeometry:
    """Copy the fields of a minimd_tpu CellGeometry into the port's."""
    return CellGeometry(
        nb=tuple(int(n) for n in g.nb),
        binsize=tuple(float(b) for b in g.binsize),
        capacity=int(g.capacity),
        stencil=np.array(g.stencil),
        cand_cell=np.array(g.cand_cell),
        cand_shift=np.array(g.cand_shift),
        prd=tuple(float(p) for p in g.prd),
        offset=tuple(float(o) for o in g.offset),
    )
