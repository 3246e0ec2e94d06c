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


@dataclasses.dataclass
class ShardedState:
    """The state of a decomposed run (minimd_torch/parallel): per device
    group of the mesh (Mesh.groups), the group's domains stacked on a
    leading axis, each domain a cell-major block of its own cells
    (x, v, f (Dg, 3, M_local); typ, valid (Dg, M_local))."""

    x: list
    v: list
    f: list
    typ: list
    valid: list

    def clone(self) -> "ShardedState":
        return ShardedState(*([t.clone() for t in getattr(self, k)]
                              for k in ("x", "v", "f", "typ", "valid")))


def _domain_blocks(mesh, nb):
    """Per domain, in domain order, the (z, y, x) slices of its cells in
    a global (nbz, nby, nbx) grid."""
    lx, ly, lz = (nb[0] // mesh.shape["x"], nb[1] // mesh.shape["y"],
                  nb[2] // mesh.shape["z"])
    out = []
    for k in range(mesh.size):
        c = mesh.coord(k)
        out.append((slice(c["z"] * lz, (c["z"] + 1) * lz),
                    slice(c["y"] * ly, (c["y"] + 1) * ly),
                    slice(c["x"] * lx, (c["x"] + 1) * lx)))
    return out


def sharded_from_grid(x, v, f, typ, valid, mesh, geom: CellGeometry,
                      dtype=torch.float32) -> ShardedState:
    """The per-domain state from global grid-shaped arrays, numpy or
    torch: x, v, f (3, nbz, nby, nbx, C), typ, valid (nbz, nby, nbx, C),
    as a JAX ShardedSimulation holds them (its `arrays`, read as numpy)
    and as sharded_to_grid gives them back."""
    blocks = _domain_blocks(mesh, geom.nb)
    dt = {"x": dtype, "v": dtype, "f": dtype, "typ": torch.int32,
          "valid": torch.bool}
    out = {}
    for name, a in (("x", x), ("v", v), ("f", f), ("typ", typ),
                    ("valid", valid)):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        per = [(a[:, zs, ys, xs] if a.dim() == 5 else a[zs, ys, xs])
               for zs, ys, xs in blocks]
        out[name] = [torch.stack([per[k].reshape(
            (3, -1) if a.dim() == 5 else (-1,)) for k in ks]).to(
                device=dev, dtype=dt[name]).contiguous()
            for dev, ks in mesh.groups]
    return ShardedState(**out)


def sharded_to_grid(state: ShardedState, mesh, geom: CellGeometry):
    """The inverse of sharded_from_grid: (x, v, f, typ, valid) as numpy
    grid-shaped arrays in the global cell layout."""
    nbx, nby, nbz = geom.nb
    C = geom.capacity
    blocks = _domain_blocks(mesh, geom.nb)
    lz, ly, lx = (blocks[0][0].stop - blocks[0][0].start,
                  blocks[0][1].stop - blocks[0][1].start,
                  blocks[0][2].stop - blocks[0][2].start)
    out = []
    for name in ("x", "v", "f", "typ", "valid"):
        parts = getattr(state, name)
        vec = parts[0].dim() == 3
        first = parts[0].detach().cpu().numpy()
        g = np.zeros(((3,) if vec else ()) + (nbz, nby, nbx, C), first.dtype)
        for (dev, ks), p in zip(mesh.groups, parts):
            p = p.detach().cpu().numpy()
            for i, k in enumerate(ks):
                zs, ys, xs = blocks[k]
                if vec:
                    g[:, zs, ys, xs] = p[i].reshape(3, lz, ly, lx, C)
                else:
                    g[zs, ys, xs] = p[i].reshape(lz, ly, lx, C)
        out.append(g)
    return tuple(out)
