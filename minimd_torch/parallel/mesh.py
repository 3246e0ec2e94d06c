"""The mesh of a spatially decomposed run: the processor grid and the
domains laid on it.

The reference chooses its 3-D processor grid by minimizing subdomain
surface area over all factorizations of nprocs (ref/comm.cpp:86-126);
min_surface_grid is that choice, as minimd_tpu/parallel/mesh.py makes it.
A domain owns one block of cells and lives on a torch.device; devices
may repeat, so ["cuda:0"] * 8 runs a 2x2x2 decomposition on one card and
["cpu"] * 8 is the tests' mesh. Domain k sits at mesh coordinate
(iz, iy, ix) with k = (iz*py + iy)*px + ix, the order of the JAX
package's Mesh('z', 'y', 'x') device array.

The domains of one device form a group whose tensors are stacked on a
leading domain axis, so that an elementwise step is one launch per
device whatever the number of domains (`Mesh.groups`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXES = ("z", "y", "x")   # mesh axis order; grid axis 0 is z, 2 is x


def min_surface_grid(nprocs: int, prd) -> tuple[int, int, int]:
    """Factorize nprocs into (px, py, pz) minimizing subdomain surface
    (comm.cpp:86-126)."""
    prd = np.asarray(prd, dtype=float)
    area = (prd[0] * prd[1], prd[0] * prd[2], prd[1] * prd[2])
    best = None
    best_surf = np.inf
    for px in range(1, nprocs + 1):
        if nprocs % px:
            continue
        rem = nprocs // px
        for py in range(1, rem + 1):
            if rem % py:
                continue
            pz = rem // py
            surf = area[0] / px / py + area[1] / px / pz + area[2] / py / pz
            if surf < best_surf:
                best_surf = surf
                best = (px, py, pz)
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape: {"z": pz, "y": py, "x": px}; devices: (pz, py, px) array of
    torch.device, domain k at devices.flat[k]."""

    shape: dict
    devices: np.ndarray

    @property
    def size(self) -> int:
        return self.devices.size

    def coord(self, k: int) -> dict:
        """{"z": iz, "y": iy, "x": ix} of domain k."""
        iz, iy, ix = np.unravel_index(k, self.devices.shape)
        return {"z": int(iz), "y": int(iy), "x": int(ix)}

    def domain(self, c: dict) -> int:
        return int(np.ravel_multi_index(
            tuple(c[a] for a in AXES), self.devices.shape))

    def ring(self, k: int, name: str, j: int) -> int:
        """The domain j steps from k along mesh axis `name`, periodic."""
        c = self.coord(k)
        c[name] = (c[name] + j) % self.shape[name]
        return self.domain(c)

    @property
    def decomposed(self) -> tuple[bool, bool, bool]:
        """Per spatial axis (x, y, z): whether the mesh splits it."""
        return tuple(self.shape[a] > 1 for a in ("x", "y", "z"))

    @property
    def groups(self) -> list[tuple[torch.device, list[int]]]:
        """(device, its domains in domain order), devices in order of
        first appearance. Concatenating the groups' stacked tensors gives
        the domains in `order`."""
        out: dict = {}
        for k, dev in enumerate(self.devices.flat):
            out.setdefault(dev, []).append(k)
        return list(out.items())

    @property
    def order(self) -> list[int]:
        """The domains in the order of the groups' concatenation."""
        return [k for _, ks in self.groups for k in ks]


def mesh_devices(n: int, device: str = "cuda") -> list[str]:
    """The devices of n domains: "cuda" places them on the visible cards
    in turn (cuda:i % count, so one card may hold them all), "cpu" all on
    the CPU. Raises without a card for "cuda", never falling back to the
    CPU."""
    if device == "cpu":
        return ["cpu"] * n
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device 'cpu' for "
                           "the CPU")
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def make_mesh(devices, prd, grid: tuple[int, int, int] | None = None) -> Mesh:
    """A (pz, py, px) mesh over `devices` (anything torch.device takes),
    shaped by the min-surface factorization unless `grid` = (px, py, pz)
    is given."""
    devs = [torch.device(d) for d in devices]
    if torch.cuda.is_available():   # "cuda" and "cuda:0" are one device
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    n = len(devs)
    if grid is None:
        grid = min_surface_grid(n, prd)
    px, py, pz = grid
    if px * py * pz != n:
        raise ValueError(f"mesh {grid} does not hold {n} domains")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(shape={"z": pz, "y": py, "x": px},
                devices=arr.reshape(pz, py, px))


class Router:
    """Copies between the domains of a mesh, for tensors held per group
    (a list, one tensor per `mesh.groups` entry, its dim 0 running over
    the group's domains in domain order). A group receives from another
    only the entries it reads (the counterpart of the JAX package's
    per-hop ppermute): `pull` ships each source group's selection in one
    index_select and one copy. The index tensors are built once per route
    and kept on their devices, so a copy queues no host-to-device
    transfer (which would wait on the card). With one group nothing is
    copied."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.groups = mesh.groups
        self.pos = {k: p for p, k in enumerate(mesh.order)}
        # domain -> (its group, its index in the group)
        self.where = {k: (g, i) for g, (_, ks) in enumerate(self.groups)
                      for i, k in enumerate(ks)}
        self._routes: dict = {}

    def pull(self, flat, sends, dim: int = 0) -> list[torch.Tensor]:
        """Per group g: flat[g] followed, along dim, by the entries of
        flat[s] that sends[g] lists for each other group s, as pairs (s,
        index on s's device), in the order of sends[g]; each selection is
        made on its source's device and copied once."""
        out = []
        for g, (dev, _) in enumerate(self.groups):
            parts = [flat[g]] + [
                flat[s].index_select(dim, i).to(
                    dev, non_blocking=dev.type == "cuda")
                for s, i in sends[g]]
            out.append(parts[0] if len(parts) == 1
                       else torch.cat(parts, dim=dim))
        return out

    def _index(self, src: tuple):
        """(sends, per group the index of each of its domains' sources in
        the pulled tensor) of gather(src)."""
        if src not in self._routes:
            sends, idx = [], []
            for g, (dev, ks) in enumerate(self.groups):
                need = {}     # source group -> its distinct positions
                for k in ks:
                    s, i = self.where[src[k]]
                    if s != g:
                        need.setdefault(s, set()).add(i)
                base, at, send = len(ks), {}, []
                for s in sorted(need):
                    rows = sorted(need[s])
                    at.update({(s, i): base + r for r, i in enumerate(rows)})
                    send.append((s, torch.tensor(rows,
                                                 device=self.groups[s][0])))
                    base += len(rows)
                sends.append(send)
                idx.append(torch.tensor(
                    [self.where[src[k]][1] if self.where[src[k]][0] == g
                     else at[self.where[src[k]]] for k in ks], device=dev))
            self._routes[src] = (sends, idx)
        return self._routes[src]

    def gather(self, parts, src) -> list[torch.Tensor]:
        """Per group: entry i (domain k = group's i-th) is the entry of
        domain src[k] of `parts`; a group receives only the entries of the
        other groups' domains that its own read."""
        sends, idx = self._index(tuple(src))
        return [p.index_select(0, i) for p, i in
                zip(self.pull(parts, sends), idx)]

    def ring(self, parts, name: str, j: int) -> list[torch.Tensor]:
        """Per domain k: the entry of the domain j steps along mesh axis
        `name` (what k receives when every domain sends to the one -j
        steps from it)."""
        return self.gather(parts, [self.mesh.ring(k, name, j)
                                   for k in range(self.mesh.size)])

    def split(self, parts) -> list[torch.Tensor]:
        """Per domain, in domain order: its entry of `parts`."""
        out = [None] * self.mesh.size
        for (_, ks), p in zip(self.groups, parts):
            for i, k in enumerate(ks):
                out[k] = p[i]
        return out

    def stack(self, per_domain) -> list[torch.Tensor]:
        """The inverse of split: per group, its domains' tensors stacked."""
        return [torch.stack([per_domain[k].to(dev) for k in ks])
                for dev, ks in self.groups]

    def domain_sum(self, parts) -> torch.Tensor:
        """The sum over every domain of `parts` (one value per domain),
        reduced in domain order on the first group's device (the psum of
        the JAX package's mesh: a few numbers a step)."""
        if len(self.groups) == 1:   # the group's order is domain order
            return parts[0].sum(dim=0)
        dev = self.groups[0][0]
        if "sum" not in self._routes:
            self._routes["sum"] = torch.tensor(
                [self.pos[k] for k in range(self.mesh.size)], device=dev)
        full = torch.cat([p.to(dev, non_blocking=dev.type == "cuda")
                          for p in parts])
        return full.index_select(0, self._routes["sum"]).sum(dim=0)
