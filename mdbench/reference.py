"""The plain reference of the benchmark: miniMD's Lennard-Jones and EAM
(DYNAMO funcfl) forces, energy and virial on a periodic box, its thermo
row, its velocity-Verlet step and an audit of a cell-major atom layout, in
plain PyTorch and NumPy.

It is written from miniMD's own description (ref/force_lj.cpp,
ref/force_eam.cpp, ref/thermo.cpp, ref/integrate.cpp) and imports nothing
of the program under test: it gets positions, velocities and types as
arrays and works out every table, grid and constant itself.

Every function takes a `dtype`: float64 is the reference, a lower one
(bfloat16) is the control. Displacements are taken in float64 from the
given positions and then rounded to `dtype`; from there every operation,
and every sum (`psum`, a pairwise tree whose partial sums are rounded to
`dtype`), is in `dtype`.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np
import torch

F64 = torch.float64

# miniMD's unit systems (ref/thermo.cpp:57-71): mvv2e, boltz, the
# pressure conversion, and the energy scale of the printed U (0.5 for
# LJ's full neighbor sums; the reference's own constant for metal).
UNITS = {
    "lj": {"mvv2e": 1.0, "boltz": 1.0, "nktv2p": 1.0, "e_scale": 0.5},
    "metal": {"mvv2e": 1.036427e-04, "boltz": 8.617343e-05,
              "nktv2p": 1.602176e+06, "e_scale": 524287.985533},
}

# pair elements held at once while the neighbors are walked
BLOCK_PAIRS = 1 << 22
# the displacement of a candidate that is none (finite in bfloat16 too)
FAR = 1.0e6


def psum(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along `dim` as a pairwise tree in t's own dtype, each partial
    sum rounded to it (torch's own reductions accumulate low precisions in
    float32)."""
    t = t.movedim(dim, -1)
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.cat([t, t.new_zeros(*t.shape[:-1], 1)], dim=-1)
        t = t[..., 0::2] + t[..., 1::2]
    return t[..., 0]


@dataclasses.dataclass(frozen=True)
class Scales:
    mvv2e: float
    dof_boltz: float
    t_scale: float
    p_scale: float
    e_scale: float


def scales(units: str, natoms: int, volume: float) -> Scales:
    u = UNITS[units]
    dof_boltz = (3 * natoms - 3) * u["boltz"]
    return Scales(mvv2e=u["mvv2e"], dof_boltz=dof_boltz,
                  t_scale=u["mvv2e"] / dof_boltz,
                  p_scale=u["nktv2p"] / 3.0 / volume,
                  e_scale=u["e_scale"])


# ---------------------------------------------------------------------
# EAM tables (ref/force_eam.cpp: read_file, file2array, array2spline)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EAM:
    mass: float
    cut: float
    nrho: int
    drho: float
    nr: int
    dr: float
    frho: np.ndarray   # (nrho + 1, 7) spline rows, row 0 unused
    rhor: np.ndarray   # (nr + 1, 7)
    z2r: np.ndarray    # (nr + 1, 7)


def _regrid(src, n_src, d_src, n, d):
    """4-point Lagrange interpolation of a 1-indexed table onto n points
    spaced d (file2array)."""
    out = np.zeros(n + 1)
    for m in range(1, n + 1):
        p = (m - 1) * d / d_src + 1.0
        k = min(max(int(p), 2), n_src - 2)
        p = min(p - k, 2.0)
        c1 = -p * (p - 1.0) * (p - 2.0) / 6.0
        c2 = 0.5 * (p * p - 1.0) * (p - 2.0)
        c3 = -0.5 * p * (p + 1.0) * (p - 2.0)
        c4 = p * (p * p - 1.0) / 6.0
        out[m] = (c1 * src[k - 1] + c2 * src[k] + c3 * src[k + 1]
                  + c4 * src[k + 2])
    return out


def _spline(n, delta, f):
    """array2spline: rows [0..2] the derivative's coefficients over delta,
    [3..5] the value's, [6] the knot value."""
    s = np.zeros((n + 1, 7))
    s[1:, 6] = f[1:n + 1]
    s[1, 5] = s[2, 6] - s[1, 6]
    s[2, 5] = 0.5 * (s[3, 6] - s[1, 6])
    s[n - 1, 5] = 0.5 * (s[n, 6] - s[n - 2, 6])
    s[n, 5] = s[n, 6] - s[n - 1, 6]
    for m in range(3, n - 1):
        s[m, 5] = ((s[m - 2, 6] - s[m + 2, 6])
                   + 8.0 * (s[m + 1, 6] - s[m - 1, 6])) / 12.0
    for m in range(1, n):
        s[m, 4] = 3.0 * (s[m + 1, 6] - s[m, 6]) - 2.0 * s[m, 5] - s[m + 1, 5]
        s[m, 3] = s[m, 5] + s[m + 1, 5] - 2.0 * (s[m + 1, 6] - s[m, 6])
    for m in range(1, n + 1):
        s[m, 2] = s[m, 5] / delta
        s[m, 1] = 2.0 * s[m, 4] / delta
        s[m, 0] = 3.0 * s[m, 3] / delta
    return s


def read_eam(path) -> EAM:
    """A single-element funcfl file: header, F(rho), Z(r), rho(r)."""
    lines = pathlib.Path(path).read_text().splitlines()
    mass = float(lines[1].split()[1])
    head = lines[2].split()
    nrho, drho, nr, dr, cut = (int(head[0]), float(head[1]), int(head[2]),
                               float(head[3]), float(head[4]))
    vals = np.array(" ".join(lines[3:]).split()[:nrho + 2 * nr], dtype=float)
    frho_f = np.concatenate([[0.0], vals[:nrho]])
    zr_f = np.concatenate([[0.0], vals[nrho:nrho + nr]])
    rhor_f = np.concatenate([[0.0], vals[nrho + nr:]])
    n_r = int((nr - 1) * dr / dr + 0.5)
    n_rho = int((nrho - 1) * drho / drho + 0.5)
    frho = _regrid(frho_f, nrho, drho, n_rho, drho)
    rhor = _regrid(rhor_f, nr, dr, n_r, dr)
    zr = _regrid(zr_f, nr, dr, n_r, dr)
    z2r = 27.2 * 0.529 * zr * zr    # Hartree*Bohr to eV*Angstrom
    return EAM(mass=mass, cut=cut, nrho=n_rho, drho=drho, nr=n_r, dr=dr,
               frho=_spline(n_rho, drho, frho), rhor=_spline(n_r, dr, rhor),
               z2r=_spline(n_r, dr, z2r))


def _rows(table, x, inv_delta, n, lo, dtype):
    """(coefficient columns at row m, p) of a spline at x (in dtype)."""
    p = x * inv_delta + 1.0
    m = p.to(torch.int64).clamp(lo, n - 1)
    p = torch.clamp(p - m.to(dtype), max=1.0)
    return table[m], p


def _value(c, p):
    return ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]


def _deriv(c, p):
    return (c[..., 0] * p + c[..., 1]) * p + c[..., 2]


# ---------------------------------------------------------------------
# neighbors
# ---------------------------------------------------------------------

class Neighbors:
    """Every atom's candidates: the atoms of the 27 cells around its own,
    on a grid of at least 3 cells of at least `cut` a side, with the
    periodic image each sits in."""

    def __init__(self, x, box, cut: float):
        dev = x.device
        self.box = torch.as_tensor(np.asarray(box, float), dtype=F64,
                                   device=dev)
        self.x = torch.remainder(x.to(F64), self.box)
        self.n = len(x)
        nc = [int(b // cut) for b in box]
        if min(nc) < 3:
            raise ValueError(f"box {box} holds fewer than 3 cells of {cut}")
        self.nc = torch.tensor(nc, device=dev)
        idx = torch.minimum((self.x / (self.box / self.nc)).to(torch.int64),
                            self.nc - 1)
        self.cidx = idx
        cell = (idx[:, 2] * nc[1] + idx[:, 1]) * nc[0] + idx[:, 0]
        order = torch.argsort(cell, stable=True)
        counts = torch.bincount(cell, minlength=nc[0] * nc[1] * nc[2])
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(self.n, device=dev) - start[cell[order]]
        self.K = int(counts.max())
        self.table = torch.full((nc[0] * nc[1] * nc[2], self.K), -1,
                                dtype=torch.int64, device=dev)
        self.table[cell[order], rank] = order
        r = torch.arange(-1, 2, device=dev)
        oz, oy, ox = torch.meshgrid(r, r, r, indexing="ij")
        self.offsets = torch.stack([ox.reshape(-1), oy.reshape(-1),
                                    oz.reshape(-1)], dim=1)    # (27, 3)

    def blocks(self):
        """Per block of atoms i: (i, j, d, rsq), d = x_i - x_j (float64,
        (B, P, 3)) and rsq (B, P); j = -1 for no candidate."""
        P = 27 * self.K
        B = max(1, BLOCK_PAIRS // P)
        nc = self.nc
        for s in range(0, self.n, B):
            i = torch.arange(s, min(s + B, self.n), device=self.x.device)
            c = self.cidx[i][:, None, :] + self.offsets[None]   # (B, 27, 3)
            wrap = torch.div(c, nc, rounding_mode="floor")
            c = c - wrap * nc
            cell = (c[..., 2] * nc[1] + c[..., 1]) * nc[0] + c[..., 0]
            j = self.table[cell].reshape(len(i), P)             # (B, P)
            shift = (wrap.to(F64) * self.box)[:, :, None, :].expand(
                -1, -1, self.K, -1).reshape(len(i), P, 3)
            xj = self.x[j.clamp(min=0)] + shift
            d = self.x[i][:, None, :] - xj
            # no candidate, or i itself: a displacement far past any cutoff
            bad = (j < 0) | (j == i[:, None])
            d = torch.where(bad[..., None], FAR, d)
            yield i, j, d, (d * d).sum(-1)


def _rsq(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# ---------------------------------------------------------------------
# forces
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Forces:
    f: torch.Tensor        # (N, 3) in dtype
    eng: float             # miniMD's eng_vdwl (full neighbor convention)
    virial: float          # sum over pairs of r . F_ij
    pairs: int             # unordered pairs inside the cutoff
    # (float64 only) each pair within BORDER of the cutoff, which float32
    # may put on either side, once for each of its atoms: the atom and the
    # change of its force if the pair lay on the other side
    border_atom: torch.Tensor | None = None
    border_df: torch.Tensor | None = None


# Relative band of r^2 around the cutoff inside which float32 may put a
# pair on either side: a float32 displacement between coordinates of up to
# ~256 (the largest box here) is off by up to an ulp there, 3e-5, which
# moves r^2 by 2 r ulp, 1.2e-5 of the cutoff's r^2 at the shortest cutoff
# (LJ's 2.5); the band takes 4e-5.
BORDER = 4e-5


def lj_forces(x, box, cut, epsilon, sigma, dtype=F64) -> Forces:
    """LJ forces (ref/force_lj.cpp compute_fullneigh): per atom the sum
    over its in-cut neighbors of 48 sr6 (sr6 - 1/2) sr2 eps d; eng =
    4 eps sum over ordered pairs of sr6 (sr6 - 1); virial = 1/2 sum over
    ordered pairs of r^2 fpair."""
    nb = Neighbors(x, box, cut)
    cutsq = cut * cut
    sig6 = sigma ** 6
    f = torch.empty((nb.n, 3), dtype=dtype, device=x.device)
    e_i = torch.empty(nb.n, dtype=dtype, device=x.device)
    w_i = torch.empty(nb.n, dtype=dtype, device=x.device)
    pairs, b_atom, b_df = 0, [], []
    for i, j, d64, rsq64 in nb.blocks():
        d = d64.to(dtype)
        rsq = _rsq(d)
        m = rsq < cutsq
        sr2 = torch.where(m, 1.0 / rsq, 0.0)
        sr6 = sr2 * sr2 * sr2 * sig6
        fc = 48.0 * sr6 * (sr6 - 0.5) * sr2 * epsilon
        f[i] = psum(fc[..., None] * d, dim=1)
        e_i[i] = psum(sr6 * (sr6 - 1.0) * epsilon, dim=1)
        w_i[i] = psum(rsq * fc, dim=1)
        pairs += int(m.sum())
        if dtype == F64:
            bi, bj = ((rsq64 - cutsq).abs() < BORDER * cutsq).nonzero(
                as_tuple=True)
            s2 = 1.0 / rsq64[bi, bj]
            s6 = s2 * s2 * s2 * sig6
            g = (48.0 * s6 * (s6 - 0.5) * s2 * epsilon)[:, None] * d64[bi, bj]
            b_atom.append(i[bi])
            b_df.append(torch.where((rsq64[bi, bj] < cutsq)[:, None], -g, g))
    out = Forces(f=f, eng=float(4.0 * psum(e_i)), virial=float(0.5 * psum(w_i)),
                 pairs=pairs // 2)
    if dtype == F64:
        out.border_atom, out.border_df = torch.cat(b_atom), torch.cat(b_df)
    return out


def eam_forces(x, box, eam: EAM, dtype=F64) -> Forces:
    """EAM forces (ref/force_eam.cpp compute_fullneigh): rho_i = sum
    rho(r_ij); fp_i = F'(rho_i); psip = fp_i rho'(r) + fp_j rho'(r) +
    phi'(r), phi = z2/r; fpair = -psip / r. eng = 2 (sum F(rho_i) +
    1/2 sum over ordered pairs of phi) (force_eam.cpp:446); virial = 1/2
    sum over ordered pairs of r^2 fpair."""
    dev = x.device
    nb = Neighbors(x, box, eam.cut)
    cutsq = eam.cut * eam.cut
    rhor, frho, z2r = (torch.as_tensor(t, dtype=dtype, device=dev)
                       for t in (eam.rhor, eam.frho, eam.z2r))
    rdr, rdrho = 1.0 / eam.dr, 1.0 / eam.drho

    def pair_rows(d64):
        d = d64.to(dtype)
        rsq = _rsq(d)
        m = rsq < cutsq
        r = torch.sqrt(torch.where(m, rsq, 1.0))
        c, p = _rows(rhor, r, rdr, eam.nr, 0, dtype)
        return d, rsq, m, r, c, p

    rho = torch.empty(nb.n, dtype=dtype, device=dev)
    pairs = 0
    for i, j, d64, _ in nb.blocks():
        _, _, m, _, c, p = pair_rows(d64)
        rho[i] = psum(torch.where(m, _value(c, p), 0.0), dim=1)
        pairs += int(m.sum())
    c, p = _rows(frho, rho, rdrho, eam.nrho, 1, dtype)
    fp = _deriv(c, p)
    embed = psum(_value(c, p))

    def fpair_of(r, fp_i, fp_j):
        c, p = _rows(rhor, r, rdr, eam.nr, 0, dtype)
        rhop = _deriv(c, p)
        cz, _ = _rows(z2r, r, rdr, eam.nr, 0, dtype)
        z2p, z2 = _deriv(cz, p), _value(cz, p)
        recip = 1.0 / r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        return -(fp_i * rhop + fp_j * rhop + phip) * recip, phi

    f = torch.empty((nb.n, 3), dtype=dtype, device=dev)
    phi_i = torch.empty(nb.n, dtype=dtype, device=dev)
    w_i = torch.empty(nb.n, dtype=dtype, device=dev)
    b_atom, b_df = [], []
    for i, j, d64, rsq64 in nb.blocks():
        d, rsq, m, r, _, _ = pair_rows(d64)
        jj = j.clamp(min=0)
        fpair, phi = fpair_of(r, fp[i][:, None], fp[jj])
        fpair = torch.where(m, fpair, 0.0)
        f[i] = psum(fpair[..., None] * d, dim=1)
        phi_i[i] = psum(torch.where(m, phi, 0.0), dim=1)
        w_i[i] = psum(rsq * fpair, dim=1)
        if dtype == F64:
            bi, bj = ((rsq64 - cutsq).abs() < BORDER * cutsq).nonzero(
                as_tuple=True)
            g = fpair_of(torch.sqrt(rsq64[bi, bj]), fp[i[bi]],
                         fp[jj[bi, bj]])[0][:, None] * d64[bi, bj]
            b_atom.append(i[bi])
            b_df.append(torch.where((rsq64[bi, bj] < cutsq)[:, None], -g, g))
    eng = 2.0 * (embed + 0.5 * psum(phi_i))
    out = Forces(f=f, eng=float(eng), virial=float(0.5 * psum(w_i)),
                 pairs=pairs // 2)
    if dtype == F64:
        out.border_atom, out.border_df = torch.cat(b_atom), torch.cat(b_df)
    return out


# ---------------------------------------------------------------------
# the model of one configuration
# ---------------------------------------------------------------------

class Model:
    """One configuration's physics: forces, the thermo row and the
    velocity-Verlet step, for a box and a number of atoms."""

    def __init__(self, cfg: dict, box, natoms: int, cfg_dir):
        self.cfg = cfg
        self.box = tuple(float(b) for b in box)
        self.natoms = natoms
        self.eam = (read_eam(pathlib.Path(cfg_dir) / cfg["potential"])
                    if cfg["style"] == "eam" else None)
        self.mass = self.eam.mass if self.eam else float(cfg["mass"])
        self.sc = scales(cfg["units"], natoms, math.prod(self.box))
        self.dt = float(cfg["dt"])
        self.dtf = 0.5 * self.dt / self.sc.mvv2e / self.mass

    def forces(self, x, dtype=F64) -> Forces:
        if self.eam is not None:
            return eam_forces(x, self.box, self.eam, dtype)
        c = self.cfg
        return lj_forces(x, self.box, c["force_cut"], c["epsilon"],
                         c["sigma"], dtype)

    def row(self, v, fr: Forces, dtype=F64):
        """miniMD's thermo row (T, U, P) for velocities v and the forces'
        energy and virial (ref/thermo.cpp:119-194)."""
        sc = self.sc
        v = v.to(dtype)
        t = float(psum((v * v).reshape(-1)) * (self.mass * sc.t_scale))
        u = fr.eng * sc.e_scale / self.natoms
        p = (t * sc.dof_boltz + fr.virial) * sc.p_scale
        return t, u, p

    def ideal_pressure(self, t: float) -> float:
        return t * self.sc.dof_boltz * self.sc.p_scale

    def two_steps(self, x0, v0, dtype=F64, f0: Forces | None = None):
        """Two velocity-Verlet steps from (x0, v0) (ref/integrate.cpp:
        kick, drift, force, kick), the positions kept as x0 (float64) plus
        a displacement in dtype; f0: the forces at x0 in dtype, computed
        here when None. Returns (x2, v2, (atoms, dv)): dv, how an atom's v2
        moves if a pair at the cutoff of one of the three forces lay on
        the other side (float64 only)."""
        x0 = x0.to(F64)
        fr = self.forces(x0, dtype) if f0 is None else f0
        dx = torch.zeros_like(x0, dtype=dtype)
        v, f = v0.to(dtype), fr.f
        used = [(fr, self.dtf)]
        for k in range(2):
            v = v + self.dtf * f
            dx = dx + self.dt * v
            fr = self.forces(x0 + dx.to(F64), dtype)
            f = fr.f
            v = v + self.dtf * f
            used.append((fr, (2.0 if k == 0 else 1.0) * self.dtf))
        corr = None
        if dtype == F64:
            corr = (torch.cat([u.border_atom for u, _ in used]),
                    torch.cat([w * u.border_df for u, w in used]))
        return x0 + dx.to(F64), v, corr


# ---------------------------------------------------------------------
# the layout audit
# ---------------------------------------------------------------------

VALID_BELOW = 5.0e5   # an empty slot holds a coordinate far beyond any box


def audit_layout(x, typ, nb, capacity, prd, offset, natoms, type_counts):
    """Check a cell-major layout (slot s belongs to cell s // capacity,
    cells numbered x fastest) against the positions it holds: (lost,
    misplaced). lost counts atoms gone or doubled, by type; misplaced
    counts atoms whose slot's cell is not the cell their position maps to
    on the grid (nb, prd, offset), allowing either side of a face closer
    than float32 can resolve."""
    x = np.asarray(x, np.float64)
    typ = np.asarray(typ)
    valid = x[0] < VALID_BELOW
    counts = np.bincount(typ[valid], minlength=len(type_counts))
    lost = int(abs(int(valid.sum()) - natoms)
               + np.abs(counts[:len(type_counts)] - type_counts).sum()
               + counts[len(type_counts):].sum())
    slots = np.nonzero(valid)[0]
    cell = slots // capacity
    nbv = np.asarray(nb)
    own = np.stack([cell % nbv[0], (cell // nbv[0]) % nbv[1],
                    cell // (nbv[0] * nbv[1])], axis=1)
    prd = np.asarray(prd, np.float64)
    bs = prd / nbv
    g = np.mod(x[:, valid].T - np.asarray(offset), prd)
    tol = 1e-5 * bs
    ok = np.ones(len(slots), dtype=bool)
    for k in range(3):
        lo = np.floor((g[:, k] - tol[k]) / bs[k]).astype(np.int64) % nbv[k]
        hi = np.floor((g[:, k] + tol[k]) / bs[k]).astype(np.int64) % nbv[k]
        ok &= (own[:, k] == lo) | (own[:, k] == hi)
    return lost, int((~ok).sum())
