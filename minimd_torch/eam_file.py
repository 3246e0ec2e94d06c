"""DYNAMO funcfl EAM potential: file reader, regrid, cubic-spline tables.

Host-side NumPy port of the reference's table pipeline
(ref/force_eam.cpp:505-793): read_file -> file2array -> array2spline.
All arrays are kept 1-indexed like the reference (row 0 unused) so the
spline-lookup indices `m = int(r*rdr + 1)` match exactly.

The spline layout here is 2-D (n+1, 7) instead of the reference's
64-aligned flat arrays — alignment is the allocator's business, not the
math's. z2r units: 27.2*0.529 * zri * zrj (Hartree*Bohr -> eV*Angstrom,
force_eam.cpp:725).

A copy of minimd_tpu.eam_file from read_funcfl through build_pair_polys,
with the adaptive pair-table fit only: the TPU's trajectory-validated
pinned degrees, the Chebyshev tables and the gather-row tables are not
used by the port.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


@dataclasses.dataclass
class Funcfl:
    mass: float
    nrho: int
    drho: float
    nr: int
    dr: float
    cut: float
    frho: np.ndarray  # (nrho+1,) 1-indexed
    rhor: np.ndarray  # (nr+1,)
    zr: np.ndarray    # (nr+1,)


def read_funcfl(path: str | pathlib.Path) -> Funcfl:
    """Parse a single-element DYNAMO funcfl file (force_eam.cpp:505-582)."""
    toks: list[str] = []
    lines = pathlib.Path(path).read_text().splitlines()
    # line 0: comment; line 1: atomic number, mass; line 2: grid header
    mass = float(lines[1].split()[1])
    nrho, drho, nr, dr, cut = lines[2].split()[:5]
    nrho, nr = int(nrho), int(nr)
    drho, dr, cut = float(drho), float(dr), float(cut)
    for ln in lines[3:]:
        toks.extend(ln.split())
    vals = np.array([float(t) for t in toks[: nrho + 2 * nr]], dtype=np.float64)
    frho = np.concatenate([[0.0], vals[:nrho]])
    zr = np.concatenate([[0.0], vals[nrho: nrho + nr]])
    rhor = np.concatenate([[0.0], vals[nrho + nr: nrho + 2 * nr]])
    return Funcfl(mass=mass, nrho=nrho, drho=drho, nr=nr, dr=dr, cut=cut,
                  frho=frho, rhor=rhor, zr=zr)


def _lagrange_regrid(src: np.ndarray, src_n: int, src_delta: float,
                     n: int, delta: float) -> np.ndarray:
    """4-point Lagrange interpolation onto a new grid (file2array's inner
    loop, force_eam.cpp:630-644). Returns a 1-indexed (n+1,) array."""
    m = np.arange(1, n + 1)
    r = (m - 1) * delta
    p = r / src_delta + 1.0
    k = np.clip(p.astype(np.int64), 2, src_n - 2)
    p = np.minimum(p - k, 2.0)
    sixth = 1.0 / 6.0
    cof1 = -sixth * p * (p - 1.0) * (p - 2.0)
    cof2 = 0.5 * (p * p - 1.0) * (p - 2.0)
    cof3 = -0.5 * p * (p + 1.0) * (p - 2.0)
    cof4 = sixth * p * (p * p - 1.0)
    out = np.zeros(n + 1)
    out[1:] = (cof1 * src[k - 1] + cof2 * src[k]
               + cof3 * src[k + 1] + cof4 * src[k + 2])
    return out


def file2array(f: Funcfl):
    """Regrid file tables to the working grid and build z2r
    (force_eam.cpp:589-728). For a single funcfl the working grid equals the
    file grid, but the interpolation is reproduced for bit parity."""
    dr, drho = f.dr, f.drho
    rmax = (f.nr - 1) * f.dr
    rhomax = (f.nrho - 1) * f.drho
    nr = int(rmax / dr + 0.5)
    nrho = int(rhomax / drho + 0.5)

    frho = _lagrange_regrid(f.frho, f.nrho, f.drho, nrho, drho)
    rhor = _lagrange_regrid(f.rhor, f.nr, f.dr, nr, dr)
    zri = _lagrange_regrid(f.zr, f.nr, f.dr, nr, dr)
    z2r = np.zeros(nr + 1)
    z2r[1:] = 27.2 * 0.529 * zri[1:] * zri[1:]
    return nrho, drho, nr, dr, frho, rhor, z2r


def array2spline(n: int, delta: float, f: np.ndarray) -> np.ndarray:
    """7-coefficient cubic spline rows (force_eam.cpp:765-793).

    Row m: [0..2] derivative coefficients (scaled by 1/delta),
    [3..5] value-polynomial coefficients, [6] the knot value.
    Returns (n+1, 7); row 0 unused.
    """
    sp = np.zeros((n + 1, 7))
    sp[1:, 6] = f[1: n + 1]

    sp[1, 5] = sp[2, 6] - sp[1, 6]
    sp[2, 5] = 0.5 * (sp[3, 6] - sp[1, 6])
    sp[n - 1, 5] = 0.5 * (sp[n, 6] - sp[n - 2, 6])
    sp[n, 5] = sp[n, 6] - sp[n - 1, 6]
    m = np.arange(3, n - 1)
    sp[m, 5] = ((sp[m - 2, 6] - sp[m + 2, 6])
                + 8.0 * (sp[m + 1, 6] - sp[m - 1, 6])) / 12.0

    m = np.arange(1, n)
    sp[m, 4] = 3.0 * (sp[m + 1, 6] - sp[m, 6]) - 2.0 * sp[m, 5] - sp[m + 1, 5]
    sp[m, 3] = sp[m, 5] + sp[m + 1, 5] - 2.0 * (sp[m + 1, 6] - sp[m, 6])
    sp[n, 4] = 0.0
    sp[n, 3] = 0.0

    sp[1:, 2] = sp[1:, 5] / delta
    sp[1:, 1] = 2.0 * sp[1:, 4] / delta
    sp[1:, 0] = 3.0 * sp[1:, 3] / delta
    return sp


def default_potential_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent / "potentials" / "Cu_u6.eam"


def _spline_value(sp, n, delta, x):
    p = x / delta + 1.0
    m = np.clip(p.astype(np.int64), 1, n - 1)
    p = np.minimum(p - m, 1.0)
    return ((sp[m, 3] * p + sp[m, 4]) * p + sp[m, 5]) * p + sp[m, 6]


def _spline_deriv(sp, n, delta, x):
    p = x / delta + 1.0
    m = np.clip(p.astype(np.int64), 1, n - 1)
    p = np.minimum(p - m, 1.0)
    return (sp[m, 0] * p + sp[m, 1]) * p + sp[m, 2]


# ---------------------------------------------------------------------------
# Exact-to-f32 pair tables: polynomial body + exact spline tail
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairPolys:
    """Gather-free evaluation of the four pair-hot EAM functions, exact to
    f32 rounding against the reference spline tables (force_eam.cpp:152-158).

    Functions (the 1/r force factors are absorbed so the kernel needs no
    reciprocal — fpair = -((fp_i + fp_j) * G1 + G2) directly):

        R  (r) = rhor(r)                      density    (pass 1)
        G1 (r) = rhor'(r) / r                 embedding force factor
        G2 (r) = z2r'(r)/r^2 - z2r(r)/r^3     pair force factor
        P  (r) = z2r(r)/r                     pair energy phi (evflag only)

    Two-piece evaluation, selected per pair by r:

      body  r in [lo, split):  degree-`degree` polynomial fit, Horner in the
            scaled variable u = r*u_a + u_b in [-1, 1]. The fit is computed
            in the Chebyshev basis and re-expanded to power form; for these
            smooth functions at degree <=24 the scaled-variable power
            coefficients stay O(1), so f32 Horner loses nothing (verified by
            `max_err`, measured in f32).
      tail  r in [split, cut]: the spline's own last rows, one low-degree
            polynomial per knot interval refit in the local variable
            t = r*rdr + 1 - m in [0, 1) (machine-exact: each row is a cubic
            times smooth 1/r factors). The funcfl data truncates to zero at
            the cutoff with a genuine C1 break there, which no global fit
            can absorb — this tail IS the reference table, so the break is
            reproduced exactly.

            Per-function flattening (`tail_merged`): when ONE polynomial in
            t over the whole [split, cut] span evaluates (in f32, against
            the spline) within the function's overall max_err, the kernel
            uses it instead — same accuracy, ~5 fewer VPU ops per
            candidate lane. For Cu_u6 this holds for R/G2/P (their
            last spline rows are C2-smooth joins) but NOT G1 = rhor'/r,
            whose second derivative jumps at the interior knot (cubic
            splines are only C2 in value), so G1 keeps the exact rows.

    r < lo clamps to the body edge (no physical pairs there: the shipped
    Cu deck never sees r < 2.3 even at 2x temperature; r >= cut is masked
    by the caller).
    """

    lo: float
    split: float
    cut: float
    rdr: float
    u_a: float              # body variable map u = r*u_a + u_b
    u_b: float
    body: dict              # name -> descending power coeffs (floats)
    m0: int                 # spline row of the first tail interval
    nrows: int
    tail: dict              # name -> tuple of per-row descending power coeffs
    # name -> descending coeffs of ONE polynomial in t over [0, nrows]
    # replacing the row chain (only when its f32 error stays within the
    # function's overall max_err), else None
    tail_merged: dict
    max_err: dict           # name -> max |fit - exact| / max|exact|, f32 eval


def _horner_np(coeffs, x):
    acc = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


# Starting body degrees per function (measured minimal for Cu_u3) and the
# f64 fit tolerances the adaptive loop raises them toward. The tolerances
# are propagation-aware: R feeds rho -> fp = F'(rho) where errors amplify
# ~100x into forces, so it must sit far below f32 rounding; G1/G2 fit
# error concentrates at the body's upper edge where the r-weighting in
# fpair*d amplifies it ~2x, and dropping them to 18 measurably blows the
# grid-vs-exact force error from 2.8e-7 to 2.4e-6 of force scale despite a
# near-identical max fit error — so they stay at 20 wherever forces are
# validated in FORCE space (CPU/f64/interpret). P errors add coherently
# over all pairs in the potential-energy sum, so it needs the same tight
# tolerance (and only runs on evflag/thermo steps anyway).
_DEFAULT_DEGREE = {"R": 20, "G1": 20, "G2": 20, "P": 20}
_BODY_TOL = {"R": 5e-9, "G1": 1e-6, "G2": 2e-7, "P": 2e-9}
_MAX_DEGREE = 24


def build_pair_polys(tables, lo: float = 1.8, split: float | None = None,
                     tail_degree: int = 3) -> PairPolys:
    """Fit the four pair functions of an EAMTables instance. `split` must
    sit on a spline knot and leave the truncation kink (the last ~2 rows
    before the cutoff) to the tail; None picks the knot two rows before the
    cutoff.

    The body degrees are fitted adaptively from the per-function
    defaults, raised until the f64 fit error reaches `_BODY_TOL` (the
    `degree=None` mode of minimd_tpu.eam_file.build_pair_polys)."""
    nr, dr, cut = tables.nr, tables.dr, tables.cut
    rdr = 1.0 / dr
    rhor, z2r = tables.rhor_spline, tables.z2r_spline
    if split is None:
        split = (int(cut * rdr + 1.0) - 2) * dr

    fns = {
        "R":  lambda r: _spline_value(rhor, nr, dr, r),
        "G1": lambda r: _spline_deriv(rhor, nr, dr, r) / r,
        "G2": lambda r: (_spline_deriv(z2r, nr, dr, r) / r ** 2
                         - _spline_value(z2r, nr, dr, r) / r ** 3),
        "P":  lambda r: _spline_value(z2r, nr, dr, r) / r,
    }

    u_a = 2.0 / (split - lo)
    u_b = -(split + lo) / (split - lo)
    m0 = int(split * rdr + 1.0 + 0.5)       # split is knot-aligned
    assert abs((m0 - 1) * dr - split) < 1e-9, "split must be a spline knot"
    nrows = int(cut * rdr + 1.0) - m0 + 1   # rows covering [split, cut]

    body, tail, tail_merged, max_err = {}, {}, {}, {}
    xs = np.linspace(lo, split, 200001)
    u64 = xs * u_a + u_b
    u32 = u64.astype(np.float32)
    for name, fn in fns.items():
        ys = fn(xs)
        scale = max(np.abs(ys).max(), 1e-300)
        prev = np.inf
        stale = 0
        for deg in range(_DEFAULT_DEGREE[name], _MAX_DEGREE + 1):
            fit = np.polynomial.chebyshev.Chebyshev.fit(xs, ys, deg,
                                                        domain=[lo, split])
            power = np.polynomial.polynomial.Polynomial.cast(
                np.polynomial.chebyshev.Chebyshev(fit.coef))  # u, ascending
            coeffs = tuple(float(c) for c in power.coef[::-1])
            # adaptive criterion is the true (f64) fit error: the f32 kernel
            # adds its own rounding on top regardless of degree
            err64 = np.abs(_horner_np(np.asarray(coeffs), u64) - ys).max() \
                / scale
            if err64 <= _BODY_TOL[name]:
                break
            stale = stale + 1 if err64 > 0.5 * prev else 0
            if stale >= 2:      # fit floor (spline roughness), stop paying
                break
            prev = err64
        body[name] = coeffs
        # reported error is what the f32 kernel sees (fit + rounding)
        got = _horner_np(np.asarray(coeffs, np.float32),
                         u32).astype(np.float64)
        err = np.abs(got - ys).max() / scale

        rows = []
        row_err = 0.0
        for k in range(nrows):
            r0, r1 = (m0 + k - 1) * dr, (m0 + k) * dr
            rs = np.linspace(r0, min(r1, cut), 2001)
            t = rs * rdr + 1.0 - (m0 + k)
            yr = fn(rs)
            rfit = np.polynomial.polynomial.Polynomial.fit(
                t, yr, tail_degree, domain=[0.0, 1.0], window=[0.0, 1.0])
            rc = tuple(float(c) for c in rfit.coef[::-1])
            rows.append(rc)
            got = _horner_np(np.asarray(rc, np.float32),
                             t.astype(np.float32)).astype(np.float64)
            row_err = max(row_err, np.abs(got - yr).max() / scale)
        tail[name] = tuple(rows)

        # try to flatten the row chain into ONE polynomial over the whole
        # tail span (in t over [0, nrows]) — accepted only when the f32
        # evaluation error stays within the function's current max_err
        # (the f32 body Horner already rounds at ~2e-7 of scale, so a
        # tighter-than-that tail fit cannot worsen anything; see the class
        # docstring — G1's interior-knot derivative kink keeps the rows)
        rs = np.linspace(split, cut, 20001)
        t = rs * rdr + 1.0 - m0
        yr = fn(rs)
        tail_merged[name] = None
        merged_err = row_err
        for deg in range(tail_degree, 8):
            mfit = np.polynomial.polynomial.Polynomial.fit(
                t, yr, deg, domain=[0.0, float(nrows)],
                window=[0.0, float(nrows)])
            mc = tuple(float(c) for c in mfit.coef[::-1])
            got = _horner_np(np.asarray(mc, np.float32),
                             t.astype(np.float32)).astype(np.float64)
            e = np.abs(got - yr).max() / scale
            if e <= max(row_err, err):
                tail_merged[name] = mc
                merged_err = e
                break
        max_err[name] = float(max(err, merged_err if tail_merged[name]
                                  is not None else row_err))

    return PairPolys(lo=float(lo), split=float(split), cut=float(cut),
                     rdr=float(rdr), u_a=float(u_a), u_b=float(u_b),
                     body=body, m0=m0, nrows=nrows, tail=tail,
                     tail_merged=tail_merged, max_err=max_err)

