"""Run configuration: the `In` deck record, unit systems, force styles.

Mirrors the reference's input record (ref/ljs.h:37-51) and the 13-line
positional deck parser (ref/input.cpp:48-187). A copy of minimd_tpu.config:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import pathlib

UNITS_LJ = 0
UNITS_METAL = 1

FORCE_LJ = 0
FORCE_EAM = 1


@dataclasses.dataclass
class In:
    """Parsed input deck (ref/ljs.h:37-51)."""

    units: int = UNITS_LJ
    datafile: str | None = None
    forcetype: int = FORCE_LJ
    epsilon: float = 1.0
    sigma: float = 1.0
    nx: int = 32
    ny: int = 32
    nz: int = 32
    ntimes: int = 100
    dt: float = 0.005
    t_request: float = 1.44
    rho: float = 0.8442
    neigh_every: int = 20
    force_cut: float = 2.5
    neigh_cut: float = 2.8  # after the "skin += force_cut" fold-in
    thermo_nstat: int = 100


def parse_deck(path: str | pathlib.Path) -> In:
    """Parse a miniMD input deck (fixed 13-line positional format).

    Matches ref/input.cpp:122-183, including the quirk that the stored
    neigh_cut is the skin *plus* the force cutoff (input.cpp:183).
    """
    lines = pathlib.Path(path).read_text().splitlines()
    # line 0: banner, line 1: blank; payload starts at line 2.
    toks = [ln.split() for ln in lines]
    inp = In()

    units = toks[2][0]
    if units == "lj":
        inp.units = UNITS_LJ
    elif units == "metal":
        inp.units = UNITS_METAL
    else:
        raise ValueError(f"Unknown units option {units!r} (expect 'lj' or 'metal')")

    datafile = toks[3][0]
    inp.datafile = None if datafile == "none" else datafile

    forcetype = toks[4][0]
    if forcetype == "lj":
        inp.forcetype = FORCE_LJ
    elif forcetype == "eam":
        inp.forcetype = FORCE_EAM
    else:
        raise ValueError(f"Unknown forcetype option {forcetype!r} (expect 'lj' or 'eam')")

    inp.epsilon, inp.sigma = float(toks[5][0]), float(toks[5][1])
    inp.nx, inp.ny, inp.nz = int(toks[6][0]), int(toks[6][1]), int(toks[6][2])
    inp.ntimes = int(toks[7][0])
    inp.dt = float(toks[8][0])
    inp.t_request = float(toks[9][0])
    inp.rho = float(toks[10][0])
    inp.neigh_every = int(toks[11][0])
    inp.force_cut, skin = float(toks[12][0]), float(toks[12][1])
    inp.thermo_nstat = int(toks[13][0])
    inp.neigh_cut = skin + inp.force_cut
    return inp


def builtin_deck(name: str) -> In:
    """Return one of the shipped decks by name ('lj', 'eam', 'lj_comd')."""
    here = pathlib.Path(__file__).resolve().parent.parent / "inputs"
    fname = {
        "lj": "in.lj.miniMD",
        "eam": "in.eam.miniMD",
        "lj_comd": "in.lj.miniMD_comd",
        "lj-data": "in.lj-data.miniMD",
        "eam-data": "in.eam-data.miniMD",
    }[name]
    return parse_deck(here / fname)
