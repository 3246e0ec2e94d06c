"""minimd_torch's own copies of the host modules: the setup, the LAMMPS
data reader and the golden comparator give the JAX package's results, and
no module of the port (nor chip_smoke.py) imports the JAX package."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

from minimd_tpu import create as jcreate
from minimd_tpu.config import builtin_deck as jax_builtin_deck
from minimd_torch import create
from minimd_torch.config import builtin_deck

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("deck", ["lj", "eam"])
@pytest.mark.parametrize("s", [6, 10])
def test_setup_system_matches_jax(deck, s):
    """prd, x, v, typ and mass of the port's numpy setup equal the JAX
    package's (which may take its native C++ path) exactly."""
    inp, jinp = builtin_deck(deck), jax_builtin_deck(deck)
    inp.nx = inp.ny = inp.nz = jinp.nx = jinp.ny = jinp.nz = s
    got = create.setup_system(inp)
    want = jcreate.setup_system(jinp)
    assert len(got) == len(want) == 5
    for name, a, b in zip(("prd", "x", "v", "typ", "mass"), got, want):
        assert np.array_equal(a, b), name
    assert len(got[1]) == 4 * s ** 3


def test_lammps_data_reader_matches_jax(tmp_path):
    """A data file written by the JAX package's writer reads back the same
    through both packages' readers (the port's has no native path)."""
    from minimd_tpu.lammps_data import read_lammps_data as jax_read
    from minimd_tpu.lammps_data import write_lammps_data
    from minimd_torch.lammps_data import read_lammps_data

    inp = jax_builtin_deck("eam")
    box = jcreate.create_box(3, 3, 3, inp.rho)
    x, v = jcreate.create_atoms(3, 3, 3, inp.rho, box)
    path = tmp_path / "cu.data"
    write_lammps_data(path, box, x, v[::-1] * 1e-3, mass=63.55)
    got, want = read_lammps_data(path), jax_read(path)
    assert np.array_equal(got[0].prd, want[0].prd)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)
    assert got[3] == 63.55 and len(got[1]) == 108


def test_validate_matches_jax(golden_dir):
    """The copied golden parser and acceptance comparator give the JAX
    package's verdicts on a trace with a growing error."""
    from minimd_tpu import validate as jvalidate
    from minimd_torch import validate

    for name in ("4k.lj", "4k.eam"):
        g, jg = (m.parse_golden(golden_dir / name)
                 for m in (validate, jvalidate))
        assert (g.natoms, g.nbins, g.size, g.rows) == (
            jg.natoms, jg.nbins, jg.size, jg.rows)
        system = name.split(".")[1]
        for scale in (1e-6, 1e-3, 1e-1):
            rows = [(r[0], *(q * (1 + scale * k) for k, q in
                             enumerate(r[1:], 1))) for r in g.rows]
            res = validate.compare_traces(rows, g.rows, 4000, system, 4)
            jres = jvalidate.compare_traces(rows, g.rows, 4000, system, 4)
            assert dataclasses.astuple(res) == dataclasses.astuple(jres)


_IMPORT = re.compile(r"^\s*(import|from)\s+(minimd_tpu|jax)\b")


def test_port_imports_nothing_of_jax_package():
    """No `import`/`from` line of the port or of chip_smoke.py names
    minimd_tpu or jax; mentions in comments and docstrings are fine."""
    files = sorted((REPO / "minimd_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{n}: {line.strip()}"
           for f in files
           for n, line in enumerate(f.read_text().splitlines(), 1)
           if _IMPORT.match(line)]
    assert not bad, bad
