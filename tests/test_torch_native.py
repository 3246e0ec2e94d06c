"""The port's host runtime (minimd_torch/csrc/native.cpp through
minimd_torch.native): the type stream, the FCC lattice and the data reader
equal, bit for bit, the port's numpy bodies and the JAX package's native
and Python paths; the reader refuses what the JAX package's C++ reader
let through; a failed build raises."""

import pathlib
import re

import numpy as np
import pytest

from minimd_tpu import create as jcreate
from minimd_tpu import native as jnative
from minimd_tpu.config import builtin_deck as jax_builtin_deck
from minimd_tpu.lammps_data import write_lammps_data as jax_write
from minimd_tpu.rng import GlibcRand
from minimd_torch import _build, create, lammps_data, native

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_rand_types_matches_plain_and_jax():
    for seed, n, ntypes in ((5413, 5000, 4), (1, 777, 3), (0, 100, 7)):
        got = native.rand_types(seed, n, ntypes)
        assert got.dtype == np.int32 and got.shape == (n,)
        for want in (create.assign_types_plain(n, ntypes, seed),
                     jnative.rand_types(seed, n, ntypes),
                     GlibcRand(seed).rand_array(n, ntypes)):
            assert np.array_equal(got, want)
    assert np.array_equal(create.assign_types(4000, 4),
                          jcreate.assign_types(4000, 4))


@pytest.mark.parametrize("case", ["whole", "subbox", "noncubic"])
def test_create_atoms_matches_plain_and_jax(case):
    """The whole s=10 box, one sub-box of it (a domain's bounds, cut off
    the lattice planes), and a non-cubic 4x3x5 lattice."""
    n = {"whole": (10, 10, 10), "subbox": (10, 10, 10),
         "noncubic": (4, 3, 5)}[case]
    rho = jax_builtin_deck("lj").rho
    box = create.create_box(*n, rho)
    bounds = None
    if case == "subbox":
        bounds = (0.3 * box.xprd, 0.8 * box.xprd, 0.0, 0.5 * box.yprd,
                  0.25 * box.zprd, box.zprd)
    whole = (0.0, box.xprd, 0.0, box.yprd, 0.0, box.zprd)
    got = create.create_atoms(*n, rho, box, bounds)
    wants = (create.create_atoms_plain(*n, rho, box, bounds),
             jnative.create_atoms(*n, rho, bounds or whole),
             jcreate.create_atoms(*n, rho, jcreate.create_box(*n, rho),
                                  bounds))
    assert got[0].dtype == got[1].dtype == np.float64
    for want in wants:
        for a, b in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b)
    if case == "subbox":
        assert 0 < len(got[0]) < 4000
    else:
        assert len(got[0]) == 4 * n[0] * n[1] * n[2]


def test_read_lammps_data_matches_plain_and_jax(tmp_path):
    """A file of the JAX writer (metal mass, ids written in order) reads
    the same through the port's two readers and the JAX package's; the
    port's readers place rows by id when they come shuffled."""
    from minimd_tpu.lammps_data import read_lammps_data as jax_read

    rng = np.random.default_rng(3)
    x = rng.random((500, 3)) * 10
    v = rng.standard_normal((500, 3))
    path = tmp_path / "t.data"
    jax_write(path, jcreate.Box(10.0, 11.0, 12.5), x, v, mass=63.55)
    got = lammps_data.read_lammps_data(path)
    plain = lammps_data.read_lammps_data_plain(path)
    jax_got = jax_read(path)
    nbox, nx, nv, nmass = jnative.read_lammps_data(path)
    assert np.array_equal(got[0].prd, [10.0, 11.0, 12.5])
    for want in (plain, jax_got):
        assert np.array_equal(got[0].prd, want[0].prd)
        assert got[3] == want[3] == 63.55
    assert np.array_equal(got[0].prd, nbox) and nmass == 63.55
    for a, b, c, d in zip(got[1:3], plain[1:3], jax_got[1:3], (nx, nv)):
        assert np.array_equal(a, x if a is got[1] else v)
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(a, d)

    # the same rows in another order, with comments and an image column
    lines = path.read_text().splitlines()
    at, vel = lines.index("Atoms") + 2, lines.index("Velocities") + 2
    order = rng.permutation(500)
    lines[at:at + 500] = [lines[at + i] + " 0 0 0 # image" for i in order]
    lines[vel:vel + 500] = [lines[vel + i] for i in order]
    path.write_text("\n".join(lines) + "\n")
    for read in (lammps_data.read_lammps_data,
                 lammps_data.read_lammps_data_plain):
        _, gx, gv, _ = read(path)
        assert np.array_equal(gx, x) and np.array_equal(gv, v)


def _data_file(path, atoms, masses=("1 63.55",), velocities=None):
    text = ["title", "", f"{len(atoms)} atoms", "1 atom types", "",
            "0.0 10.0 xlo xhi", "0.0 10.0 ylo yhi", "-1.0 9.0 zlo zhi", "",
            "Masses", "", *masses, "", "Atoms", "", *atoms]
    if velocities is not None:
        text += ["", "Velocities", "", *velocities]
    path.write_text("\n".join(text) + "\n")
    return path


_ATOMS = ["1 1 0.5 0.5 0.5", "2 1 1.5 1.5 1.5", "3 1 2.5 2.5 2.5"]
_READERS = {"native": lammps_data.read_lammps_data,
            "plain": lammps_data.read_lammps_data_plain}


@pytest.mark.parametrize("reader", sorted(_READERS))
@pytest.mark.parametrize("fault", ["id0", "id_past_natoms", "short_atoms",
                                   "short_velocities", "short_masses"])
def test_reader_refuses_bad_rows(tmp_path, reader, fault):
    """An atom id outside 1..natoms (the JAX package's C++ reader wrote
    outside its buffer; its Python reader wrote id 0 into the last row)
    and a row with fewer columns than its section needs raise ValueError
    in both readers."""
    atoms, masses, vel = list(_ATOMS), ["1 63.55"], None
    if fault == "id0":
        atoms[1] = "0 1 1.5 1.5 1.5"
    elif fault == "id_past_natoms":
        atoms[2] = "4 1 2.5 2.5 2.5"
    elif fault == "short_atoms":
        atoms[0] = "1 1 0.5 0.5"
    elif fault == "short_velocities":
        vel = ["1 0.1 0.2 0.3", "2 0.1 0.2", "3 0.1 0.2 0.3"]
    else:
        masses = ["1"]
    path = _data_file(tmp_path / "bad.data", atoms, masses, vel)
    with pytest.raises(ValueError, match="line|1..natoms|columns"):
        _READERS[reader](path)


@pytest.mark.parametrize("reader", sorted(_READERS))
def test_reader_takes_last_masses_row(tmp_path, reader):
    """Two Masses rows: the last gives the mass (the JAX package's C++
    reader kept the first, its Python reader the last); the box is
    xhi - xlo; velocities default to 0."""
    path = _data_file(tmp_path / "m.data", _ATOMS, ["1 63.55", "2 12.5"])
    box, x, v, mass = _READERS[reader](path)
    assert mass == 12.5
    assert np.array_equal(box.prd, [10.0, 10.0, 10.0])
    assert np.array_equal(x[:, 0], [0.5, 1.5, 2.5]) and not v.any()


@pytest.mark.parametrize("reader", sorted(_READERS))
def test_reader_missing_file_and_sections(tmp_path, reader):
    with pytest.raises(FileNotFoundError):
        _READERS[reader](tmp_path / "none.data")
    path = tmp_path / "empty.data"
    path.write_text("title\n\n3 atoms\n")
    with pytest.raises(ValueError, match="no Atoms section"):
        _READERS[reader](path)


def test_native_refuses_bad_arguments():
    """What the C++ would divide by zero or take the cube root of a
    negative number for raises ValueError first."""
    box = create.create_box(2, 2, 2, 0.8442)
    with pytest.raises(ValueError, match="ntypes"):
        native.rand_types(5413, 10, 0)
    for rho in (0.0, -0.8442):
        with pytest.raises(ValueError, match="density"):
            native.create_atoms(2, 2, 2, rho, (0.0, box.xprd) * 3)
    with pytest.raises(ValueError, match="bounds"):
        native.create_atoms(2, 2, 2, 0.8442, (0.0, box.xprd))


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """CXX=/bin/false with an empty build directory: the build raises with
    the compiler's command, and so do the set-up functions; nothing falls
    back to numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="host compiler failed"):
        _build.build_host()
    box = create.create_box(2, 2, 2, 0.8442)
    for call in (lambda: create.create_atoms(2, 2, 2, 0.8442, box),
                 lambda: create.assign_types(10, 4)):
        with pytest.raises(RuntimeError, match="/bin/false"):
            call()
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_build_is_the_ports_own():
    """The host library is built from minimd_torch/csrc/native.cpp into
    minimd_torch/_build/, named by a hash; the kernel library's sources
    (and so its hash) leave native.cpp out; no file of the port reads the
    JAX package's native/ directory or library."""
    lib = _build.build_host()
    assert lib.parent == REPO / "minimd_torch" / "_build"
    assert re.fullmatch(r"libminimd_native_[0-9a-f]{16}\.so", lib.name)
    assert _build.HOST_SRC == REPO / "minimd_torch" / "csrc" / "native.cpp"
    kernels = _build.kernel_sources()
    assert kernels and all(s.suffix in (".cu", ".cuh") for s in kernels)
    reads = re.compile(r"""["']native/|/\s*["']native["']|"""
                       r"""libminimd_native\.so|minimd_native\.cpp""")
    files = sorted((REPO / "minimd_torch").rglob("*.py")) + sorted(
        (REPO / "minimd_torch" / "csrc").glob("*"))
    bad = [f"{f.relative_to(REPO)}:{n}" for f in files
           for n, line in enumerate(f.read_text().splitlines(), 1)
           if reads.search(line)]
    assert not bad, bad
