"""The port's LAMMPS data writer and `python -m minimd_torch.make_data`
write the JAX package's bytes, and the files read back exactly."""

import importlib.util
import pathlib

import numpy as np

from minimd_tpu.create import Box as JaxBox
from minimd_tpu.lammps_data import write_lammps_data as jax_write
from minimd_torch import lammps_data, make_data
from minimd_torch.create import Box

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_writer_bytes_equal_jax(tmp_path):
    """n = 503 random rows (more than one formatted block of the writer
    when it is cut small), metal mass, a non-cubic box: byte-identical to
    the JAX writer; both readers give x, v and the box back exactly."""
    rng = np.random.default_rng(11)
    x = rng.random((503, 3)) * 37.0
    v = rng.standard_normal((503, 3)) * 1e-3
    ours, theirs = tmp_path / "ours.data", tmp_path / "jax.data"
    lammps_data.write_lammps_data(ours, Box(37.0, 12.25, 1e-3), x, v,
                                  mass=63.55)
    jax_write(theirs, JaxBox(37.0, 12.25, 1e-3), x, v, mass=63.55)
    assert ours.read_bytes() == theirs.read_bytes()
    for read in (lammps_data.read_lammps_data,
                 lammps_data.read_lammps_data_plain):
        box, rx, rv, mass = read(ours)
        assert np.array_equal(rx, x) and np.array_equal(rv, v)
        assert np.array_equal(box.prd, [37.0, 12.25, 1e-3])
        assert mass == 63.55


def test_writer_blocks(tmp_path, monkeypatch):
    """Rows formatted in blocks of a few rows give the same bytes."""
    rng = np.random.default_rng(5)
    x, v = rng.random((10, 3)), rng.random((10, 3))
    whole, blocks = tmp_path / "a.data", tmp_path / "b.data"
    lammps_data.write_lammps_data(whole, Box(1.0, 1.0, 1.0), x, v)
    monkeypatch.setattr(lammps_data, "_WRITE_ROWS", 3)
    lammps_data.write_lammps_data(blocks, Box(1.0, 1.0, 1.0), x, v)
    assert whole.read_bytes() == blocks.read_bytes()


def test_make_data_matches_jax_script(tmp_path, monkeypatch, capsys):
    """make_data.main at --nx 2 --ny 3 --nz 4 writes the file and prints
    the line of scripts/make_data.py (JAX create + writer) for the same
    arguments; the file reads back as the arrays it wrote."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_data", REPO / "scripts" / "make_data.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = ["--nx", "2", "--ny", "3", "--nz", "4", "--rho", "0.9",
            "--temp", "1.2", "--mass", "2.0"]
    ours, theirs = tmp_path / "ours.data", tmp_path / "jax.data"
    box, x, v = make_data.main([*args, "-o", str(ours)])
    said = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["make_data.py", *args, "-o",
                                     str(theirs)])
    script.main()
    jax_said = capsys.readouterr().out
    assert ours.read_bytes() == theirs.read_bytes()
    assert said.replace(str(ours), "F") == jax_said.replace(str(theirs), "F")
    assert said.startswith(f"wrote {ours}: 96 atoms, box ")
    rbox, rx, rv, mass = lammps_data.read_lammps_data(ours)
    assert np.array_equal(rbox.prd, box.prd) and mass == 2.0
    assert np.array_equal(rx, x) and np.array_equal(rv, v)
