"""The reference's neighbor walk against a brute-force one: every pair by
the minimum image, on the 4,000-atom lattices (10^3 FCC cells) of both
configurations, shaken off the lattice."""

import json
import pathlib

import numpy as np
import pytest
import torch

from mdbench import lattice, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
F64 = torch.float64


def _shaken(name, seed=3):
    cfg = json.loads((ROOT / f"mdbench/configs/{name}.json").read_text())
    x, box = lattice.fcc(10, 10, 10, cfg["density"])
    x = x + np.random.default_rng(seed).normal(0.0, 0.08, x.shape)
    return cfg, torch.tensor(x, dtype=F64), box


def _brute(x, box, cut):
    """(unordered pairs inside cut, d (N, N, 3), rsq (N, N)), every pair
    by the minimum image."""
    L = torch.tensor(box, dtype=F64)
    d = x[:, None, :] - x[None, :, :]
    d = d - torch.round(d / L) * L
    rsq = (d * d).sum(-1)
    rsq.fill_diagonal_(torch.inf)
    return int((rsq < cut * cut).sum()) // 2, d, rsq


@pytest.mark.parametrize("name", ["lj_fcc", "eam_cu"])
def test_pair_count_matches_brute_force(name):
    cfg, x, box = _shaken(name)
    cut = (cfg["force_cut"] if cfg["style"] == "lj" else reference.read_eam(
        ROOT / "mdbench/configs" / cfg["potential"]).cut)
    n_brute, _, _ = _brute(x, box, cut)
    model = reference.Model(cfg, box, len(x), ROOT / "mdbench/configs")
    assert len(x) == 4000
    assert model.forces(x).pairs == n_brute


def test_lj_forces_match_brute_force():
    cfg, x, box = _shaken("lj_fcc")
    _, d, rsq = _brute(x, box, cfg["force_cut"])
    m = rsq < cfg["force_cut"] ** 2
    sr2 = torch.where(m, 1.0 / rsq, 0.0)
    sr6 = sr2 ** 3
    fc = 48.0 * sr6 * (sr6 - 0.5) * sr2
    f = (fc[..., None] * d).sum(1)
    eng = 4.0 * (sr6 * (sr6 - 1.0)).sum()
    vir = 0.5 * (rsq.nan_to_num(posinf=0.0) * fc).sum()
    got = reference.Model(cfg, box, len(x), ROOT / "mdbench/configs") \
        .forces(x)
    assert torch.allclose(got.f, f, rtol=0, atol=1e-9 * float(f.abs().max()))
    assert abs(got.eng - float(eng)) <= 1e-10 * abs(float(eng))
    assert abs(got.virial - float(vir)) <= 1e-10 * abs(float(vir))
