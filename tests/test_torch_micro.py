"""minimd_torch.micro, the FMA and copy probes, held against
scripts/exp_micro.py's Pallas kernels (make_fma, make_copy) in interpret
mode on the CPU, and its timing loop run end to end with the plain
versions."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from minimd_torch import micro

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
# The kernel, XLA on the CPU (which contracts y * a + b to an FMA) and the
# plain version each round once per link: 2 ulps of values in [1, 2). A
# chain that drops the + b term is off by ~5.7e-6 at reps=2, one with 23
# links per rep by ~2.1e-6; a twice-rounded chain by ~2.9e-6.
FMA_ATOL = 2.4e-7


@pytest.fixture(scope="module")
def exp_micro():
    """scripts/exp_micro.py loaded read-only as with --interpret, at G = 2
    and CB = 4 blocks; the two jax.config settings it changes are put
    back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    argv = sys.argv
    sys.argv = ["exp_micro.py", "--interpret"]
    try:
        spec = importlib.util.spec_from_file_location(
            "exp_micro", REPO / "scripts" / "exp_micro.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.G, mod.CB = 2, 4
    return mod


def test_fma_matches_exp_micro(exp_micro):
    m = exp_micro
    x = np.random.default_rng(0).random((m.G * m.SUB, m.LANE), np.float32)
    want = np.asarray(jax.jit(m.make_fma(2))(x))
    got = micro.fma_chain(torch.as_tensor(x), 2)         # CPU: plain
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= FMA_ATOL
    # the chain really ran: 48 links move every value by ~4.8e-5 relative
    assert np.abs(want - x).min() > 1e-6
    # and the tolerance sees a second rounding per link
    y = torch.as_tensor(x)
    for _ in range(2 * micro.DEPTH):
        y = y * micro.A + micro.B
    assert np.abs(y.numpy() - want).max() > 4 * FMA_ATOL
    assert torch.equal(got, micro.fma_chain_plain(torch.as_tensor(x), 2))


def test_copy_matches_exp_micro(exp_micro):
    """x + 1 rounds once in both: bit-identical."""
    m = exp_micro
    x = np.random.default_rng(1).random((m.CB * m.SUB, m.LANE), np.float32)
    want = np.asarray(jax.jit(m.make_copy(2))(x))
    got = micro.copy_add(torch.as_tensor(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a CPU tensor the wrappers take the plain versions and launch
    nothing; the argument checks run before a launch."""
    before = dict(micro.LAUNCHES)
    x = torch.ones(8)
    assert torch.equal(micro.copy_add(x, 3), x + 1)
    assert micro.LAUNCHES == before
    with pytest.raises(ValueError):
        micro._check(x.double(), "fma_chain", 1, 0)
    with pytest.raises(ValueError):
        micro._check(x, "copy_add", 0, 1)


def test_micro_module_runs_on_cpu():
    """python -m minimd_torch.micro --device cpu: the timing loop end to end
    with the plain versions, exp_micro.py's lines and JSON keys, no
    device metric."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "minimd_torch.micro",
                          "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("fma:") and "GFMA/s" in lines[0]
    assert lines[1].startswith("copy:") and "GB/s" in lines[1]
    assert "TFMA" not in res.stdout and "TB/s" not in res.stdout
    got = json.loads(lines[-1])
    assert set(got) == {"fma_gops", "copy_gbps"}
    assert got["fma_gops"] > 0 and got["copy_gbps"] > 0


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    xf, xc = micro.probe_inputs("cuda")
    for reps in (2, 20):
        got = micro.fma_chain(xf, reps)
        want = micro.fma_chain_plain(xf, reps)
        assert (got - want).abs().max().item() <= FMA_ATOL
    assert torch.equal(micro.copy_add(xc, 3), micro.copy_add_plain(xc, 3))
