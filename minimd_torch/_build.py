"""Build and load the CUDA kernels of minimd_torch/csrc.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes (seconds to build, where a source that
includes PyTorch's headers takes minutes). The library goes into
`minimd_torch/_build/`, named by a hash of the sources, headers and flags,
so an edited source rebuilds and an unchanged one loads at once. A failed
compile or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, f, eng, vir, nbx, nby, nbz, C, prdx, prdy, prdz, cutsq, eps, sig6,
    # valid_below, evflag, stream
    "lj_force_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                        ctypes.c_double, _F, _F, _I, _P],
    # cid, 6 float channels, typ, 6 float outputs, typ out, counts,
    # overflow, nbx, nby, nbz, C, stream
    "rebin_pull_launch": [_P] * 17 + [_I, _I, _I, _I, _P],
    # x, rho, fp, embed, frho, nrho, rdrho, params, nbody, nbx, nby, nbz, C,
    # prdx, prdy, prdz, valid_below, evflag, stream
    "eam_rho_launch": [_P, _P, _P, _P, _P, _I, _F, _P, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _I, _P],
    # x, fp, f, eng, vir, params, nbody, nbx, nby, nbz, C, prdx, prdy, prdz,
    # valid_below, evflag, stream
    "eam_force_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _I, _P],
    # x, w, x_next, eng, vir, vsq, nbx, nby, nbz, C, prdx, prdy, prdz,
    # cutsq, eps, sig6, dt, dtf, valid_below, evflag, stream
    "lj_step_launch": [_P] * 6 + [_I] * 4 + [_F] * 4 + [
        ctypes.c_double, _F, _F, _F, _F, _I, _P],
    # x, rho, fp, embed, frho, nrho, rdrho, tab, rowmap, nbx, nby, nbz, C,
    # prdx, prdy, prdz, valid_below, evflag, stream
    "eam_rho_rows_launch": [_P] * 5 + [_I, _F, _P, _P] + [_I] * 4 + [
        _F] * 4 + [_I, _P],
    # x, fp, f, eng, vir, tab, rowmap, nbx, nby, nbz, C, prdx, prdy, prdz,
    # valid_below, evflag, stream
    "eam_force_rows_launch": [_P] * 7 + [_I] * 4 + [_F] * 4 + [_I, _P],
    # x, y, n, reps, stream (the micro-probes)
    "fma_chain_launch": [_P, _P, ctypes.c_longlong, _I, _P],
    "copy_add_launch": [_P, _P, ctypes.c_longlong, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels of minimd_torch cannot be built")
    return path


def _run_all(cmds) -> list[str]:
    """Run the commands side by side; raise on the first that fails.
    Returns their outputs (stdout + stderr)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build() -> pathlib.Path:
    """Compile csrc/*.cu (if not yet built for these sources) and return
    the library path. The ptxas report (registers, spills) is kept beside
    it as ptxas.log."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libminimd_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                      str(o), str(s)] for s, o in zip(srcs, objs)])
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    for o in objs:
        o.unlink()
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() code from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
