"""Build and load the CUDA kernels of minimd_torch/csrc.

All `csrc/*.cu` files compile with nvcc into one shared library with a
plain C interface, loaded with ctypes (seconds to build, where a source
that includes PyTorch's headers takes minutes). The library goes into
`minimd_torch/_build/`, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once. A failed
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, f, eng, vir, nbx, nby, nbz, C, prdx, prdy, prdz, cutsq, eps, sig6,
    # evflag, stream
    "lj_force_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                        ctypes.c_double, _F, _I, _P],
    # cid, 6 float channels, typ, 6 float outputs, typ out, counts,
    # overflow, nbx, nby, nbz, C, stream
    "rebin_pull_launch": [_P] * 17 + [_I, _I, _I, _I, _P],
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


def build() -> pathlib.Path:
    """Compile csrc/*.cu (if not yet built for these sources) and return
    the library path. The ptxas report (registers, spills) is kept beside
    it as ptxas.log."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libminimd_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    (BUILD_DIR / "ptxas.log").write_text(res.stdout + res.stderr)
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
