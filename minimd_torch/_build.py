"""Build and load the CUDA kernels of minimd_torch/csrc.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes (seconds to build, where a source that
includes PyTorch's headers takes minutes). The library goes into
`minimd_torch/_build/`, named by a hash of the sources, headers and flags,
so an edited source rebuilds and an unchanged one loads at once. A failed
compile or load raises; nothing falls back.

`build_host()` / `host_lib()` do the same for the host runtime,
`csrc/native.cpp` (the set-up and data-file hot paths), with the host C++
compiler (`CXX`, else `g++`): it needs no nvcc, so the CPU runs it too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shlex
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
HOST_SRC = CSRC / "native.cpp"
# no -ffast-math and no FMA contraction: the host runtime's arrays are
# the numpy bodies' bit for bit
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, f, eng, vir, nbx, nby, nbz, C, prdx, prdy, prdz, cutsq, eps, sig6,
    # valid_below, evflag, halo, ndom, stream
    "lj_force_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                        ctypes.c_double, _F, _F, _I, _I, _I, _P],
    # x, list, count, xref, longest, nbx, nby, nbz, C, prdx, prdy, prdz,
    # cutneigh^2, valid_below, stream
    "lj_list_build_launch": [_P] * 5 + [_I] * 4 + [_F] * 5 + [_P],
    # x, list, count, xref, longest, stale, rebuilds, f, eng, vir, nbx,
    # nby, nbz, C, prdx, prdy, prdz, cutsq, eps, sig6, cutneigh^2,
    # drift^2, valid_below, stamp, evflag, stream
    "lj_list_force_launch": [_P] * 10 + [_I] * 4 + [_F] * 4 + [
        ctypes.c_double] + [_F] * 4 + [_I, _I, _P],
    # x, v, typ, x_out, v_out, t_out, scratch, overflow, counts, nbx, nby,
    # nbz, C, prd (3), offset (3), 1/binsize (3), valid_below, global nb
    # (3), origin (3), dead, split, slot0, stream
    "rebin_launch": [_P] * 9 + [_I] * 4 + [_F] * 10 + [_I] * 8 + [
        ctypes.c_longlong, _P],
    # x, rho, fp, embed, frho, nrho, rdrho, params, nbody, nbx, nby, nbz, C,
    # prdx, prdy, prdz, valid_below, evflag, halo, ndom, stream
    "eam_rho_launch": [_P, _P, _P, _P, _P, _I, _F, _P, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _I, _I, _I, _P],
    # x, fp, f, eng, vir, params, nbody, nbx, nby, nbz, C, prdx, prdy, prdz,
    # valid_below, evflag, halo, ndom, stream
    "eam_force_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _I, _I, _I, _P],
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

_HOST_SIGNATURES = {
    # seed, n, ntypes, out (int32)
    "mmd_rand_types": (None, [ctypes.c_uint, ctypes.c_int64, _I, _P]),
    # nx, ny, nz, rho, bounds (6 f64), capacity, x, v (f64, capacity x 3)
    "mmd_create_atoms": (ctypes.c_int64, [_I, _I, _I, ctypes.c_double, _P,
                                          ctypes.c_int64, _P, _P]),
    # path, natoms, box (3 f64), mass (f64), x, v (f64, natoms x 3), line
    "mmd_read_lammps_data": (ctypes.c_int64, [ctypes.c_char_p,
                                              ctypes.c_int64, _P, _P, _P,
                                              _P, _P]),
}

_lib = None
_host_lib = None
# True once this process has compiled the kernel library (set-up's record
# says whether its kernels' part ran nvcc)
built = False


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


def kernel_sources() -> list[pathlib.Path]:
    """The files the kernel library is built from and named by: the CUDA
    sources and headers (not the host runtime's native.cpp)."""
    return sorted(CSRC.glob("*.cu*"))


def build() -> pathlib.Path:
    """Compile csrc/*.cu (if not yet built for these sources) and return
    the library path. The ptxas report (registers, spills) is kept beside
    it as ptxas.log."""
    global built
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in kernel_sources():
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
    built = True
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


def build_host() -> pathlib.Path:
    """Compile csrc/native.cpp with the host C++ compiler (`CXX`, else
    g++) if not yet built for this source, compiler and these flags, and
    return the library path. Several processes may build at once: each
    writes its own temporary file and moves it into place."""
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    h = hashlib.sha256(" ".join(cxx + HOST_FLAGS).encode())
    h.update(HOST_SRC.read_bytes())
    lib = BUILD_DIR / f"libminimd_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [*cxx, *HOST_FLAGS, "-o", str(tmp), str(HOST_SRC)]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler failed: {' '.join(cmd)}: {e}") \
            from e
    if p.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host compiler failed ({p.returncode}):\n"
                           f"{' '.join(cmd)}\n{p.stdout}")
    os.replace(tmp, lib)
    return lib


def host_lib() -> ctypes.CDLL:
    """The loaded host runtime, built on first use."""
    global _host_lib
    if _host_lib is None:
        handle = ctypes.CDLL(str(build_host()))
        for name, (restype, argtypes) in _HOST_SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _host_lib = handle
    return _host_lib


def on_device(device, switch: bool):
    """The context that makes `device` current for a launch through this
    library, when `switch` (a launch of a decomposed run, whose domains
    may sit on several cards); else none."""
    import contextlib

    import torch

    return torch.cuda.device(device) if switch else contextlib.nullcontext()


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() code from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
