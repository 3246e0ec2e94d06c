"""The pinned micro-probes: the card's FP32 FMA rate and its memory copy
rate, through the hand-written CUDA kernels of csrc/micro.cu (the
counterparts of scripts/exp_micro.py's make_fma and make_copy).

    python -m minimd_torch.micro [--device cpu]

They are small enough that the code the compiler makes for them cannot
change much between toolchains, so a later run that finds the big kernels
slower can tell a drift in the card or its clock (both probes move) from a
drift in codegen (the probes stay):

  fma   reps x 24 dependent fmaf(y, 1.000001f, 1e-7f) per element of a
        (G*256, 128) = (16384, 128) f32 array;
  copy  y = x + 1 over (CB*256, 128) = (131072, 128) f32 (64 MB), swept
        reps times: 2 x 64 MB of memory traffic per sweep.

Method (exp_micro.py:107-147): the median of 5 slopes of the call time
between two rep counts, (2000, 6000) for fma and (100, 400) for copy, each
call consuming the previous call's output; so the fixed cost of a call
cancels. The card's calls are timed with CUDA events. `--device cpu` runs
the plain versions at rep counts (2, 4), as exp_micro.py's --interpret
runs its kernels: a smoke test of the timing loop, whose rates are the host's
and no device metric.

On the card each rate is also given as a share of the H100 SXM's
published peak: 33.5 TFMA/s (67 TFLOP/s FP32) and 3.35 TB/s. A copy share
above 1 would mean the sweeps were served from the 50 MB L2 (chip_smoke.py
checks the copy rate on a 256 MB array too).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _build

SUB, LANE = 256, 128     # one TPU block: (256, 128) f32
G = 64                   # fma blocks: (16384, 128), 8 MB
DEPTH = 24               # links per rep (exp_micro.py DEPTH)
CB = 512                 # copy blocks: (131072, 128), 64 MB
A, B = 1.000001, 1e-7    # y <- y * A + B
PEAK_FMA, PEAK_BYTES = 33.5e12, 3.35e12   # H100 SXM: FP32 FMA/s, HBM3 B/s
REPS = {"cuda": ((2000, 6000), (100, 400)), "cpu": ((2, 4), (2, 4))}

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"fma_chain": 0, "copy_add": 0}


def fma_chain_plain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """reps x DEPTH links of y * A + B, each rounded once to float32 as
    fmaf rounds it: the product of two float32 values is exact in float64,
    so only the sum rounds before the cast (a double rounding that differs
    from fmaf's single one needs the float64 sum to land on a float32 tie,
    about one link in 2^29)."""
    a = float(np.float32(A))
    b = float(np.float32(B))
    y = x
    for _ in range(reps * DEPTH):
        y = y.double().mul_(a).add_(b).to(x.dtype)
    return y


def copy_add_plain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """reps sweeps of y = x + 1."""
    y = x
    for _ in range(reps):
        y = torch.add(x, 1.0)
    return y


def _check(x: torch.Tensor, name: str, reps: int, lo: int):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous float32 tensor, got "
                         f"{x.dtype}")
    if not lo <= reps <= 65535:
        raise ValueError(f"{name}: reps must lie in [{lo}, 65535], got {reps}")


def fma_chain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """The FMA probe: y after reps x DEPTH fmaf links of every element. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, reps)
    _check(x, "fma_chain", reps, 0)
    y = torch.empty_like(x)
    rc = _build.lib().fma_chain_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), reps,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["fma_chain"] += 1
    _build.check(rc, "fma_chain_launch")
    return y


def copy_add(x: torch.Tensor, reps: int) -> torch.Tensor:
    """The copy probe: reps sweeps of y = x + 1 in one launch. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return copy_add_plain(x, reps)
    _check(x, "copy_add", reps, 1)
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("copy_add moves float4s: numel % 4 == 0 and a "
                         "16-byte aligned tensor")
    y = torch.empty_like(x)
    rc = _build.lib().copy_add_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), reps,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["copy_add"] += 1
    _build.check(rc, "copy_add_launch")
    return y


def _timed(fn, x):
    """(fn(x), seconds): CUDA events on the card, the host clock on the
    CPU."""
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(x)
        end.record()
        end.synchronize()
        return y, start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    y = fn(x)
    return y, time.perf_counter() - t0


def slope(fn, a: int, b: int, x0: torch.Tensor) -> float:
    """Seconds per rep: the median over 5 pairs of (t(b) - t(a)) /
    (b - a), both counts warmed first. The carry evolves (each call takes
    the previous call's output), as in exp_micro.py; the median, not the
    least, keeps one slow short leg from making a slope too fast.

    On the host clock (a CPU tensor) a loaded machine can make a pair's
    slope <= 0: the median is then taken over the positive slopes, and
    where none is positive, over t(b) / b (the fixed cost of a call
    included), so the slope stays above 0. The card's slopes are taken
    as they are."""
    x = fn(x0, a)
    x = fn(x, b)
    ss, per_call = [], []
    for _ in range(5):
        x, ta = _timed(lambda t: fn(t, a), x)
        x, tb = _timed(lambda t: fn(t, b), x)
        ss.append((tb - ta) / (b - a))
        per_call.append(tb / b)
    if x.device.type == "cpu":
        ss = [s for s in ss if s > 0] or per_call
    ss.sort()
    return ss[len(ss) // 2]


def _sig(v: float, digits: int = 6) -> float:
    """v rounded to `digits` significant digits (a small rate stays
    above 0, where a fixed decimal would print 0.0)."""
    return float(f"{v:.{digits}g}")


def probe_inputs(device):
    """The two probes' inputs from one numpy seed (exp_micro.py main)."""
    rng = np.random.default_rng(0)
    xf = torch.as_tensor(rng.random((G * SUB, LANE), np.float32))
    xc = torch.as_tensor(rng.random((CB * SUB, LANE), np.float32))
    return xf.to(device), xc.to(device)


def measure(device="cuda") -> dict:
    """Run both probes on `device` and print exp_micro.py's lines; returns
    the slopes and rates (and, on the card, their shares of the peaks)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the micro-probes on cuda need a CUDA card")
    (a, b), (ca, cb) = REPS[device.type]
    xf, xc = probe_inputs(device)
    card = device.type == "cuda"

    s = slope(fma_chain, a, b, xf)
    fma_gops = xf.numel() * DEPTH / s / 1e9
    share = (f" ({fma_gops * 1e9 / PEAK_FMA:.3f} of 33.5 TFMA/s)" if card
             else "")
    print(f"fma:  {s * 1e6:9.2f} us/rep  -> {fma_gops:9.1f} GFMA/s{share}",
          flush=True)
    out = {"fma_us_per_rep": s * 1e6, "fma_gops": fma_gops}

    s = slope(copy_add, ca, cb, xc)
    copy_gbps = 2 * xc.numel() * 4 / s / 1e9
    share = (f" ({copy_gbps * 1e9 / PEAK_BYTES:.3f} of 3.35 TB/s)" if card
             else "")
    print(f"copy: {s * 1e6:9.3f} us/rep -> {copy_gbps:9.1f} GB/s{share}",
          flush=True)
    out.update(copy_us_per_rep=s * 1e6, copy_gbps=copy_gbps)
    if card:
        out.update(fma_peak_share=fma_gops * 1e9 / PEAK_FMA,
                   copy_peak_share=copy_gbps * 1e9 / PEAK_BYTES)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m minimd_torch.micro",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain versions at rep counts (2, 4), a "
                        "smoke test with no device metric")
    args = p.parse_args(argv)
    got = measure(args.device)
    line = {"fma_gops": _sig(got["fma_gops"]),
            "copy_gbps": _sig(got["copy_gbps"])}
    if args.device == "cuda":
        line.update(fma_peak_share=round(got["fma_peak_share"], 4),
                    copy_peak_share=round(got["copy_peak_share"], 4),
                    device=torch.cuda.get_device_name(0))
    print(json.dumps(line))
    return got


if __name__ == "__main__":
    main()
