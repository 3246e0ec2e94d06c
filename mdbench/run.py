"""Run one cell of the benchmark of minimd_torch once:

    python3 -m mdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The inputs come from the seed
(lattice.py); the program (program.py) is built from them and warmed
with one run() of the cell's length, which ends set-up. Then:

- --trace 0: run() back to back until --seconds are spent; the window
  ends in a sync of the cards. Prints the cell's end-to-end metrics:
  atom_steps_per_s (atoms x steps completed over the window's wall time)
  and setup_s (process start to the first timed step).
- --trace 1: the cell's `trace_runs` run() calls under torch.profiler,
  with spans around the program's calls (trace.py). Prints the cell's
  per-layer metrics (metrics/<name>.py), busy_s, window_s and a
  breakdown.

Either way, once the window has closed and the devices' memory peak is
read, the program runs two more steps, is freed, and checks.py judges
what it produced against the plain reference: each number compared is
printed beside its limit as the last lines on standard error and, last,
in the result's line, the one JSON object printed last on standard
output.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; if jax, jaxlib, flax, the JAX package or the
repository's bench.py has been imported by then, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "minimd_tpu", "bench")


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is one the benchmark
    may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing ({out.returncode})"


def run_cell(cell, seed: int, seconds: float, trace: bool, devices,
             t_start: float, calls: int | None = None,
             control=False) -> dict:
    """One run of `cell` on `devices`; `calls` fixes the window's run()
    calls instead of its seconds, `control` adds the control's numbers.
    Returns the result's pieces."""
    import torch

    from . import checks, lattice, reference
    from .program import Program
    from .trace import Context, Trace

    cuda = torch.device(devices[0]).type == "cuda"
    cfg, wl = cell.config, cell.workload
    steps = int(wl["steps_per_run"])
    t0 = time.perf_counter()
    if cuda:
        for d in devices:
            torch.zeros(1, device=d)
    t1 = time.perf_counter()
    mass = (reference.read_eam(cell.potential).mass if cell.potential
            else float(cfg["mass"]))
    inputs = lattice.make_inputs(cfg, wl["lattice"], seed, mass)
    t2 = time.perf_counter()
    prog = Program(cfg, wl["lattice"], inputs, devices, steps,
                   cell.potential)
    prog.sync()
    t3 = time.perf_counter()
    layout0 = prog.layout()
    row0 = prog.row0(prog.run(steps))
    prog.sync()
    t4 = time.perf_counter()
    setup_s = t4 - t_start
    construct_s = t3 - t2
    setup = {"imports": t0 - t_start, "contexts": t1 - t0, "inputs": t2 - t1,
             "from_arrays": construct_s, "warm run": t4 - t3}

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prog.add_spans()
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        win = record_function("mdbench.window")
        win.__enter__()
        calls = int(wl["trace_runs"])
    n_calls, last = 0, None
    w0 = time.perf_counter()
    while True:
        if trace:
            with torch.profiler.record_function("sim.run"):
                last = prog.run(steps)
        else:
            last = prog.run(steps)
        n_calls += 1
        if calls is not None:
            if n_calls >= calls:
                break
        elif time.perf_counter() - w0 >= seconds:
            break
    prog.sync()
    window_s = time.perf_counter() - w0
    if trace:
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) if cuda else 0
    run = {"row0": row0, "row": tuple(last[-1]), "final": prog.snapshot(),
           "overflow": prog.overflow(), "layout0": layout0,
           "layout": prog.layout()}
    prog.run(2)
    run["after2"] = prog.snapshot()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    model = reference.Model(cfg, inputs.box, inputs.natoms, cell.config_dir)
    numbers, ctrl, pairs = checks.evaluate(
        model, inputs, cfg["ntypes"], run, torch.device(devices[0]),
        control=control)
    limits = {k: float(wl["limits"][k]) for k in numbers}
    out = {"correct": checks.verdict(numbers, limits), "numbers": numbers,
           "limits": limits, "control": ctrl, "calls": n_calls,
           "natoms": inputs.natoms, "steps": n_calls * steps,
           "setup_s": setup_s, "construct_s": construct_s, "setup": setup,
           "window_s": window_s, "peak": peak, "pairs": pairs}
    if trace:
        tr = Trace.from_profile(prof)
        ids = list(range(len(devices)))
        ctx = Context(trace=tr, steps=n_calls * steps, natoms=inputs.natoms,
                      pairs=pairs, style=cfg["style"], devices=ids,
                      host={"construct_s": construct_s})
        out["trace"] = tr
        out["busy_s"] = sum(tr.busy_s(d) for d in ids) / len(ids)
        out["breakdown"] = tr.breakdown(ids)
        out["ctx"] = ctx
    return out


def result_line(cell, res, trace: bool, devices, card: str) -> dict:
    """The JSON result: correct, attempted, failed, metrics, device,
    breakdown (traced), and the checks last."""
    import torch

    from . import spec

    metrics = {}
    if not trace:
        rate = res["natoms"] * res["steps"] / res["window_s"] / 1e6
        got = {"atom_steps_per_s": rate, "setup_s": res["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.reader(m["name"])(res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": len(devices), "memory_peak_bytes": res["peak"],
              "power_limit": card}
    if trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["trace"].window_s
    line = {"correct": res["correct"], "attempted": res["calls"],
            "failed": 0 if res["correct"] else res["calls"],
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": v, "limit": res["limits"][k]}
                      for k, v in res["numbers"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mdbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        eprint(f"{args.workload} needs {cell.chips} CUDA card(s); "
               f"{torch.cuda.device_count()} visible")
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices,
                   T_START)
    card = card_line()
    eprint(f"# {torch.cuda.get_device_name(0)} | {card} | torch "
           f"{torch.__version__} cuda {torch.version.cuda} | {args.workload} "
           f"seed {args.seed}")
    found = forbidden_modules()
    if found:
        eprint(f"loaded modules the benchmark may not load: {found}")
        return 3
    line = result_line(cell, res, bool(args.trace), devices, card)
    eprint(f"# {res['natoms']} atoms, {res['calls']} "
           f"run({cell.workload['steps_per_run']}) calls in "
           f"{res['window_s']:.3f} s; set-up {res['setup_s']:.3f} s ("
           + ", ".join(f"{k} {v:.3f}" for k, v in res["setup"].items())
           + f" s); unordered pairs {res['pairs']}; peak {res['peak']} B")
    for name, m in line["metrics"].items():
        share = f" of the H100 peaks ({card})" if m["unit"] == "%" else ""
        eprint(f"# {name} = {m['value']!r} {m['unit']}{share}")
    for k, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        eprint(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
