"""The readers of the program's own spans and set-up record on a small
hand-built trace whose answers are known (the events as torch.profiler
writes them, as in test_mdbench_metrics.py), and the set-up record
reaching the readers of a traced run on the CPU."""

import time

import pytest

from conftest import small_cell
from mdbench import run, spec
from mdbench.trace import Context, Trace
from minimd_torch import timer

NEW = ("sim.loop_idle_pct", "sim.edge_idle_ms_per_run",
       "sim.kick_us_per_step", "setup.geometry_s", "setup.eam_tables_s")


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0}


def _launch(corr, t):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": t, "dur": 1, "args": {"correlation": corr}}


def _act(name, corr, t0, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": t0, "dur": dur,
            "args": {"correlation": corr, "device": 0}}


# Two run() calls, one interval each. The device runs 100-130 (a kick,
# launched in the first interval), 130-400 and 560-900 (forces, launched
# in the harness's spans), 420-430 (the end's copy, launched in
# minimd.run.end) and 550-560 (a fused interval's seed, in minimd.kick):
# idle 0-100, 400-420, 430-550 and 900-1000. Inside the intervals
# (50-450, 550-950): 50 + 20 + 20 + 50 = 140 us of the 340 us idle.
HARNESS = [
    _span("mdbench.window", 0, 1000),
    _span("sim.run", 10, 490), _span("sim.run", 510, 990),
    _span("sim.force_fn_noev", 70, 80), _span("sim.force_fn", 560, 570),
    _launch(1, 65), _launch(2, 75), _launch(3, 460), _launch(4, 565),
    _launch(5, 553),
    _act("vectorized_elementwise_kernel", 1, 100, 30),
    _act("lj_force_kernel<false>", 2, 130, 270),
    _act("Memcpy DtoH", 3, 420, 10),
    _act("lj_force_kernel<true>", 4, 560, 340),
    _act("lj_step_seed", 5, 550, 10),
]
PROGRAM = [
    _span("minimd.run", 20, 480), _span("minimd.run", 520, 980),
    _span("minimd.run.begin", 25, 45), _span("minimd.run.begin", 525, 545),
    _span("minimd.interval", 50, 450), _span("minimd.interval", 550, 950),
    _span("minimd.kick", 552, 556), _span("minimd.run.end", 455, 475),
]
RECORD = {"geometry": 1.75, "upload": 0.25, "tables": 1.25, "kernels": 0.0,
          "first_force": 0.125, "built": False}
STEPS = 4


def _ctx(events, style="eam", devices=(0,)):
    return Context(trace=Trace.from_chrome(events), steps=STEPS,
                   natoms=864000, pairs=1, style=style, devices=list(devices),
                   host={"construct_s": 3.5})


def _on_two_devices(events):
    """The events with each launch and activity repeated on device 1."""
    out = list(events)
    for e in events:
        if "correlation" in e.get("args", {}):
            args = {**e["args"], "correlation": e["args"]["correlation"] + 100}
            if "device" in args:
                args["device"] = 1
            out.append({**e, "args": args})
    return out


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_idle_split_sums_to_device_idle():
    ctx = _ctx(HARNESS + PROGRAM)
    idle = _read("device.idle_pct", ctx)
    loop = _read("sim.loop_idle_pct", ctx)
    edge = _read("sim.edge_idle_ms_per_run", ctx)
    assert idle == pytest.approx(34.0)
    assert loop == pytest.approx(14.0)
    assert edge == pytest.approx((0.340 - 0.140) / 2)
    assert loop + edge * 2 / (ctx.trace.window_s * 1e3) * 100 == \
        pytest.approx(idle)


def test_kick_reader_takes_only_kick_activities():
    """The activities launched directly in an interval or in a seed's
    minimd.kick, not those of the harness's spans or the run's end; a
    mean over the devices, as the idle readers take."""
    ctx = _ctx(HARNESS + PROGRAM)
    assert [a[5] for a in ctx.trace.acts] == [
        "minimd.interval", "sim.force_fn_noev", "minimd.run.end",
        "sim.force_fn", "minimd.kick"]
    assert _read("sim.kick_us_per_step", ctx) == pytest.approx(40 / STEPS)
    two = _ctx(_on_two_devices(HARNESS + PROGRAM), devices=(0, 1))
    assert _read("sim.kick_us_per_step", two) == pytest.approx(40 / STEPS)
    assert _read("device.idle_pct", two) == pytest.approx(34.0)
    assert _read("sim.loop_idle_pct", two) == pytest.approx(14.0)


def test_host_readers(monkeypatch):
    """The host-clock readers take the program's record of its latest
    construction."""
    monkeypatch.setattr(timer, "last_setup", dict(RECORD))
    ctx = _ctx(HARNESS + PROGRAM)
    assert _read("setup.geometry_s", ctx) == 1.75
    assert _read("setup.eam_tables_s", ctx) == 1.25
    assert _read("setup.eam_tables_s", _ctx(HARNESS, style="lj")) is None


def test_new_readers_find_nothing_without_the_programs_spans(monkeypatch):
    """What a program without the spans and the record (the parent of
    the change that added them) gives: every new reader returns None."""
    monkeypatch.delattr(timer, "last_setup")
    ctx = _ctx(HARNESS)
    assert _read("device.idle_pct", ctx) == pytest.approx(34.0)
    for name in NEW:
        assert _read(name, ctx) is None, name


def test_traced_cpu_run_carries_the_setup_record():
    """A traced run of the EAM cell on the CPU at 4^3 cells: the
    program's record of its set-up reaches the readers, its parts sum to
    no more than construct_s."""
    cell = small_cell("eam_cu.864k", (4, 4, 4), 20, trace_runs=2)
    res = run.run_cell(cell, 2 ** 31 + 5, 0, True, ["cpu"],
                       time.perf_counter())
    rec, ctx = timer.last_setup, res["ctx"]
    parts = ("geometry", "upload", "tables", "kernels", "first_force")
    assert list(rec) == [*parts, "built"]
    assert 0 < sum(rec[k] for k in parts) <= ctx.host["construct_s"]
    assert _read("setup.geometry_s", ctx) == rec["geometry"] > 0
    assert _read("setup.eam_tables_s", ctx) == rec["tables"] > 0
    assert ctx.trace.calls("minimd.run") == 2
    assert ctx.trace.calls("minimd.interval") == 2
