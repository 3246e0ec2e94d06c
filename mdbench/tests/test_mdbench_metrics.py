"""Each per-layer metric reader on a small trace whose answers are known:
torch.profiler's chrome-trace events as the CUDA profiler writes them
(spans as user_annotation, launches as cuda_runtime, device activities
matched to them by correlation id)."""

import pytest

from mdbench import roofline, spec
from mdbench.trace import Context, Trace


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0}


def _launch(corr, t):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": t, "dur": 1, "args": {"correlation": corr}}


def _act(cat, name, corr, t0, dur, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": dur,
            "args": {"correlation": corr, "device": device}}


EVENTS = [
    _span("mdbench.window", 0, 1000),
    _span("sim.run", 10, 490), _span("sim.run", 510, 990),
    _span("sim.force_fn", 20, 30), _span("sim.force_fn_noev", 100, 110),
    _span("sim.force_fn_noev", 520, 530), _span("sim.rebin_fn", 200, 210),
    _launch(1, 25), _launch(2, 105), _launch(3, 525), _launch(4, 205),
    _launch(7, 206), _launch(5, 300), _launch(6, 600),
    _act("kernel", "lj_force_kernel<true>", 1, 30, 100),
    _act("kernel", "lj_force_kernel<false>", 2, 130, 100),
    _act("kernel", "lj_force_kernel<false>", 3, 530, 100),
    _act("kernel", "rebin_gather_kernel", 4, 230, 10),
    _act("gpu_memset", "Memset (Device)", 7, 240, 2),
    _act("kernel", "add_kernel", 5, 300, 50),
    _act("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 6, 650, 20, 1),
    {"ph": "X", "cat": "cpu_op", "name": "aten::add_", "ts": 299, "dur": 2},
]
NATOMS, PAIRS, STEPS = 864000, 23_670_000, 40


def _ctx(style="lj", devices=(0, 1)):
    return Context(trace=Trace.from_chrome(EVENTS), steps=STEPS,
                   natoms=NATOMS, pairs=PAIRS, style=style,
                   devices=list(devices), host={"construct_s": 3.25})


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_spans_take_their_launches():
    tr = _ctx().trace
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.calls("sim.force_fn_noev") == 2
    assert tr.device_s(["sim.force_fn", "sim.force_fn_noev"]) == \
        pytest.approx(300e-6)
    assert tr.device_s(["sim.rebin_fn"]) == pytest.approx(12e-6)
    assert tr.device_s(["sim.run"]) == pytest.approx(70e-6)
    assert tr.busy_s(0) == pytest.approx(362e-6)


def test_readers():
    ctx = _ctx()
    assert _read("setup.construct_s", ctx) == 3.25
    assert _read("sim.launches_per_step", ctx) == pytest.approx(7 / STEPS)
    assert _read("device.idle_pct", ctx) == pytest.approx(
        100 * ((1 - 0.362) + (1 - 0.020)) / 2)
    lj = roofline.lj_force(NATOMS, PAIRS)[0]
    assert _read("lj_force_roofline", ctx) == pytest.approx(
        100 * lj / 100e-6)
    assert _read("rebin_roofline", ctx) == pytest.approx(
        100 * roofline.rebin(NATOMS)[0] / 12e-6)
    assert _read("eam_force_roofline", ctx) is None
    eam = _ctx(style="eam")
    assert _read("eam_force_roofline", eam) == pytest.approx(
        100 * roofline.eam_force(NATOMS, PAIRS)[0] / 100e-6)
    assert _read("lj_force_roofline", eam) is None


def test_readers_find_nothing_in_an_empty_window():
    ctx = Context(trace=Trace.from_chrome(EVENTS[:1]), steps=STEPS,
                  natoms=NATOMS, pairs=PAIRS, style="lj", devices=[0],
                  host={})
    for name in ("setup.construct_s", "sim.launches_per_step",
                 "device.idle_pct", "lj_force_roofline", "rebin_roofline"):
        assert _read(name, ctx) is None, name


def test_breakdown():
    b = _ctx(devices=(0,)).trace.breakdown([0])
    assert b["device_ops"][0] == ["lj_force_kernel<false>",
                                  pytest.approx(200e-6)]
    idle = dict(b["idle_gaps"])
    # each idle stretch by the span open on the host when it began
    assert sum(idle.values()) == pytest.approx(1e-3 - 362e-6)
    assert idle["mdbench.window"] == pytest.approx(30e-6)
    assert idle["sim.run"] == pytest.approx(
        (300 - 242 + 530 - 350 + 1000 - 630) * 1e-6)


@pytest.mark.parametrize("name", ["lj_fcc", "eam_cu"])
def test_readers_on_recorded_card_traces(name):
    """Traces the card recorded (NVIDIA H100 80GB HBM3, 700.00 W): the
    cell's configuration at 2,048 atoms, 2 run(20) calls under
    torch.profiler (tests/data/trace_<config>.2048.json)."""
    import json
    import pathlib

    d = json.loads((pathlib.Path(__file__).parent / "data" /
                    f"trace_{name}.2048.json").read_text())
    style = "lj" if name == "lj_fcc" else "eam"
    ctx = Context(trace=Trace.from_json(d["trace"]), steps=d["steps"],
                  natoms=d["natoms"], pairs=d["pairs"], style=style,
                  devices=d["devices"], host={"construct_s": 1.0})
    tr = ctx.trace
    assert Trace.from_json(tr.to_json()) == tr
    assert tr.calls("sim.run") == 2 and d["steps"] == 40
    assert tr.calls("sim.force_fn") + tr.calls("sim.force_fn_noev") == 40
    assert tr.calls("sim.rebin_fn") == 2
    assert _read("sim.launches_per_step", ctx) == len(tr.acts) / 40
    assert 0 < _read("device.idle_pct", ctx) < 100
    assert 0 < _read("rebin_roofline", ctx) <= 100
    own, other = (("lj_force_roofline", "eam_force_roofline")
                  if style == "lj" else
                  ("eam_force_roofline", "lj_force_roofline"))
    assert 0 < _read(own, ctx) <= 100
    assert _read(other, ctx) is None
    names = [a[1] for a in tr.acts
             if a[5] in ("sim.force_fn", "sim.force_fn_noev")]
    assert any(f"{style}_force" in n for n in names)
