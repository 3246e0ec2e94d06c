"""The traced run's record: torch.profiler's chrome trace, cut down to
the benchmark's spans and the device's activities.

A span is a `torch.profiler.record_function` range the benchmark put
around a call into the program (mdbench.window around the traced
window, sim.run around each run(), sim.<closure> around a Simulation's
closures). Each kernel, memcpy and memset the device ran is given to the
innermost span that was open on the host when it was launched (matched
through the profiler's correlation id), so device time reaches a span
without any kernel name.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import tempfile

WINDOW = "mdbench.window"
KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans, times):
    """For each time, the name of the innermost span (start, end, name)
    containing it, or None. Spans nest, as ranges of one thread do."""
    out = [None] * len(times)
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, k = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while k < len(ordered) and ordered[k][0] <= t:
            while stack and stack[-1][1] < ordered[k][0]:
                stack.pop()
            stack.append(ordered[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the profiler's clock. acts: (kind, name,
    device, start, end, span); spans: (start, end, name)."""

    window: tuple
    spans: list
    acts: list

    @staticmethod
    def from_chrome(events: list) -> "Trace":
        spans, launch = [], {}
        for e in events:
            cat = e.get("cat")
            if cat == "user_annotation":
                spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                              e["name"]))
            elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = float(e["ts"])
        win = [s for s in spans if s[2] == WINDOW]
        if len(win) != 1:
            raise ValueError(f"{len(win)} {WINDOW} spans in the trace")
        raw = []
        for e in events:
            kind = KINDS.get(e.get("cat"))
            if kind is None:
                continue
            args = e.get("args", {})
            raw.append((kind, e["name"], int(args.get("device", 0)),
                        float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        launch.get(args.get("correlation"))))
        at = _innermost(spans, [r[5] if r[5] is not None else r[3]
                                for r in raw])
        acts = [r[:5] + (s,) for r, s in zip(raw, at)]
        return Trace(window=win[0][:2], spans=spans, acts=acts)

    @staticmethod
    def from_profile(prof) -> "Trace":
        """Export a finished torch.profiler.profile and read it back."""
        with tempfile.TemporaryDirectory() as d:
            path = pathlib.Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())
        events = events["traceEvents"] if isinstance(events, dict) else events
        return Trace.from_chrome(events)

    def to_json(self) -> dict:
        return {"window": list(self.window), "spans": self.spans,
                "acts": self.acts}

    @staticmethod
    def from_json(d: dict) -> "Trace":
        return Trace(window=tuple(d["window"]),
                     spans=[tuple(s) for s in d["spans"]],
                     acts=[tuple(a) for a in d["acts"]])

    # -- what the metric readers ask -----------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def calls(self, name: str) -> int:
        """How many times the span `name` was open."""
        return sum(1 for s in self.spans if s[2] == name)

    def device_s(self, span_names, kinds=tuple(KINDS.values())) -> float:
        """Device seconds of the activities launched inside these spans."""
        names = set(span_names)
        return sum(a[4] - a[3] for a in self.acts
                   if a[5] in names and a[0] in kinds) * 1e-6

    def count(self, kinds=tuple(KINDS.values())) -> int:
        return sum(1 for a in self.acts if a[0] in kinds)

    def busy(self, device: int) -> list:
        """The merged intervals in which `device` ran something, inside
        the window."""
        w0, w1 = self.window
        return [[max(s, w0), min(e, w1)] for s, e in _union(
            [(a[3], a[4]) for a in self.acts if a[2] == device])
            if e > w0 and s < w1]

    def busy_s(self, device: int) -> float:
        return sum(e - s for s, e in self.busy(device)) * 1e-6

    def gaps(self, device: int) -> list:
        """(start, end) of each idle stretch of `device` in the window."""
        out, t = [], self.window[0]
        for s, e in self.busy(device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return out

    def breakdown(self, devices) -> dict:
        """The 10 device operations that took most time (seconds summed
        over the devices) and the idle time by the span the host was in
        when each idle stretch began (seconds, mean over the devices)."""
        ops = {}
        for a in self.acts:
            ops[a[1]] = ops.get(a[1], 0.0) + (a[4] - a[3]) * 1e-6
        idle = {}
        for dev in devices:
            gaps = self.gaps(dev)
            for (s, e), name in zip(gaps, _innermost(self.spans,
                                                     [g[0] for g in gaps])):
                name = name or "outside any span"
                idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6 / len(devices)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [list(kv) for kv in top],
                "idle_gaps": [list(kv) for kv in gaps]}


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads: the traced window's trace,
    the steps it ran, the cell's atoms and style, the unordered pairs in
    the cutoff at its final state, the devices it used, and host-clock
    spans of the set-up (seconds by name)."""

    trace: Trace
    steps: int
    natoms: int
    pairs: int
    style: str
    devices: list
    host: dict
