"""The traced window: torch.profiler over the requests, reduced to device
intervals, the benchmark's own spans and the host ops around each idle gap.

Device activity is every event the profiler places on the card (kernels,
copies, sets), less the profiler's copies of the benchmark's own spans on
the device timeline; its union over the traced window is the device's busy
time.  An idle gap is a stretch of the window with no device activity,
named by the benchmark's innermost span (``bench.*``) over its middle, the
innermost other host op there ("python" where none: the host ran no torch
op), and the device op before the gap.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

WINDOW_SPAN = "bench.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) of the traced window, profiler microseconds
    device: list  # [(start, end, name)] device events inside the window
    host: list  # [(start, end, name)] host events inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        out = []
        for a, b, _ in sorted(self.device):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> list:
        """Device events that are kernels (not copies or sets)."""
        return [e for e in self.device if not e[2].startswith(("Memcpy", "Memset"))]

    def device_ops(self) -> list:
        """[[name, seconds]]: the device operations that took the most time,
        names cut at 120 characters and summed."""
        by: dict = {}
        for a, b, name in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[[name, seconds]]: the longest stretches of the window with no
        device activity, by what the host was doing in their middle."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._gap_name(a, b), (b - a) / 1e6] for a, b in gaps[:TOP]]

    def _gap_name(self, a: float, b: float) -> str:
        t = (a + b) / 2
        own = [e for e in self.host if e[0] <= t <= e[1] and e[2].startswith("bench.")]
        other = [e for e in self.host if e[0] <= t <= e[1] and not e[2].startswith("bench.")]
        name = min(own, key=lambda e: e[1] - e[0])[2] if own else "host"
        name += " > " + (min(other, key=lambda e: e[1] - e[0])[2] if other else "python")
        before = [e for e in self.device if e[1] <= a]
        if before:
            name += ", after " + _short(max(before, key=lambda e: e[1])[2])
        return name


def _short(kernel: str) -> str:
    """A device op's name without its return type, arguments, template
    arguments and namespaces."""
    k = kernel.removeprefix("void ").split("(")[0].split("<")[0]
    return k.split("::")[-1][:60]


class Profiler:
    """torch.profiler over CPU and CUDA activity; ``result()`` after exit."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return self._prof.__exit__(*exc)

    def result(self) -> Trace:
        dev, host, window = [], [], None
        for e in self._prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            if str(e.device_type).endswith("CUDA"):
                if not e.name.startswith("bench."):  # a span's copy on the device
                    dev.append(span)
            else:
                host.append(span)
                if e.name == WINDOW_SPAN:
                    window = span[:2]
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        a, b = window
        return Trace(
            window=window,
            device=[(max(s, a), min(t, b), n) for s, t, n in dev if t > a and s < b],
            host=[h for h in host if h[1] > a and h[0] < b],
        )
