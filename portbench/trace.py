"""What the benchmark reads from a ``torch.profiler`` trace.

``profiled`` runs a callable under the profiler (CPU and CUDA
activities) and returns a ``Trace``: every device operation (kernel,
memory copy or set) with its name, start and end, and the benchmark's
own host spans (``record_function`` ranges named ``portbench.<what>``)
with theirs, all in seconds on the trace's one clock.
"""
from __future__ import annotations

import dataclasses

SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    ops: list[tuple[str, float, float]]      # device: (name, start, end)
    spans: list[tuple[str, float, float]]    # host: (what, start, end)

    def busy(self) -> list[tuple[float, float]]:
        """The device's busy intervals: the union of its operations."""
        out: list[list[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def window(self) -> tuple[float, float]:
        """From the first host span's start to the last one's end."""
        return (min(s[1] for s in self.spans), max(s[2] for s in self.spans))

    def busy_s(self) -> float:
        lo, hi = self.window()
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.busy())

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations (by name) that took most time."""
        by_name: dict[str, float] = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches inside the window with no device
        operation, each named by the host span its middle falls in."""
        lo, hi = self.window()
        edges = [lo] + [t for iv in self.busy() for t in iv] + [hi]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b > a:
                mid = 0.5 * (a + b)
                what = next((s[0] for s in self.spans if s[1] <= mid <= s[2]),
                            "between spans")
                gaps.append([f"host in {what}", b - a])
        return sorted(gaps, key=lambda g: -g[1])[:n]

    def kernel_seconds(self, pattern) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name the
        compiled regular expression ``pattern`` finds."""
        hits = [b - a for name, a, b in self.ops if pattern.search(name)]
        return sum(hits), len(hits)


def profiled(fn, device) -> Trace:
    """``fn()`` under the profiler; the device's activity traced where
    ``device`` is a CUDA card (on the CPU the trace holds spans only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    ops, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((e.name[len(SPAN_PREFIX):], start, end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.name, start, end))
    return Trace(ops=ops, spans=spans)
