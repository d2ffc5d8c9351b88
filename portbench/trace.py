"""Reduction of a ``torch.profiler`` trace of the traced window (CUDA
activity only): the device's activities (kernels, copies, sets) and the
host's CUDA runtime calls, the busy time, the idle gaps and what the host
was doing in them.

Busy time is the union of the device activities' intervals (one stream
at a time, so this is the sum of the kernel times where nothing
overlaps); idle share = 1 - busy / wall.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

@dataclass
class Activity:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass
class Trace:
    """The traced window: device activities and host calls in it, and its
    wall time (host clock)."""

    device: list[Activity] = field(default_factory=list)
    host: list[Activity] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def kernels(self) -> list[Activity]:
        return [a for a in self.device if is_kernel(a.name)]

    def kernels_named(self, *fragments: str) -> list[Activity]:
        return [a for a in self.kernels if any(f in a.name for f in fragments)]


def is_kernel(name: str) -> bool:
    """A device activity that is a kernel launch (not a copy or a set)."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def from_profiler(prof, wall_s: float) -> Trace:
    """The activities of a finished ``torch.profiler.profile``, read from
    its kineto events (no per-operator tree is built)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        act = Activity(e.name(), start, start + e.duration_ns())
        if str(e.device_type()).endswith("CUDA"):
            device.append(act)
        else:
            host.append(act)
    device.sort(key=lambda a: a.start_ns)
    host.sort(key=lambda a: a.start_ns)
    return Trace(device=device, host=host, wall_s=wall_s)


def union_intervals(acts: list[Activity]) -> list[tuple[int, int]]:
    """The union of the activities' intervals, in order."""
    out: list[list[int]] = []
    for a in sorted(acts, key=lambda a: a.start_ns):
        if out and a.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], a.end_ns)
        else:
            out.append([a.start_ns, a.end_ns])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in union_intervals(trace.device)) * 1e-9


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    """[name, seconds] of the device activities that took most time, summed
    by name."""
    tot: collections.Counter = collections.Counter()
    for a in trace.device:
        tot[a.name] += a.seconds
    return [[name, s] for name, s in tot.most_common(n)]


def idle_gaps(trace: Trace, n: int = 10) -> list[list]:
    """[name, seconds] of the device's idle gaps inside the traced span,
    summed by what the host was doing at each gap's midpoint: the host
    call running then (of those begun, the one that ends last), or
    ``after <call>`` for the last one that had ended."""
    busy = union_intervals(trace.device)
    gaps = sorted(((e0 + s1) // 2, (s1 - e0) * 1e-9)
                  for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0)
    host = trace.host
    tot: collections.Counter = collections.Counter()
    i, last = 0, None  # host calls begun so far; the one of them that ends last
    for mid, sec in gaps:
        while i < len(host) and host[i].start_ns <= mid:
            if last is None or host[i].end_ns >= last.end_ns:
                last = host[i]
            i += 1
        if last is None:
            name = "host"
        elif last.end_ns >= mid:
            name = last.name
        else:
            name = f"after {last.name}"
        tot[name] += sec
    return [[name, s] for name, s in tot.most_common(n)]
