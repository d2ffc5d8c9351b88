"""The share of the device's idle time in the profiled frames that falls
inside the program's SfT spans (``tracking.sft``): the gaps between the
device's busy intervals (``trace.union_intervals``), laid over the spans
that the program recorded while the profiler ran
(``profiling.timeline()``, on the trace's clock).

:func:`idle_by_span` splits the same idle time by the innermost span open
at each instant; no metric prints it."""

from portbench import trace

LAYER = "tracking/sft"
UNIT = "%"
MOVES = "frames_per_s"
SPAN = "tracking.sft"


def program_spans() -> list:
    """The program's spans of the profiled frames, or [] where the program
    keeps no timeline."""
    from defslam_tpu_torch import profiling

    timeline = getattr(profiling, "timeline", None)
    return timeline() if timeline is not None else []


def idle_intervals(tr) -> list[tuple[int, int]]:
    """The device's idle gaps between its first and last activity, in
    order (ns)."""
    busy = trace.union_intervals(tr.device)
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]


def overlap_ns(a: list[tuple], b: list[tuple]) -> int:
    """The time two ordered lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans) -> list[tuple[int, int, str]]:
    """(start, end, name) in order: each instant under a span goes to the
    innermost span open then (spans of one thread nest)."""
    out, stack, t = [], [], None

    def emit(t0, t1, name):
        if t1 > t0:
            out.append((t0, t1, name))

    for s in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        while stack and stack[-1].t1_ns <= s.t0_ns:
            top = stack.pop()
            emit(t, top.t1_ns, top.name)
            t = top.t1_ns
        if stack:
            emit(t, s.t0_ns, stack[-1].name)
        stack.append(s)
        t = s.t0_ns
    while stack:
        top = stack.pop()
        emit(t, top.t1_ns, top.name)
        t = top.t1_ns
    return out


def idle_by_span(tr, spans) -> dict:
    """Idle seconds of the trace by the innermost span open then; None
    takes the idle time outside every span."""
    gaps = idle_intervals(tr)
    segs = innermost(spans)
    out: dict = {}
    for name in {n for _, _, n in segs}:
        s = overlap_ns(gaps, [(a, b) for a, b, n in segs if n == name])
        if s:
            out[name] = s * 1e-9
    outside = sum(b - a for a, b in gaps) * 1e-9 - sum(out.values())
    if outside > 0:
        out[None] = outside
    return out


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    sft = sorted((s.t0_ns, s.t1_ns) for s in program_spans() if s.name == SPAN)
    gaps = idle_intervals(rec.trace)
    idle = sum(b - a for a, b in gaps)
    if not sft or not idle:
        return None
    return 100.0 * overlap_ns(gaps, sft) / idle
