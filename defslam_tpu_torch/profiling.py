"""The port's tracer: spans at the program's layer boundaries (the reference
has none: only ad-hoc ``cv::getTickCount`` prints,
GroundTruthFrame.cc:196-214), counters of calls and bytes, and two
counters for the card.

Port of ``defslam_tpu/profiling.py``, grown into spans:

- ``stage(name, sync=None, frame=None)``: a span around a region.  It
  records its start and end in ``time.time_ns()`` nanoseconds, which is
  the clock of a ``torch.profiler`` trace's events, so spans lie on the
  device trace's timeline; the span open when it began (its parent); and
  the id of the frame it serves (``frame``, else its parent's).  With
  ``sync`` (a tensor or a tuple of them) it first waits for that work on
  the device, through a CUDA event recorded on each CUDA device the
  tensors live on (nothing to wait for on the CPU), before it ends.
- A span records in two cases.  While ``enable()`` / ``DEFSLAM_PROFILE=1``
  is on, into the per-name aggregates of ``report()`` / ``print_report()``
  (count, total, mean, max and mean self time: the span's time less its
  children's).  While a ``torch.profiler`` session runs, of any activity
  set, into the timeline that ``timeline()`` returns (``report(reset=True)``
  leaves it), and as a ``record_function`` range of its name, which a
  session with CPU activity shows in its trace.  Off, a span costs one
  branch: no clock read, no allocation, no CUDA event, no sync.
- ``count(name, nbytes)``: one call of a counter and the bytes it
  carries, kept while ``enable()`` is on, beside the spans in
  ``report()`` (``count`` and ``bytes``), and reset with them.  Off, it
  costs one branch.
- ``host_waits()``: the operations in a region that make the host wait
  for the card (``torch.cuda.set_sync_debug_mode``), counted by source
  line;
- ``kernel_launches(system)``: this process's kernel launches by name, for
  ``parallel.driver.Driver.gather`` to read on every rank.

Spans sit at layer boundaries, never inside a solver's iterations: a
tracked frame records ``frame.dispatch`` (with ``frontend.extract``,
``tracking.match``, ``tracking.sft``), ``frame.finalize``, ``host.wait``
and, on a keyframe, ``keyframe.dispatch`` (or ``_a`` and ``_b``) with its
stages; the rigid mode ``rigid.frame`` with ``rigid.match``,
``rigid.pose``, ``rigid.keyframe`` and ``rigid.local_ba``.

A System that spans a world of ranks (``parallel.enabled``) records, on
each rank that has the tracer on: ``parallel.forward`` (rank 0 of a world
it made: the pickling and gloo broadcast of each call sent to the
workers, ``parallel.driver.forwarding``; the frame the call serves);
``parallel.sft`` around the sharded SfT (``tracker.sft_track_sharded``),
inside ``tracking.sft`` on a frame and inside ``keyframe.reanchor`` after
a template swap; ``keyframe.legacy`` around the host-orchestrated keyframe
chain and its re-anchor (``System._insert_keyframe``), with the fused
chain's stage names where the stage is the same (``keyframe.insert``,
``.warps``, ``.densify``, ``.normals``, ``.sfn_registration``,
``.retemplate``, ``.cull``, ``.reanchor``); and the counter
``parallel.all_reduce``, fed by ``parallel.sharded.Group.all_reduce``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import warnings
from typing import NamedTuple

import torch
import torch.autograd.profiler as _torch_profiler

_ENABLED = os.environ.get("DEFSLAM_PROFILE", "0") not in ("0", "", "false")
# per name: [count, total ns, max ns, self ns]
_AGG: dict[str, list[int]] = {}
# per counter name: [calls, bytes]
_COUNTS: dict[str, list[int]] = {}
# the spans recorded under a profiler session, newest last; bounded, so a
# long session keeps its latest spans
_TIMELINE: collections.deque = collections.deque(maxlen=200_000)
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .open: this thread's open spans, innermost last


class Span(NamedTuple):
    """A finished span: times in ``time.time_ns()`` nanoseconds, the ids of
    the span and of its parent (None at the top), the frame it serves."""

    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int | None
    frame: int | None


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def _wait_for(obj) -> None:
    """Block until the work queued so far on the CUDA devices that hold the
    tensors of ``obj`` is done (one event per device); no-op on the CPU."""
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        with torch.cuda.device(dev):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _Open:
    """A span being recorded (the context manager ``stage`` returns when
    the tracer is on)."""

    __slots__ = ("name", "sync", "frame", "id", "parent", "child_ns", "t0_ns",
                 "to_report", "to_timeline", "range")

    def __init__(self, name: str, sync, frame):
        self.name, self.sync, self.frame = name, sync, frame

    def __enter__(self):
        stack = getattr(_LOCAL, "open", None)
        if stack is None:
            stack = _LOCAL.open = []
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        self.id = next(_IDS)
        self.child_ns = 0
        self.to_report = _ENABLED
        self.to_timeline = _torch_profiler._is_profiler_enabled
        stack.append(self)
        self.t0_ns = time.time_ns()
        self.range = None
        if self.to_timeline:
            self.range = _torch_profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.sync is not None:
                _wait_for(self.sync)
        finally:
            if self.range is not None:
                self.range.__exit__(None, None, None)
            t1 = time.time_ns()
            self.sync = None
            stack = _LOCAL.open
            stack.pop()
            dur = t1 - self.t0_ns
            if stack:
                stack[-1].child_ns += dur
            if self.to_report:
                agg = _AGG.get(self.name)
                if agg is None:
                    agg = _AGG[self.name] = [0, 0, 0, 0]
                agg[0] += 1
                agg[1] += dur
                agg[2] = max(agg[2], dur)
                agg[3] += dur - self.child_ns
            if self.to_timeline:
                _TIMELINE.append(Span(self.name, self.t0_ns, t1, self.id, self.parent,
                                      self.frame))
        return False


_OFF = contextlib.nullcontext()


def stage(name: str, sync=None, frame: int | None = None):
    """A span named ``name`` around the ``with`` block; pass a tensor (or a
    tuple of them) as ``sync`` to wait for it on the device before the span
    ends, and ``frame`` for the id of the frame it serves (else its
    parent's)."""
    if not (_ENABLED or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, sync, frame)


def count(name: str, nbytes: int = 0) -> None:
    """One call of the counter ``name``, carrying ``nbytes``; kept while
    ``enable()`` is on."""
    if not _ENABLED:
        return
    agg = _COUNTS.get(name)
    if agg is None:
        agg = _COUNTS[name] = [0, 0]
    agg[0] += 1
    agg[1] += nbytes


def report(reset: bool = False) -> dict[str, dict]:
    """Per span name, over the spans recorded while ``enable()`` was on:
    ``count``, ``total_s``, ``mean_ms``, ``max_ms`` and ``self_ms`` (the
    mean of each span's time less the time of the spans inside it); per
    counter name, over the same time, ``count`` (its calls) and
    ``bytes``."""
    out = {}
    for name, (count, total, peak, own) in sorted(_AGG.items()):
        out[name] = dict(
            count=count,
            total_s=total * 1e-9,
            mean_ms=1e-6 * total / max(count, 1),
            max_ms=1e-6 * peak,
            self_ms=1e-6 * own / max(count, 1),
        )
    for name, (calls, nbytes) in sorted(_COUNTS.items()):
        out[name] = dict(count=calls, bytes=nbytes)
    if reset:
        _AGG.clear()
        _COUNTS.clear()
    return out


def timeline(reset: bool = False) -> list[Span]:
    """The spans recorded while a ``torch.profiler`` session ran, in the
    order they ended; ``reset`` empties it after the read."""
    out = list(_TIMELINE)
    if reset:
        _TIMELINE.clear()
    return out


def print_report(reset: bool = False):
    rows = report(reset)
    if not rows:
        return
    width = max(len(n) for n in rows)
    print(f"{'stage':<{width}}  count   mean ms    self ms    max ms   total s")
    for name, r in rows.items():
        if "bytes" in r:  # a counter
            print(f"{name:<{width}}  {r['count']:5d}  calls, {r['bytes']} bytes")
            continue
        print(f"{name:<{width}}  {r['count']:5d}  {r['mean_ms']:8.1f}  {r['self_ms']:9.1f}"
              f"  {r['max_ms']:8.1f}  {r['total_s']:8.2f}")


@contextlib.contextmanager
def host_waits(mode: str = "warn"):
    """Count, by ``file:line``, the operations in the region that make the
    host wait for the CUDA stream (a value read on the host, a copy from
    pageable memory), as ``torch.cuda.set_sync_debug_mode`` reports them.
    Yields the Counter, filled when the region ends.  ``mode="error"``
    makes the first such operation raise instead.  Waits on a CUDA event
    (``utils.Readback``) are not counted: they wait for the work up to the
    event, not for the stream."""
    counts: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts.update(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                  if "called a synchronizing CUDA operation" in str(w.message))


def kernel_launches(system=None, clear: bool = False) -> dict[str, int]:
    """This process's hand-written kernel launches by name
    (``ops.cuda_build.LAUNCHES``), set to 0 after the read with ``clear``.
    Takes the rank's System, as a target of
    ``parallel.driver.Driver.gather`` (``gather(s, kernel_launches)``
    gives every rank's counts), and ignores it."""
    from defslam_tpu_torch.ops import cuda_build

    out = dict(cuda_build.LAUNCHES)
    if clear:
        cuda_build.LAUNCHES.clear()
    return out
