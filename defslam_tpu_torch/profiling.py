"""Lightweight stage timers and device traces (the reference has none:
only ad-hoc ``cv::getTickCount`` prints, GroundTruthFrame.cc:196-214).

Port of ``defslam_tpu/profiling.py``:

- ``stage(name, sync=None)``: a context manager that adds the stage's wall
  time to a per-stage list; with ``sync`` (a tensor or a tuple of them) it
  first waits for that work on the device, through a CUDA event recorded
  on each CUDA device the tensors live on (nothing to wait for on the CPU);
- ``report()`` / ``print_report()``: per-stage count, total, mean, max;
- ``device_trace(dir)``: a ``torch.profiler`` trace of a region, written
  for TensorBoard;
- ``host_waits()``: the operations in a region that make the host wait
  for the card (``torch.cuda.set_sync_debug_mode``), counted by source
  line;
- ``kernel_launches(system)``: this process's kernel launches by name, for
  ``parallel.driver.Driver.gather`` to read on every rank.

Enabled by ``DEFSLAM_PROFILE=1``; off by default, when the timers cost
one branch (the hot path does not pay for observability).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings
from collections import defaultdict

import torch

_ENABLED = os.environ.get("DEFSLAM_PROFILE", "0") not in ("0", "", "false")
_STAGES: dict[str, list[float]] = defaultdict(list)


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


@contextlib.contextmanager
def stage(name: str, sync=None):
    """Time a stage; pass a tensor (or a tuple of them) as ``sync`` to wait
    for it on the device before the clock stops."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            _wait_for(sync)
        _STAGES[name].append(time.perf_counter() - t0)


def report(reset: bool = False) -> dict[str, dict]:
    out = {}
    for name, times in sorted(_STAGES.items()):
        out[name] = dict(
            count=len(times),
            total_s=sum(times),
            mean_ms=1000.0 * sum(times) / max(len(times), 1),
            max_ms=1000.0 * max(times),
        )
    if reset:
        _STAGES.clear()
    return out


def print_report(reset: bool = False):
    rows = report(reset)
    if not rows:
        return
    width = max(len(n) for n in rows)
    print(f"{'stage':<{width}}  count   mean ms    max ms   total s")
    for name, r in rows.items():
        print(f"{name:<{width}}  {r['count']:5d}  {r['mean_ms']:8.1f}"
              f"  {r['max_ms']:8.1f}  {r['total_s']:8.2f}")


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the region (host ops, and the device's
    kernels where CUDA is present), written under ``logdir`` for
    TensorBoard.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof


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
