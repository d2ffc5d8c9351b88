"""One ``System`` over every visible card, driven from the caller's process.

A JAX ``System`` with ``parallel.enabled`` spans every device of its mesh
from the process that built it (``n_devices`` 0: every visible device).  A
PyTorch process drives one card, so a ``System`` with ``parallel.enabled``
built in a process that is no rank of a world yet (no launcher
environment, no ``coordinator``, no process group up) makes the world
itself when ``parallel.n_devices`` asks for more than one device
(:func:`spans`):

- the caller's process becomes rank 0, on ``cuda:0`` (or on the CPU over
  gloo); it builds the kernels, then starts ranks 1..N-1 as worker
  processes (:mod:`~defslam_tpu_torch.parallel.worker`) through
  :func:`~defslam_tpu_torch.parallel.launch.start`, the process layer of
  ``parallel.launch`` (``[rank r]`` on their output, the cores shared out,
  a ``file://`` rendezvous in a temporary directory, each rank's session
  swept at the end), and joins the group with them: NCCL on the cards,
  gloo on the CPU;
- each worker builds a ``System`` of its own on ``cuda:r`` with the
  worker's config (:func:`worker_config`: no output directory, no drawn
  frames) and runs the calls that rank 0 sends it, in order, until
  ``shutdown``;
- rank 0 sends every call that changes state or runs a collective
  (:data:`FORWARDED`) before it runs the call itself, so that the ranks
  meet at every all-reduce in the same order.  The calls that write files
  and drain the pipeline on the way (:data:`FLUSHED`) run on rank 0 alone
  after a ``flush`` sent to every rank (a drain may replay a frame, and a
  replay runs the sharded solve); the calls that only read
  (:data:`LOCAL`) stay on rank 0.

A call travels as its name and arguments (numpy arrays, scalars, dicts),
pickled, in one broadcast on a gloo group of its own: a host-side
exchange that makes no host wait on the card.  A tensor argument goes as
a numpy array (one on the card is copied to the host first, a host wait:
the apps pass numpy frames).  ``chip_smoke.py`` phase 15 measures this
against a header on gloo plus an NCCL broadcast of rank 0's device copy.

No fallback.  A worker that fails to start or to join makes ``System()``
raise.  A worker that exits makes rank 0's call raise ``RuntimeError``
with its rank and exit code: at the call's start, or inside it where a
collective meets the lost rank (on the cards a watcher thread aborts the
NCCL group at once, so that the call raises rather than waiting for the
collective timeout); the world is then taken down.  ``shutdown()``, or the
``System`` going away without it (a ``weakref.finalize``, which also runs
at the interpreter's exit), stops every worker and destroys the group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import hashlib
import json
import os
import pickle
import sys
import tempfile
import threading
import time
import weakref

import torch
import torch.distributed as dist

from defslam_tpu_torch import parallel, profiling
from defslam_tpu_torch.parallel import launch

# System's public methods by what rank 0 does with them.  Sent to every
# rank, then run on rank 0:
FORWARDED = ("track_monocular", "track_monocular_gt", "track_monocular_ct", "reset", "restart",
             "apply_tuning", "activate_localization_mode", "deactivate_localization_mode",
             "flush", "load_state", "shutdown")
# run on rank 0 alone, after a flush sent to every rank (they drain the pipeline):
FLUSHED = ("write_metrics", "save_state")
# run on rank 0 alone (they only read):
LOCAL = ("get_tracking_state",)

COLLECTIVE_TIMEOUT_S = 180.0  # every collective of the world, and the workers' start
# how long a worker waits for rank 0's next call (a --step prompt may hold it)
IDLE_TIMEOUT = datetime.timedelta(days=7)
# after a collective fails (gloo raises RuntimeError when a peer is gone), how long
# to wait for a lost worker's exit code
EXIT_WAIT_S = 2.0
SHUTDOWN_WAIT_S = 30.0  # how long the workers may take to exit after a shutdown
WATCH_S = 0.1  # the watcher's period
WORKER = ("-m", "defslam_tpu_torch.parallel.worker")
# a worker's exit code after a call raised RuntimeError (a lost rank among
# its causes): a rank that exits otherwise is the one to name
CALL_FAILED = 70


def spans(cfg, device) -> int:
    """The world a ``System`` with ``cfg`` on ``device`` makes itself:
    ``launch.target_world`` with ``parallel.enabled``, in a process that
    is no rank of a world yet, when that is more than 1; else 0.  Raises
    when ``device`` names one card for such a world."""
    if not cfg.parallel.enabled or parallel.place(cfg).rendezvous or dist.is_initialized():
        return 0
    world = launch.target_world(cfg.parallel.n_devices, device)
    if world < 2:
        return 0
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        raise ValueError(f"device {dev} names one card for a world of {world} ranks: "
                         "pass 'cuda' (rank r takes cuda:r)")
    return world


def worker_config(cfg):
    """The config of a rank that neither writes nor draws: no output
    directory, no annotated frames."""
    return dataclasses.replace(cfg, output_dir="", viewer=dataclasses.replace(
        cfg.viewer, save_frames=False))


def forwarding(method):
    """``method`` of ``System`` as rank 0 of a driven world runs it: sent
    to every rank first (a :data:`FLUSHED` method sends a ``flush``), and
    a worker's exit raised as ``RuntimeError``.  Calls made inside a call
    run as they are: the workers make them too.  The sending is traced as
    ``parallel.forward``."""
    name = method.__name__
    sent = name if name in FORWARDED else "flush"

    @functools.wraps(method)
    def call(system, *args, **kwargs):
        d = system._driver
        if d is None or d.depth:
            return method(system, *args, **kwargs)
        # the span serves the frame the call tracks, else the newest frame
        frame = system.frame_id + 1 if name.startswith("track_") else system.frame_id
        with profiling.stage("parallel.forward", frame=frame):
            d.send((sent, args, kwargs) if sent == name else (sent, (), {}))
        d.depth += 1
        try:
            return method(system, *args, **kwargs)
        except Exception as e:
            d.check(e)
            raise
        finally:
            d.depth -= 1

    return call


def state_digest(system) -> str:
    """A digest of a rank's results: its metrics rows, trajectory, pose,
    template and stores, bit for bit (equal on every rank of a world in
    step)."""
    h = hashlib.sha256(json.dumps(system._metrics, sort_keys=True).encode())
    for ts, T in system.trajectory:
        h.update(repr(ts).encode())
        h.update(torch.as_tensor(T).cpu().numpy().tobytes())
    parts = [system.pose, *system.kfs, *system.points]
    if system.template is not None:
        parts += list(system.template)
    for t in parts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _env(**values):
    """``values`` in this process's environment, where not set already,
    inside the block."""
    added = {k: v for k, v in values.items() if k not in os.environ}
    os.environ.update(added)
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def _stop(ranks: launch.Ranks, watch_stop: threading.Event, nccl: bool) -> None:
    """Stop the workers, then take down this process's groups (an NCCL
    group with lost ranks is aborted: destroying it could wait for them)."""
    watch_stop.set()
    ranks.stop()
    if dist.is_initialized():
        if nccl:
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()


class Driver:
    """Rank 0 of a world that a ``System`` made (see the module's
    docstring).  ``devices``: each rank's device, as the ranks report them."""

    def __init__(self, cfg, device, world: int):
        dev = torch.device(device)
        self.world = world
        self.device = torch.device("cuda", 0) if dev.type == "cuda" else dev
        self.depth = 0  # > 0 while rank 0 runs a call
        self.closed = ""  # why the world is gone, once it is
        nccl = dev.type == "cuda"
        if nccl:  # the workers load what this builds: they must not race to build it
            from defslam_tpu_torch.ops import cuda_build

            cuda_build.build()
        fd, job = tempfile.mkstemp(prefix="defslam_job_")
        with os.fdopen(fd, "wb") as f:
            pickle.dump((worker_config(cfg), dev.type), f)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = {"PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                             if p)}
        if not nccl:  # the ranks' CPU results depend on the thread count: rank 0's
            # (which must not change while the world is up: the ranks would
            # part, and their collectives with them)
            env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
        try:
            with launch.signals_kept():
                self.ranks = launch.start([sys.executable, *WORKER, job], world,
                                          range(1, world), dev.type, env)
            self._watch_stop = threading.Event()
            self._finalizer = weakref.finalize(self, _stop, self.ranks, self._watch_stop, nccl)
            # at the interpreter's exit the threads that tail the workers'
            # logs are joined before atexit runs: stop the workers first
            threading._register_atexit(self._finalizer)
            try:
                self._join(cfg, job)
            except BaseException as e:
                lost = self._lost(wait=isinstance(e, RuntimeError))
                self._finalizer()
                if lost:
                    raise RuntimeError(f"the worker of rank {lost[0]} exited {lost[1]} "
                                       "before the world was up") from e
                raise
        finally:
            for path in [job] + [f"{job}.{r}" for r in range(1, world)]:
                if os.path.exists(path):
                    os.remove(path)
        if nccl:
            threading.Thread(target=self._watch, name="defslam-driver-watch", daemon=True).start()

    def _join(self, cfg, job: str) -> None:
        """Wait until every worker is up (each marks ``job.<rank>``; one
        that exits first raises), join the group as rank 0, make the call
        group, and gather each rank's device once its System is built."""
        deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
        while not all(os.path.exists(f"{job}.{r}") for r in range(1, self.world)):
            if self._lost():
                raise RuntimeError("a worker exited at its start")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the workers did not start within {COLLECTIVE_TIMEOUT_S} s")
            time.sleep(0.02)
        where = parallel.Place(self.ranks.rendezvous, self.world, 0, 0, self.world)
        # an NCCL error or timeout aborts rank 0's group and raises in the
        # call, rather than ending this process (the default, 3): the
        # caller's process must outlive its workers
        with _env(TORCH_NCCL_ASYNC_ERROR_HANDLING="2"):
            parallel.init_distributed(cfg, self.device, timeout=COLLECTIVE_TIMEOUT_S, where=where)
        self.calls = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        self.devices = [None] * self.world
        dist.gather_object(str(self.device), self.devices, dst=0, group=self.calls)

    def _lost(self, wait: bool = False):
        """(rank, exit code) of a worker found exited (one that did not
        exit with ``CALL_FAILED`` first), or None; with ``wait``, wait up
        to ``EXIT_WAIT_S`` for one (a collective may fail before its lost
        rank is reaped)."""
        deadline = time.monotonic() + (EXIT_WAIT_S if wait else 0.0)
        while True:
            lost = [(r, c) for r, c in self.ranks.exit_codes().items() if c is not None]
            if lost:
                return min(lost, key=lambda rc: (rc[1] == CALL_FAILED, rc[0]))
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def _watch(self) -> None:
        """On the cards: abort the NCCL group as soon as a worker exits, so
        that rank 0's collective raises rather than waits for its timeout."""
        while not self._watch_stop.wait(WATCH_S):
            if self._lost() is not None:
                if dist.is_initialized():
                    dist.group.WORLD.abort()
                return

    def _fail(self, lost):
        """Take the world down after worker ``lost`` exited; the error."""
        self.closed = f"the worker of rank {lost[0]} exited {lost[1]}"
        self._finalizer()
        return RuntimeError(self.closed + "; the world is down")

    def check(self, cause: Exception) -> None:
        """After rank 0's call raised ``cause``: raise ``RuntimeError``
        instead when a worker has exited."""
        lost = self._lost(wait=isinstance(cause, RuntimeError))
        if lost:
            raise self._fail(lost) from cause

    def send(self, call: tuple) -> None:
        """Send ``(name, args, kwargs)`` (or ``(fn, args, {})`` for
        :meth:`gather`) to every worker."""
        if self.closed:
            raise RuntimeError(f"this System's world is down: {self.closed}")
        lost = self._lost()
        if lost:
            raise self._fail(lost)
        name, args, kwargs = call
        args = tuple(a.detach().cpu().numpy() if torch.is_tensor(a) else a for a in args)
        try:
            dist.broadcast_object_list([(name, args, kwargs)], src=0, group=self.calls)
        except RuntimeError as e:
            self.check(e)
            raise

    def gather(self, system, fn, *args) -> list:
        """``fn(system, *args)`` on every rank (``fn`` a module-level
        function: it travels by name), the results by rank."""
        self.send((fn, args, {}))
        out = [None] * self.world
        try:
            dist.gather_object(fn(system, *args), out, dst=0, group=self.calls)
        except RuntimeError as e:
            self.check(e)
            raise
        return out

    @property
    def pids(self) -> dict[int, int]:
        """Each worker's process id, by rank."""
        return self.ranks.pids()

    def close(self) -> None:
        """After a ``shutdown`` that every rank ran: wait for the workers to
        exit, then stop what is left and remove the files.  Raises when a
        worker exited other than with 0."""
        deadline = time.monotonic() + SHUTDOWN_WAIT_S
        while (any(c is None for c in self.ranks.exit_codes().values())
               and time.monotonic() < deadline):
            time.sleep(0.02)
        codes = self.ranks.exit_codes()
        self.closed = "shut down"
        self._finalizer()
        bad = {r: c for r, c in codes.items() if c != 0}
        if bad:
            raise RuntimeError(f"workers did not shut down cleanly (rank: exit code) {bad}")
