"""One launch, N ranks: the port's stand-in for the JAX package's one
process over every device.

    python -m defslam_tpu_torch.parallel.launch --world 4 [--device cuda|cpu] \
        [--timeout SECONDS] -- python my_program.py ...

A JAX process drives every device of its mesh; a PyTorch process drives
one.  :func:`launch` starts the command once per rank through torchrun's
process layer (``torch.distributed.elastic.multiprocessing``), each rank
with torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), the host's cores shared out among them
(``OMP_NUM_THREADS``, unless set) and a ``file://`` rendezvous in a
temporary directory (``DEFSLAM_RENDEZVOUS``), which ``parallel.place``
reads: a ``System`` with ``parallel.enabled`` and no ``coordinator`` in
such a process joins the world, rank r on ``cuda:r``
(``parallel.rank_device``) over NCCL, or on the CPU over gloo.
:func:`start` is that process layer without the wait: ``parallel.driver``
starts a System's worker ranks with it, the caller's process being rank 0.

That layer supervises the ranks: each rank's output is passed through,
every line prefixed by ``[rank r]`` (it tails the rank's log file, so a
line the rank writes in pieces, as under ``PYTHONUNBUFFERED``, may be cut
by a prefix); a rank that exits non-zero or dies
stops the others (SIGTERM to its session, SIGKILL after a grace period),
and the launch returns its exit code.  What this module adds to it is
what torchrun lacks: a timeout (past ``timeout`` seconds every rank is
stopped and the launch returns 124), a rendezvous on a file rather than
a TCP store found through the host's name, and a sweep of each rank's
session at the end, so that no process a rank started outlives the
launch.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import torch

from defslam_tpu_torch.parallel import ENV_RENDEZVOUS, check_cards

TIMED_OUT = 124  # the exit code of a launch past its timeout, as timeout(1)'s
GRACE_S = 5  # SIGTERM, then SIGKILL after this long
# the signals the process layer takes over while the ranks run
_HANDLED = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP, signal.SIGQUIT)


def target_world(n_devices: int, device) -> int:
    """The world that ``parallel.n_devices`` asks for on ``device``: 0 means
    every visible card on CUDA, and 1 on the CPU (the JAX meaning: every
    device of the platform)."""
    if n_devices:
        return n_devices
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def _sweep(sessions) -> None:
    """SIGKILL to every process left in the ranks' sessions, and wait (at
    most ``GRACE_S``) until none is left."""
    live = set(sessions)
    deadline = time.monotonic() + GRACE_S
    while live and time.monotonic() < deadline:
        for pid in list(live):
            try:
                os.killpg(pid, signal.SIGKILL)
            except ProcessLookupError:
                live.discard(pid)
        time.sleep(0.02)


class Ranks:
    """Ranks started by :func:`start`, each in a session of its own: their
    process context (torchrun's), the temporary directory that holds
    their rendezvous and logs, and the rendezvous URL."""

    def __init__(self, ctx, ranks: list[int], tmp: str, rendezvous: str):
        self.ctx = ctx
        self.ranks = ranks
        self.tmp = tmp
        self.rendezvous = rendezvous

    def pids(self) -> dict[int, int]:
        """Each rank's process id, by rank."""
        pids = self.ctx.pids()
        return {r: pids[i] for i, r in enumerate(self.ranks)}

    def exit_codes(self) -> dict[int, int | None]:
        """Each rank's exit code (-N for a rank killed by signal N), or None
        while it runs, by rank."""
        handlers = self.ctx.subprocess_handlers
        return {r: handlers[i].proc.poll() for i, r in enumerate(self.ranks)}

    def stop(self) -> None:
        """Stop every rank (SIGTERM to its session, SIGKILL after
        ``GRACE_S``), then sweep the sessions (a rank's children outlive it
        when the rank exits on its own) and remove the directory."""
        self.ctx.close(timeout=GRACE_S)
        _sweep(self.ctx.pids().values())
        shutil.rmtree(self.tmp, ignore_errors=True)


def start(cmd: list[str], world: int, ranks, device="cuda", env: dict | None = None) -> Ranks:
    """Start ``cmd`` once for each rank in ``ranks`` of a world of ``world``
    ranks on this host (see the module's docstring), and return at once;
    :meth:`Ranks.stop` ends them.  ``env`` adds to the ranks' environment.
    Raises before starting anything when a CUDA world asks for more ranks
    than there are cards.  Call it inside :func:`signals_kept` where the
    caller does not want torchrun's signal handlers to outlive the call:
    starting the ranks installs them."""
    from torch.distributed.elastic.multiprocessing import DefaultLogsSpecs, Std, start_processes

    if torch.device(device).type == "cuda":
        check_cards(world, torch.cuda.device_count())
    ranks = list(ranks)
    base = dict(env or {})
    if "OMP_NUM_THREADS" not in os.environ:
        base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    tmp = tempfile.mkdtemp(prefix="defslam_launch_")
    rendezvous = "file://" + os.path.join(tmp, "rendezvous")
    base.update({ENV_RENDEZVOUS: rendezvous, "WORLD_SIZE": str(world),
                 "LOCAL_WORLD_SIZE": str(world)})
    try:
        ctx = start_processes(
            name="rank", entrypoint=cmd[0], args={i: tuple(cmd[1:]) for i in range(len(ranks))},
            envs={i: dict(base, RANK=str(r), LOCAL_RANK=str(r)) for i, r in enumerate(ranks)},
            logs_specs=DefaultLogsSpecs(log_dir=os.path.join(tmp, "logs"), tee=Std.ALL),
            log_line_prefixes={i: f"[rank {r}] " for i, r in enumerate(ranks)})
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return Ranks(ctx, ranks, tmp, rendezvous)


@contextlib.contextmanager
def signals_kept():
    """Put back, on the way out, the handlers of the signals that starting
    the ranks takes over (in the main thread only, where it takes them)."""
    main = threading.current_thread() is threading.main_thread()
    handlers = {s: signal.getsignal(s) for s in _HANDLED} if main else {}
    try:
        yield
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def launch(cmd: list[str], world: int, device="cuda", timeout: float | None = None,
           env: dict | None = None) -> int:
    """Run ``cmd`` once per rank of a world of ``world`` (see the module's
    docstring) and supervise the ranks.  Returns 0 when every rank exits
    0, else the first failing rank's exit code (128 + the signal for a
    rank killed by one), or 124 past ``timeout`` seconds.  ``env`` adds to
    the ranks' environment.  Raises before starting anything when a CUDA
    launch asks for more ranks than there are cards; a signal to the
    launch stops every rank and exits with 128 + the signal."""
    from torch.distributed.elastic.multiprocessing.api import SignalException

    ranks = None
    with signals_kept():
        try:
            ranks = start(cmd, world, range(world), device, env)
            result = ranks.ctx.wait(-1 if timeout is None else timeout, period=0.05)
            if result is None:
                return TIMED_OUT
            if not result.is_failed():
                return 0
            first = min(result.failures.values(), key=lambda f: f.timestamp).exitcode
            return first if first > 0 else 128 - first
        except SignalException as e:
            raise SystemExit(128 + e.sigval) from None
        finally:
            if ranks is not None:
                ranks.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m defslam_tpu_torch.parallel.launch",
                                 description="run a command once per rank of a world")
    ap.add_argument("--world", type=int, required=True, help="the number of ranks")
    ap.add_argument("--device", default="cuda", help="cuda (a card per rank) or cpu")
    ap.add_argument("--timeout", type=float, default=None, help="seconds, then stop every rank")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- the command and its arguments")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command")
    return launch(cmd, args.world, args.device, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
