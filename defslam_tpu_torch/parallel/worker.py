"""A worker rank of a ``System`` that spans the cards (:mod:`~defslam_tpu_torch.parallel.driver`).

    python -m defslam_tpu_torch.parallel.worker JOB

The driver starts it on ranks 1..N-1 with the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``DEFSLAM_RENDEZVOUS``).  It
reads ``JOB`` (the pickled worker config and device type, written by
rank 0), marks that it is up (an empty ``JOB.<rank>``), joins the world,
builds its ``System`` on its own card (``cuda:<rank>``, or the CPU), tells
rank 0 which device that is, and then runs each call rank 0 sends, in
order, until ``shutdown``.  Its ``System`` joins the world the launcher's
environment names, so it never starts workers of its own.

An exception in a call is printed (under the rank's ``[rank r]`` prefix).
The worker goes on after one that rank 0 meets too, running the same call
on the same inputs (a bad key for ``apply_tuning``, a missing checkpoint);
it ends, with ``driver.CALL_FAILED``, after a ``RuntimeError``: torch's
errors, among them a collective that lost a rank, after which the ranks
are out of step.  Its exit lets rank 0's pending collective fail at once.
A failure of the call channel itself (rank 0 gone) ends it too.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import torch.distributed as dist

from defslam_tpu_torch import parallel
from defslam_tpu_torch.parallel import driver


def main(job: str) -> int:
    from defslam_tpu_torch.system import System

    with open(job, "rb") as f:
        cfg, device = pickle.load(f)
    open(f"{job}.{os.environ['RANK']}", "w").close()
    parallel.init_distributed(cfg, device, timeout=driver.COLLECTIVE_TIMEOUT_S)
    calls = dist.new_group(backend="gloo", timeout=driver.IDLE_TIMEOUT)
    system = System(cfg, device=device)
    dist.gather_object(str(system.device), None, dst=0, group=calls)
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=calls)
        what, args, kwargs = box[0]
        out = None
        try:
            out = what(system, *args) if callable(what) else getattr(system, what)(*args, **kwargs)
        except Exception as e:
            print(f"the call {what} raised:", file=sys.stderr)
            traceback.print_exc()
            if isinstance(e, RuntimeError):  # torch's errors: a lost rank among them
                return driver.CALL_FAILED
        if callable(what):  # a gather (driver.Driver.gather)
            dist.gather_object(out, None, dst=0, group=calls)
        elif what == "shutdown":
            return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
