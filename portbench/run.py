"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Needs as many CUDA devices as the cell
asks for: without them it prints no result and exits with 2.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``compared``, each number compared with its limit.  Standard
error ends with the run's sample counts and the same numbers.  Exits with
3, printing no result, if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


# the process's start on the perf_counter clock: set-up counts from it
START = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import bench

    entry = bench.cell_entry(bench.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, samples = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                         setup_start=START)
    found = bench.forbidden_modules()
    if found:
        print("portbench: modules of JAX or the JAX package were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(f"samples: {samples}", file=sys.stderr)
    for line in bench.compared_lines(out["compared"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
