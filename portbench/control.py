"""Readings that the limits of ``correct`` are set from: sound runs of the
program over many seeds (the lower readings) and runs of the control, the
program with TF32 allowed (the upper readings), in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <a,b,...> [--control-seeds <c,d,...>] [--out <file.jsonl>] \\
        [--overrides '{"parallel": {"enabled": true, "n_devices": 4}}']

Prints one JSON line per run (the compared numbers, ``attempted`` and
``failed``, the end-to-end metrics, the memory peak, the seconds of
judging), then the largest sound reading and the smallest control
reading of each number.  ``--overrides`` merges configuration values into
the cell's configuration, section by section: the readings of a
configuration before its cell exists.  The first run's ``setup_s`` counts
from the process's start, as a run of ``run.py`` does.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.run import START  # noqa: E402  (this process's start)


def readings(cell: str, seeds, seconds: float, control: str | None, out, start=None,
             **kw) -> list[dict]:
    """One run a seed; the first run's set-up counts from ``start``."""
    from portbench import bench

    rows = []
    for seed in seeds:
        r, samples = bench.run_cell(cell, seed, seconds, False, control=control,
                                    setup_start=start, **kw)
        start = None
        row = {"cell": cell, "seed": seed, "control": control, "correct": r["correct"],
               "attempted": r["attempted"], "failed": r["failed"],
               "checked": samples["checked"],
               "values": {k: v["value"] for k, v in r["compared"].items()},
               "detail": samples["detail"],
               **{k: v["value"] for k, v in r["metrics"].items()},
               "memory_peak_bytes": r["device"]["memory_peak_bytes"],
               "window_s": samples["window_s"], "judge_s": samples["judge_s"],
               "workers_left": samples["workers_left"]}
        line = bench.result_line(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        rows.append(row)
    return rows


def summary(sound: list[dict], control: list[dict]) -> dict:
    names = sound[0]["values"] if sound else control[0]["values"]
    out = {}
    for n in names:
        lo = [r["values"][n] for r in sound if r["values"][n] is not None]
        up = [r["values"][n] for r in control if r["values"][n] is not None]
        out[n] = {"lower": max(lo) if lo else None, "upper": min(up) if up else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    kw = {"config_overrides": json.loads(args.overrides)}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") if args.out else open(os.devnull, "w") as out:
        sound = readings(args.workload, seeds, args.seconds, None, out, START, **kw)
        ctrl = readings(args.workload, cseeds, args.seconds, "tf32", out,
                        None if seeds else START, **kw)
    print(json.dumps({"summary": summary(sound, ctrl)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
