"""Readings that the limits of ``correct`` are set from: sound runs of the
program over many seeds (the lower readings) and runs of the control, the
program with TF32 allowed (the upper readings), in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <a,b,...> [--control-seeds <c,d,...>] [--out <file.jsonl>]

Prints one JSON line per run (the compared numbers, ``attempted`` and
``failed``), then the largest sound reading and the smallest control
reading of each number.  The benchmark's own runs never run the control.
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


def readings(cell: str, seeds, seconds: float, control: str | None, out, **kw) -> list[dict]:
    from portbench import bench

    rows = []
    for seed in seeds:
        r, samples = bench.run_cell(cell, seed, seconds, False, control=control, **kw)
        row = {"cell": cell, "seed": seed, "control": control, "correct": r["correct"],
               "attempted": r["attempted"], "failed": r["failed"],
               "checked": samples["checked"],
               "values": {k: v["value"] for k, v in r["compared"].items()},
               "detail": samples["detail"],
               "frames_per_s": r["metrics"]["frames_per_s"]["value"],
               "window_s": samples["window_s"]}
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
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") if args.out else open(os.devnull, "w") as out:
        sound = readings(args.workload, seeds, args.seconds, None, out)
        ctrl = readings(args.workload, cseeds, args.seconds, "tf32", out)
    print(json.dumps({"summary": summary(sound, ctrl)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
