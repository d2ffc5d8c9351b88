"""The program's spans in a traced benchmark run, laid over the device trace.

    python3 tools_torch_spans.py --workload stereo0_stream --seed 7 [--seconds 45]

Runs one cell of ``portbench`` with ``--trace 1`` in this process (on the
card) and writes ``chiprun_out/spans/<cell>_<seed>.json``:

- ``metrics``: the traced run's per-layer metrics, as its result line has
  them;
- ``idle_by_span``: the device's idle seconds in the profiled frames by
  the innermost span open then (``portbench/metrics/sft_idle_pct.py``'s
  ``idle_by_span``; ``null``: outside every span), and ``below_root``, the
  share of that idle time inside a span below a frame's root (any span of
  the deformable path; a child of ``rigid.frame`` in the rigid mode);
- ``after``: over the frames after the profiled ones, each span name's
  ``profiling.report()`` row, the top-level spans' host ms a frame
  (``frame.dispatch``, ``frame.finalize``, ``keyframe.dispatch*``; rigid:
  ``rigid.frame``) against the mean host ms a frame;
- ``profiled``: the same for the profiled frames from the timeline, and
  the most spans a profiled frame recorded.

The last line of standard output is the same object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOP = ("frame.dispatch", "frame.finalize", "keyframe.dispatch", "keyframe.dispatch_a",
       "keyframe.dispatch_b", "rigid.frame")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)

    from portbench import bench
    from defslam_tpu_torch import profiling

    seen = {}
    module = bench.metric_module

    def spying(name):  # each metric's reader hands its records over
        mod = module(name)
        read = mod.read

        def spy(rec):
            seen["rec"] = rec
            return read(rec)
        mod.read = spy
        return mod

    bench.metric_module = spying
    profiling.timeline(reset=True)
    out, samples = bench.run_cell(args.workload, args.seed, args.seconds, True)
    rec = seen["rec"]
    spans = profiling.timeline()
    idle_mod = module("sft_idle_pct")

    by = idle_mod.idle_by_span(rec.trace, spans)
    idle = sum(by.values())
    below = sum(v for k, v in by.items() if k is not None and k != "rigid.frame")
    n_after = len(rec.frame_s_after) + 1  # the stages also cover the last frame
    top_after = sum(rec.stages[n]["total_s"] for n in TOP if n in rec.stages) / n_after
    top_prof = sum(s.t1_ns - s.t0_ns for s in spans if s.parent is None and s.name in TOP)
    per_frame = {}
    for s in spans:
        per_frame[s.frame] = per_frame.get(s.frame, 0) + 1
    res = {
        "cell": args.workload, "seed": args.seed, "correct": out["correct"],
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "idle_by_span": {str(k): v for k, v in sorted(by.items(), key=lambda kv: -kv[1])},
        "idle_s": idle, "below_root": below / idle if idle else None,
        "after": {"frames": n_after, "stages": rec.stages,
                  "top_ms": 1e3 * top_after,
                  "frame_ms": 1e3 * statistics.fmean(rec.frame_s_after)},
        "profiled": {"frames": rec.frames, "wall_ms": 1e3 * rec.trace.wall_s / rec.frames,
                     "top_ms": 1e-6 * top_prof / rec.frames,
                     "max_spans_a_frame": max(per_frame.values(), default=0)},
        "breakdown": out.get("breakdown"), "samples": {k: samples[k] for k in (
            "window_frames", "window_s", "setup_s", "profiler_stop_s")},
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out", "spans"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "spans",
                           f"{args.workload}_{args.seed}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
