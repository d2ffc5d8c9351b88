"""The benchmark's harness: one cell of ``BENCHMARK.json`` run end to end.

A cell names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and the chips it takes; the per-layer metrics
it reports are the ``per_layer`` entries that list it, each read by
``metrics/<name>.py``.  Nothing here lists them: a new configuration, mix
or metric is a new file and a new entry.

A run (:func:`run_cell`):

1. renders the mix's frames on the device from the seed (``render.py``);
2. builds the configuration's system (``defslam_tpu_torch.system.System``,
   or ``rigid.system.RigidSystem``);
3. warms up on the cell's own stream: ``warmup_frames`` frames (the first
   keyframe among them), a flush, and for a localization mix
   ``activate_localization_mode``; the rigid mode goes on until its
   two-view initialization holds and a keyframe followed it;
4. measures for ``seconds``: a closed loop with one camera, the next frame
   fed when ``track_monocular`` returns, and a flush at the end that the
   last call's time carries;
5. with ``trace``, profiles the window's first ``trace_frames`` frames
   (the device's activities and the CUDA runtime's calls), runs at least
   as many more, and times the metrics' spans; the profiler's stop is
   left out of the traced span and added to the window's length;
6. takes down the world of a System that spans several ranks
   (``parallel.enabled``): its workers exit and free their cards;
7. compares samples of the window's layer steps with the reference
   (``reference/``: in float32 where the comparison is exact, in float64
   for the solvers) and the whole trajectory with the render's ground
   truth, once the program's state is freed, each number against its
   limit (``limits/<cell>.json`` and the configuration's ``guarantees``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "defslam_tpu")


# ------------------------------------------------------------- the cells


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_data(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def metric_module(name: str):
    """``portbench/metrics/<name>.py``: ``LAYER``, ``UNIT``, ``MOVES``, an
    optional ``SPANS`` list of (label, module, attribute path) to time with
    CUDA events in the traced window, an optional ``replay(ctx)`` run on
    the final state, and ``read(rec)``: the metric, or None where the run
    gave it nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metric entries: its end-to-end metrics (``trace`` off) or
    its per-layer ones (``trace`` on)."""
    key = "per_layer" if trace else "end_to_end"
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is None:
            if trace:  # a per-layer metric without cells: every cell of its end-to-end one
                e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
                cells = e2e.get("workloads")
            if cells is None:
                out.append(m)
                continue
        if cell in cells:
            out.append(m)
    return out


def config_values(cfg_file: dict, overrides: dict | None = None) -> dict:
    """The nested configuration values of a configuration file, with
    ``overrides`` merged into it section by section."""
    vals = json.loads(json.dumps(cfg_file["config"]))
    for sec, v in (overrides or {}).items():
        if isinstance(v, dict):
            vals.setdefault(sec, {}).update(v)
        else:
            vals[sec] = v
    return vals


def resolve(module: str, path: str):
    """(owner, attribute name) of ``module``'s attribute ``path``
    (``Class.method`` or ``function``)."""
    owner = importlib.import_module(module)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


# ---------------------------------------------------------- the hooks


class Hooks:
    """Attributes replaced by wrappers until :meth:`restore`."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def restore(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    ``rng`` (reservoir sampling): :meth:`slot` says, before an item is
    made, where it goes (None: not kept)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def slot(self) -> int | None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def _clone(obj):
    if torch.is_tensor(obj):
        return obj.clone()
    return type(obj)(*(_clone(v) for v in obj))


class Capture(Hooks):
    """The timed path's layer steps, kept for the comparison with the
    reference: a sample of the window's calls (drawn from the seed) with
    their inputs and outputs.  Only references are kept, except where
    the program writes a tensor in place afterwards (the keyframe store,
    the rigid stores), which is cloned for the calls that are kept.

    A deformable System that spans a world of N ranks (``System.group``)
    tracks a frame through ``tracker.track_frame_parallel`` (the sharded
    SfT) and inserts a keyframe through ``System._insert_keyframe_legacy``
    (the host-orchestrated chain): those are wrapped instead, in this
    process, which is rank 0; the workers run the same frames in their
    own processes and are not captured."""

    def __init__(self, prog, kind: str, mix: dict, seed: int):
        super().__init__()
        self.prog = prog
        self.kind = kind
        rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 7])
        k, kk = int(mix["check_frames"]), int(mix["check_keyframes"])
        self.frames = Reservoir(k, rng)
        self.keyframes = Reservoir(kk, rng)
        self.extracts = Reservoir(k, rng)
        self.matches = Reservoir(k, rng)
        self.poses = Reservoir(k, rng)
        self.bas = Reservoir(kk, rng)
        self.init = None
        self.active = False  # sampling on: the measured window
        self.system = None
        self.world = 1  # the ranks of the System's group
        self._waiting = None  # the kept frame whose successor's inputs are due

    def install(self, system) -> None:
        self.system = system
        p = self.prog
        if self.kind == "rigid":
            self.wrap(p.rigid_system, "extract_features", self._extract)
            self.wrap(p.rigid_system, "match_points_rigid", self._match_rigid)
            self.wrap(p.RigidSystem, "_pose_solve", self._pose_solve)
            self.wrap(p.RigidSystem, "_local_ba", self._local_ba)
            return
        if system.group is None:
            self.wrap(p.tracker, "track_frame", self._frame)
            self.wrap(p.mapper, "keyframe_step", self._keyframe)
        else:
            self.world = system.group.size
            self.wrap(p.tracker, "track_frame_parallel", self._frame_parallel)
            self.wrap(system, "_insert_keyframe_legacy", self._keyframe_legacy)
        self.wrap(system, "_initialize", self._initialize)

    # the deformable system

    def _initialize(self, orig):
        def call(feats, timestamp):
            ok = orig(feats, timestamp)
            if ok and self.init is None:
                s = self.system
                self.init = {"feats": feats, "points": s.points, "nodes": s.template.nodes}
            return ok
        return call

    def _frame(self, orig):
        def call(img, points, pose, prev_pose, tmpl, K, cfg, window_scale: float = 1.0):
            return self._track(lambda: orig(img, points, pose, prev_pose, tmpl, K, cfg,
                                            window_scale=window_scale),
                               img, points, pose, prev_pose, tmpl, window_scale)
        return call

    def _frame_parallel(self, orig):
        def call(group, img, points, pose, prev_pose, tmpl, K, cfg, window_scale: float = 1.0):
            return self._track(lambda: orig(group, img, points, pose, prev_pose, tmpl, K, cfg,
                                            window_scale=window_scale),
                               img, points, pose, prev_pose, tmpl, window_scale)
        return call

    def _track(self, run, img, points, pose, prev_pose, tmpl, window_scale):
        """One frame tracked by ``run()``: the inputs handed on to the kept
        frame before it (its ``next``), and this frame kept if sampled."""
        s = self.system
        if self._waiting is not None:
            self._waiting["next"] = {"points": points, "pose": pose, "prev_pose": prev_pose,
                                     "tmpl": tmpl, "frame": s.frame_id,
                                     "rollbacks": s.n_rollbacks}
            self._waiting = None
        out = run()
        j = self.frames.slot() if self.active else None
        if j is not None:
            item = {"img": img, "points": points, "pose": pose, "prev_pose": prev_pose,
                    "tmpl": tmpl, "window_scale": window_scale, "out": out,
                    "frame": s.frame_id, "rollbacks": s.n_rollbacks,
                    "keyframe": s.frames_since_kf + 1 >= s.cfg.tracking.keyframe_period
                    and not s._localization_only}
            self.frames.items[j] = item
            self._waiting = item
        return out

    def _keyframe(self, orig):
        def call(kfs, points, tmpl, pose, feats, kp_of_point, inlier, K, dom, bend_warp,
                 bend_sfn, tmpl_ref_kf, kf_counter, frame_id, cfg, mark=None):
            j = self.keyframes.slot() if self.active else None
            before = _clone(kfs) if j is not None else None
            out = orig(kfs, points, tmpl, pose, feats, kp_of_point, inlier, K, dom, bend_warp,
                       bend_sfn, tmpl_ref_kf, kf_counter, frame_id, cfg, mark=mark)
            if j is not None:
                self.keyframes.items[j] = {
                    "kfs": before, "points": points, "tmpl": tmpl, "pose": pose,
                    "feats": feats, "kp_of_point": kp_of_point, "inlier": inlier,
                    "tmpl_ref_kf": tmpl_ref_kf, "kf_counter": kf_counter,
                    "frame_id": frame_id, "out": (_clone(out[0]),) + tuple(out[1:])}
            return out
        return call

    def _keyframe_legacy(self, orig):
        def call(feats, matches, res):
            s = self.system
            j = self.keyframes.slot() if self.active else None
            if j is None:
                return orig(feats, matches, res)
            item = {"legacy": True, "kfs": _clone(s.kfs), "points": s.points, "tmpl": s.template,
                    "pose": s.pose, "feats": feats, "kp_of_point": matches.kp_of_point,
                    "inlier": res.inlier, "tmpl_ref_kf": s.template_ref_kf,
                    "kf_counter": s.kf_counter, "frame_id": s.frame_id}
            updated = orig(feats, matches, res)
            item["out"] = (_clone(s.kfs), s.points, s.template, s.template_ref_kf, s.kf_counter,
                           updated)
            self.keyframes.items[j] = item
            return updated
        return call

    # the rigid system

    def _extract(self, orig):
        def call(img, cfg):
            feats = orig(img, cfg)
            j = self.extracts.slot() if self.active else None
            if j is not None:
                self.extracts.items[j] = {"img": img, "feats": feats}
            return feats
        return call

    def _match_rigid(self, orig):
        def call(points, pose, K, feats, cfg, window: float = 15.0):
            out = orig(points, pose, K, feats, cfg, window=window)
            j = self.matches.slot() if self.active else None
            if j is not None:
                self.matches.items[j] = {"points": _clone(points), "pose": pose,
                                         "feats": feats, "window": window, "out": out}
            return out
        return call

    def _pose_solve(self, orig):
        def call(system, T0, idx, feats):
            out = orig(system, T0, idx, feats)
            j = self.poses.slot() if self.active else None
            if j is not None:
                self.poses.items[j] = {"T0": T0, "idx": idx, "feats": feats,
                                       "points": _clone(system.points), "out": out}
            return out
        return call

    def _local_ba(self, orig):
        def call(system):
            j = self.bas.slot() if self.active else None
            before = (_clone(system.kfs), _clone(system.points)) if j is not None else None
            orig(system)
            if j is not None:
                self.bas.items[j] = {"kfs": before[0], "points": before[1],
                                     "poses": system.kfs.pose.clone(),
                                     "point_id": system.kfs.point_id.clone(),
                                     "xyz": system.points.xyz.clone()}
        return call


# ------------------------------------------------------------ the trace


class Spans(Hooks):
    """CUDA events around every call of the wrapped functions while
    :attr:`on`; milliseconds per call by label."""

    def __init__(self):
        super().__init__()
        self.calls: dict[str, list] = {}
        self.on = False

    def add(self, label: str, owner, name: str) -> None:
        def make(orig):
            def timed(*a, **k):
                if not self.on:
                    return orig(*a, **k)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(*a, **k)
                end.record()
                self.calls.setdefault(label, []).append((start, end))
                return out
            return timed
        self.wrap(owner, name, make)

    def ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.calls.items()}


class KeyframeMarks:
    """The ``mark`` callback of ``keyframe_step`` (``System._kf_mark``): a
    CUDA event at every stage boundary."""

    def __init__(self):
        self.marks: list[tuple[str, object]] = []

    def __call__(self, name: str, **tensors):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def steps_ms(self) -> list[dict]:
        """Per keyframe step: each stage's milliseconds and their sum
        ``keyframe_ms``."""
        torch.cuda.synchronize()
        steps, prev = [], None
        for name, ev in self.marks:
            if name == "start":
                steps.append({})
            elif steps:
                steps[-1][name + "_ms"] = prev.elapsed_time(ev)
            prev = ev
        for st in steps:
            st["keyframe_ms"] = sum(st.values())
        return steps


class KernelShapes(Hooks):
    """The shapes of the hand-written kernels' launches while :attr:`on`:
    B1's (n, m), and B2's inputs, whose admitted pairs the bound counts."""

    def __init__(self, prog):
        super().__init__()
        self.on = False
        self.b1: list[tuple[int, int]] = []
        self.b2: list[tuple] = []
        for mod in (prog.matching, prog.pose_opt, prog.loop_closing):
            self.wrap(mod, "hamming_matrix", self._b1)
        self.wrap(prog.mapper, "windowed_match", self._b2)

    def _b1(self, orig):
        def call(a, b, out=None):
            if self.on:
                self.b1.append((a.shape[0], b.shape[0]))
            return orig(a, b, out=out)
        return call

    def _b2(self, orig):
        def call(da, db, xa, xb, va, vb, radius, invalid, out=None):
            if self.on:
                self.b2.append((xa, xb, va, vb, float(radius)))
            return orig(da, db, xa, xb, va, vb, radius, invalid, out=out)
        return call

    def b2_launches(self) -> list[dict]:
        out = []
        for xa, xb, va, vb, radius in self.b2:
            win = (xa[:, :, None, :] - xb[:, None, :, :]).abs().amax(dim=-1) <= radius
            admitted = int((win & va[:, :, None] & vb[:, None, :]).sum())
            out.append({"b": xa.shape[0], "n": xa.shape[1], "m": xb.shape[1],
                        "admitted": admitted})
        return out


@dataclass
class Records:
    """What the traced run gives the per-layer metrics' readers."""

    cell: str
    frames: int = 0  # frames fed in the profiled part of the window
    frame_s_after: list = field(default_factory=list)  # host s of each later frame
    trace: object = None  # trace.Trace of the profiled part
    spans: dict = field(default_factory=dict)  # label -> ms per call
    stages: dict = field(default_factory=dict)  # profiling.report() after the profiled part
    keyframe_steps: list = field(default_factory=list)  # KeyframeMarks.steps_ms()
    b1_shapes: list = field(default_factory=list)
    b2_launches: list = field(default_factory=list)
    replays: dict = field(default_factory=dict)  # from the metrics' replay()
    rates: dict = field(default_factory=dict)  # rooflines.card_rates()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between two CUDA events over ``reps``
    runs, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------- the program


class Program:
    """The modules of the port that the harness drives or wraps."""

    def __init__(self):
        from defslam_tpu_torch import config, frontend, profiling
        from defslam_tpu_torch.mapping import mapper
        from defslam_tpu_torch.ops import matching
        from defslam_tpu_torch.rigid import loop_closing
        from defslam_tpu_torch.rigid import system as rigid_system
        from defslam_tpu_torch.system import System
        from defslam_tpu_torch.tracking import pose_opt, tracker

        self.config, self.frontend, self.profiling = config, frontend, profiling
        self.mapper, self.matching, self.loop_closing = mapper, matching, loop_closing
        self.rigid_system, self.RigidSystem = rigid_system, rigid_system.RigidSystem
        self.System = System
        self.pose_opt, self.tracker = pose_opt, tracker


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# ------------------------------------------------------------- the run


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device=None,
             config_overrides: dict | None = None, mix_overrides: dict | None = None,
             control: str | None = None, setup_start: float | None = None):
    """Run one cell; returns (the result line's object, with the compared
    numbers last under ``compared``; the run's sample counts).  ``device``
    None is the card (``cuda:0``); tests pass ``"cpu"`` and small
    ``config_overrides`` / ``mix_overrides``.  ``control="tf32"`` runs
    the program with TF32 allowed (the control of the comparison); the
    reference always runs with it off."""
    from portbench import render
    from portbench import trace as tracemod
    from portbench.reference import compare, layers

    if trace and device is not None and torch.device(device).type != "cuda":
        raise ValueError("a traced run times with CUDA events: it needs the card")
    t_setup0 = time.perf_counter() if setup_start is None else setup_start
    bench = load_benchmark()
    entry = cell_entry(bench, cell)
    cfg_file = load_data("configs", entry["config"])
    mix = dict(load_data("traffic", entry["traffic"]), **(mix_overrides or {}))
    values = config_values(cfg_file, config_overrides)
    kind = cfg_file["system"]
    cuda = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if device is None else torch.device(device)

    prog = Program()
    set_tf32(control == "tf32")
    config_class = prog.config.Config
    if control == "tf32" and values.get("parallel", {}).get("enabled"):
        # the workers of a world allow TF32 too (tf32_world.py)
        from portbench.tf32_world import TF32Config as config_class
    cfg = layers.build(config_class, values)
    cam = render.camera(cfg.camera.width, cfg.camera.height)
    if any(abs(getattr(cfg.camera, k) - cam[k]) > 1e-6 for k in ("fx", "fy", "cx", "cy")):
        raise ValueError(f"{entry['config']}: the camera is not the render's {cam}")
    scene = render.Scene(dict(mix, width=cfg.camera.width, height=cfg.camera.height), seed, dev)
    stream = render.Stream(scene)

    if kind == "rigid":
        system = prog.RigidSystem(cfg, device=dev)
    else:
        system = prog.System(cfg, device=None if device is None else dev)
    capture = Capture(prog, kind, mix, seed)
    capture.install(system)
    metric_entries = cell_metrics(bench, cell, trace)
    metric_mods = {m["name"]: metric_module(m["name"]) for m in metric_entries} if trace else {}
    spans = Spans()
    shapes = KernelShapes(prog) if trace else None
    marks = KeyframeMarks() if trace and kind != "rigid" else None
    rec = Records(cell=cell)
    try:
        for mod in metric_mods.values():
            for label, module, path in getattr(mod, "SPANS", ()):
                spans.add(label, *resolve(module, path))
        results = []  # per stream position: the returned pose or None
        warm = int(mix["warmup_frames"])
        for k in range(warm):
            results.append(system.track_monocular(stream.frame(k), float(k)))
        if kind == "rigid":
            # the two-view initialization waits for parallax: keep warming up
            # until it holds and a keyframe has been inserted after it
            k = warm
            while (system.state.name != "OK" or system._n_kf_inserted < 3) and k < stream.scene.n:
                results.append(system.track_monocular(stream.frame(k), float(k)))
                k += 1
            warm = k
        else:
            system.flush()
            if mix.get("localize"):
                system.activate_localization_mode()
        if cuda:
            torch.cuda.synchronize()
        if marks is not None:
            system._kf_mark = marks

        # ---- the measured window
        capture.active = True
        frame_s = []
        n_prof = int(mix["trace_frames"]) if trace else 0
        prof = None
        setup_s = time.perf_counter() - t_setup0
        t0 = time.perf_counter()
        if trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            shapes.on = spans.on = True
            t_prof = time.perf_counter()
        k = warm
        stop_s = 0.0  # the profiler's stop and the trace's reduction
        while True:
            ts = time.perf_counter()
            results.append(system.track_monocular(stream.frame(k), float(k)))
            k += 1
            if prof is not None and k - warm == n_prof:
                torch.cuda.synchronize()
                t_stop = time.perf_counter()
                prof.__exit__(None, None, None)
                rec.trace = tracemod.from_profiler(prof, t_stop - t_prof)
                rec.frames = n_prof
                prof = None
                shapes.on = False
                prog.profiling.report(reset=True)
                prog.profiling.enable(True)
                stop_s = time.perf_counter() - t_stop
            done = time.perf_counter()
            frame_s.append(done - ts)
            # the stop parses every event of the profiled frames on the
            # host: the window runs that much longer, so a traced run feeds
            # about as many frames as an untraced one
            if done - t0 - stop_s >= seconds and k - warm >= 2 * n_prof:
                break
        ts = time.perf_counter()
        if kind != "rigid":
            system.flush()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame_s[-1] += t1 - ts
        capture.active = False
        spans.on = False
        window_s = t1 - t0
        n_window = k - warm

        # ---- what the window did
        if kind == "rigid":
            failed = sum(r is None for r in results[warm:])
            trajectory = list(system.trajectory)
        else:
            rows = [r for r in system._metrics if r["frame"] >= warm]
            failed = sum(r["state"] != "OK" for r in rows)
            trajectory = list(system.trajectory)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        metrics = {}
        if not trace:
            done_frames = n_window - failed
            values_e2e = {"frames_per_s": done_frames / window_s,
                          "frame_ms_p95": float(np.percentile(np.asarray(frame_s) * 1e3, 95)),
                          "setup_s": setup_s}
            for m in metric_entries:
                metrics[m["name"]] = {"value": values_e2e[m["name"]], "unit": m["unit"]}
        else:
            rec.frame_s_after = frame_s[n_prof:-1]
            rec.spans = spans.ms()
            rec.stages = prog.profiling.report(reset=True)
            prog.profiling.enable(False)
            if marks is not None:
                rec.keyframe_steps = marks.steps_ms()
                system._kf_mark = None
            rec.b1_shapes = shapes.b1
            rec.b2_launches = shapes.b2_launches()
            from portbench import rooflines

            rec.rates = rooflines.card_rates()
            ctx = {"system": system, "img": stream.frame(k - 1), "prog": prog,
                   "cfg": cfg, "cuda_ms": cuda_ms}
            for mod in metric_mods.values():
                if hasattr(mod, "replay"):
                    rec.replays.update(mod.replay(ctx))
            del ctx
            for m in metric_entries:
                v = metric_mods[m["name"]].read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        busy = rec.trace is not None and tracemod.busy_s(rec.trace)
        breakdown = None
        if rec.trace is not None:
            breakdown = {"device_ops": tracemod.top_device_ops(rec.trace),
                         "idle_gaps": tracemod.idle_gaps(rec.trace)}
    finally:
        spans.restore()
        if shapes is not None:
            shapes.restore()
        capture.restore()
        capture.system = None
        workers_left = close_world(system)

    # ---- the comparison, with the program's state freed
    t_judge = time.perf_counter()
    gt_poses = stream.poses
    del system
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    set_tf32(False)
    exact = layers.Reference(values, dev)
    judge = layers.Reference(values, dev, torch.float64)
    with torch.no_grad():
        compared, detail = compare_all(capture, exact, judge, compare, kind)
    est = np.stack([np.asarray(T) for _, T in trajectory])
    idx = [stream.index(int(round(ts))) for ts, _ in trajectory]
    detail["rot_ate"] = compare.rot_ate(est, gt_poses[idx])
    guarantees = dict(cfg_file.get("guarantees", {}))
    if mix.get("compare_ate", True):
        compared["ate"] = compare.ate_rmse(est, gt_poses[idx])
    else:  # camera centres that do not move: the Sim(3) alignment is degenerate
        detail["ate"] = compare.ate_rmse(est, gt_poses[idx])
        guarantees.pop("ate", None)

    limits = dict(guarantees, **load_data("limits", cell))
    numbers = {}
    for name, limit in limits.items():
        v = compared.get(name)
        numbers[name] = {"value": v, "limit": limit}
    correct = all(n["value"] is not None and n["value"] <= n["limit"] for n in numbers.values())
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(entry["chips"]) if cuda else 1,
               "memory_peak_bytes": int(peak)}
    if trace and rec.trace is not None:
        devinfo["busy_s"] = busy
        devinfo["window_s"] = rec.trace.wall_s
    out = {"correct": bool(correct), "attempted": n_window, "failed": int(failed),
           "metrics": metrics, "device": devinfo}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = numbers
    samples = {"window_frames": n_window, "frame_times": len(frame_s), "window_s": window_s,
               "setup_s": setup_s, "profiler_stop_s": stop_s,
               "judge_s": time.perf_counter() - t_judge, "workers_left": workers_left,
               "checked": {k: v for k, v in compared.items() if k.endswith("_n")},
               "detail": detail}
    return out, samples


def close_world(system) -> list[int]:
    """Take down the world of ranks that ``system`` made, if it made one:
    its own ``shutdown`` (every worker runs it and exits), then, whatever
    came of that, ``Driver``'s stop of any worker still running (a no-op
    after a clean shutdown).  Returns the process ids of the workers
    still alive afterwards: none, unless a worker could not be stopped."""
    d = getattr(system, "_driver", None)
    if d is None:
        return []
    pids = list(d.pids.values())
    try:
        if not d.closed:
            system.shutdown()
    finally:
        d._finalizer()
    return [pid for pid in pids if _alive(pid)]


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def compare_all(capture: Capture, exact, judge, compare, kind: str) -> tuple[dict, dict]:
    """The compared numbers, each over its sampled calls, with the number
    of calls compared (``<name>_n``); and every part of the solvers'
    comparisons per call, which only the readings of the limits use.
    ``exact`` is the float32 reference, ``judge`` the float64 one.

    An exact number is the largest over its calls.  A solver's number is
    the median over its sampled calls: a float32 path parts from the
    float64 one now and then by chance (an LM step taken or rejected on
    rounding, a gate that admits a point on one side), on one call in
    tens, while a lower precision moves every call."""
    out: dict = {}
    detail: dict = {"world": capture.world}

    def worst(name, values, stat=max):
        values = list(values)
        out[name + "_n"] = len(values)
        if values:
            out[name] = float(stat(values))

    def parts(prefix, dicts):
        dicts = list(dicts)
        for key in (dicts[0] if dicts else {}):
            detail[f"{prefix}.{key}"] = [d[key] for d in dicts]
        return dicts

    if kind == "rigid":
        worst("features", (compare.features_gap(it["feats"], exact.extract(it["img"]))
                           for it in capture.extracts.items if it))
        worst("match", (compare.match_gap(it["out"][0], exact.match_rigid(
            it["points"], it["pose"], it["feats"], it["window"])[0])
                        for it in capture.matches.items if it))
        poses = parts("pose", (compare.pose_parts(it["out"], judge.pose_solve(
            it["T0"], it["idx"], it["feats"], it["points"])) for it in capture.poses.items if it))
        worst("pose", (p["pose"] for p in poses), statistics.median)

        def ba(it):
            r, objective = judge.local_ba(it["kfs"], it["points"])
            pid = it["kfs"].point_id
            ref_pid = torch.where((pid >= 0) & ~r.inlier, torch.full_like(pid, -1), pid)
            return compare.ba_parts(it["poses"], it["xyz"], it["point_id"], r.poses, r.xyz,
                                    ref_pid, it["kfs"].valid, it["points"].valid, objective)
        # read, not compared: no number of the BA separates the control
        # (PERF.md, section 2)
        parts("ba", (ba(it) for it in capture.bas.items if it))
        return out, detail

    if capture.init is not None:
        it = capture.init
        r = exact.initialize(it["feats"])
        p = it["points"]
        worst("init", [compare.init_gap(
            layers_init(p, it["nodes"]), r)])

    def frame(it):
        feats, matches, res, new_points, _ = it["out"]
        pred = exact.predict(it["pose"], it["prev_pose"])
        g = {"features": compare.features_gap(feats, exact.extract(it["img"])),
             "match": compare.match_gap(matches.kp_of_point, exact.match(
                 it["points"], pred, feats, it["window_scale"]).kp_of_point)}
        j, objective = judge.sft_judged(it["points"], matches, feats, it["tmpl"],
                                        judge.predict(it["pose"], it["prev_pose"]))
        g["sft"] = compare.sft_parts(res, j, objective)
        nxt = it.get("next")
        if (nxt is not None and not it["keyframe"] and nxt["frame"] == it["frame"] + 1
                and nxt["rollbacks"] == it["rollbacks"]):
            g["commit"] = compare.commit_gap(new_points, res.T, res.nodes, it["pose"], nxt)
        return g

    gaps = [frame(it) for it in capture.frames.items if it]
    for name in ("features", "match", "commit"):
        worst(name, (g[name] for g in gaps if name in g))
    sfts = parts("sft", (g["sft"] for g in gaps))
    worst("sft", (p["cost"] for p in sfts), statistics.median)
    worst("sft_inliers", (p["inliers"] for p in sfts), statistics.median)

    def keyframe(it):
        args = (it["kfs"], it["points"], it["tmpl"], it["pose"], it["feats"], it["kp_of_point"],
                it["inlier"], it["tmpl_ref_kf"], it["kf_counter"], it["frame_id"])
        if it.get("legacy"):
            return compare.legacy_keyframe_parts(it["out"], judge.keyframe_legacy(*args))
        return compare.keyframe_parts(it["out"], judge.keyframe_step(*args))
    # read, not compared: no gap of the step's outputs separates the
    # control from sound runs, which on some seeds re-embed a quarter of
    # the points into other facets on most steps (PERF.md, section 2); a
    # world of N ranks steps through the host-orchestrated chain, whose
    # map parts from one card's (it culls with the counter after its
    # increment), and ``ate`` holds it
    kfs = parts("keyframe", (keyframe(it) for it in capture.keyframes.items if it))
    out["keyframe_n"] = len(kfs)
    return out, detail


def layers_init(points, nodes):
    from portbench.reference.layers import InitState

    return InitState(xyz=points.xyz, desc=points.desc, facet=points.facet, bary=points.bary,
                     valid=points.valid, nodes=nodes)


# ----------------------------------------------------------- the checks


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def compared_lines(numbers: dict) -> list[str]:
    return [f"compared {name}: {n['value']!r} (limit {n['limit']!r})"
            for name, n in numbers.items()]


def _finite(obj):
    """The object with non-finite floats as strings (JSON has no inf)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def result_line(out: dict) -> str:
    return json.dumps(_finite(out))
