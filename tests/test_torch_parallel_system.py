"""The port's multi-device System at worlds 2, 3 and 4 on the CPU: the
counterpart of ``tests/test_parallel.py::test_system_parallel_matches_single_device``.

The JAX System with ``ParallelConfig(enabled=True, n_devices=4)`` runs on a
4-device virtual mesh (the conftest gives JAX 8 CPU devices); the port's
runs on a world of 4 processes over gloo, started by
``parallel.launch`` (one launch per world, one torch thread a rank), each
rank this file run as a script (``python tests/test_torch_parallel_system.py
inputs.pkl outdir``), which imports no JAX.  The config is
``tests/test_parallel.py:152-193``'s, 9 frames at 128x96, static and with
camera motion 0.5 (which swaps the template at both keyframes), as in the
world-1 test of ``tests/test_torch_parallel.py``.

The rules are that test's: states, keyframe and template flags equal,
match counts within 2 and inlier counts within 3, the pose within
max(2e-2, 3x the gap that a 1e-7 relative perturbation of the template
after frame 0 opens in the JAX run), ``template_ref_kf``, ``kf_counter``
and the keyframe store's slots equal.  World 4 is held to the JAX
System; worlds 2 and 3 (3 divides no power of two) to the port's world 1
under the same rules.  The ranks of every world return bit-equal rows,
trajectories and all-reduce counts.

The world a System makes in the test's process (``parallel.driver``: this
process rank 0, workers ranks 1-3, one torch thread each): rank 0 bit-equal
to rank 0 of the launched world 4 and held to the JAX System, every rank
bit-equal (a digest gathered by rank 0).  Every call rank 0 forwards
(localization toggles, ``apply_tuning`` mid-run, ``restart``, ``reset``,
``load_state`` of a world-1 checkpoint and of a JAX one, ``flush``) at
world 2, on 12 static frames: the ranks bit-equal after each step, rank 0
held to world 1 under the same calls (states, flags and slots equal,
matches within 2, inliers within 3, poses within 2e-2).
"""

import dataclasses
import json
import os
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from defslam_tpu_torch import parallel  # noqa: E402
from defslam_tpu_torch.parallel import launch  # noqa: E402

LAUNCH_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
CASES = {"static": 0.0, "moving": 0.5}
PROBE = 1e-7


# -------------------------------------------------------------- the ranks --


def _rank(inputs_path: str, outdir: str) -> None:
    """One rank: the port's parallel System on each case's frames, one
    group for both; rows, trajectory and store flags to ``rank<r>.npz``."""
    from defslam_tpu_torch.system import System

    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    cfg0 = next(iter(cases.values()))["cfg"]
    parallel.init_distributed(cfg0, "cpu", timeout=COLLECTIVE_TIMEOUT_S)
    try:
        for name, case in cases.items():
            s = System(case["cfg"], device="cpu")
            for t, f in enumerate(case["frames"]):
                s.track_monocular(f, float(t))
            s.flush()
            out[f"{name}_rows"] = json.dumps(s._metrics)
            out[f"{name}_traj"] = np.stack([np.asarray(T) for _, T in s.trajectory])
            out[f"{name}_store"] = np.array([s.template_ref_kf, s.kf_counter, s.group.size,
                                             s.group.n_all_reduce])
            out[f"{name}_kfs_valid"] = s.kfs.valid.numpy()
        np.savez(os.path.join(outdir, f"rank{torch.distributed.get_rank()}.npz"), **out)
    finally:
        parallel.shutdown()


# --------------------------------------------------------------- fixtures --


def _jax_config(seq, n_devices: int):
    from defslam_tpu.config import (CapacityConfig, Config, MappingConfig, OrbConfig,
                                    ParallelConfig, SfTConfig, TrackingConfig)

    return Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=160, n_levels=2, max_keypoints=192),
        sft=SfTConfig(lm_iterations=10),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
        mapping=MappingConfig(schwarp_lm_iterations=1, points_to_template=60, chi_limit=0.2),
        parallel=ParallelConfig(enabled=True, n_devices=n_devices),
    )


def _sequence(motion: float, n_frames: int = 9):
    from defslam_tpu.io.synthetic import make_sequence

    kw = {"camera_motion": motion} if motion else {}
    return make_sequence(n_frames=n_frames, height=96, width=128, max_amp=0.04, seed=2, **kw)


def _port_config(seq, n_devices: int):
    from defslam_tpu_torch.convert import config_from_dict

    return config_from_dict(dataclasses.asdict(_jax_config(seq, n_devices)))




@pytest.fixture(scope="module")
def port_worlds(tmp_path_factory):
    """The port at worlds 1-4, both cases: {world: [rank dicts]}."""
    from defslam_tpu_torch.convert import config_from_dict

    tmp = tmp_path_factory.mktemp("worlds")
    cases = {}
    for name, motion in CASES.items():
        seq = _sequence(motion)
        # n_devices 0: the whole world, whichever world runs it
        cfg = config_from_dict(dataclasses.asdict(_jax_config(seq, 0)))
        cases[name] = {"cfg": cfg, "frames": np.asarray(seq.frames)}
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(cases, f)
    env = {"PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    out = {}
    for world in (1, 2, 3, 4):
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        rc = launch.launch([sys.executable, __file__, str(inputs), str(wdir)], world, "cpu",
                           timeout=LAUNCH_TIMEOUT_S, env=env)
        assert rc == 0, f"world {world}: the launch exited {rc}"
        out[world] = [dict(np.load(wdir / f"rank{r}.npz")) for r in range(world)]
    return out


@pytest.fixture(scope="module")
def driven_world4(port_worlds):
    """``System(n_devices 4)`` built in this process on each case (rank 0
    here, ranks 1-3 its workers; after the launched worlds, which need no
    group in this process): {case: rank 0's results, every rank's digest
    and device}."""
    from defslam_tpu_torch.parallel import driver
    from defslam_tpu_torch.system import System

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, motion in CASES.items():
            seq = _sequence(motion)
            s = System(_port_config(seq, 4), device="cpu")
            try:
                for t, f in enumerate(seq.frames):
                    s.track_monocular(np.asarray(f), float(t))
                s.flush()
                out[name] = {
                    "rows": s._metrics, "traj": np.stack([np.asarray(T) for _, T in s.trajectory]),
                    "store": np.array([s.template_ref_kf, s.kf_counter, s.group.size,
                                       s.group.n_all_reduce]),
                    "kfs_valid": s.kfs.valid.numpy(), "devices": s._driver.devices,
                    "digests": s._driver.gather(s, driver.state_digest)}
            finally:
                s.shutdown()
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def jax_runs(request):
    """The JAX System on a 4-device mesh and its 1e-7 probe."""
    import jax.numpy as jnp

    from defslam_tpu.system import System as JaxSystem

    seq = _sequence(CASES[request.param])
    cfg = _jax_config(seq, 4)

    def run(perturb):
        s = JaxSystem(cfg)
        assert s.mesh.devices.size == 4
        for t, f in enumerate(seq.frames):
            s.track_monocular(f, float(t))
            if t == 0 and perturb:
                noise = np.random.default_rng(1).normal(0, perturb, (cfg.mesh.n_nodes, 3))
                s.template = s.template._replace(
                    nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
        s.flush()
        return s

    ref, probe = run(0.0), run(PROBE)
    probe_gap = [float(np.abs(np.asarray(Tp) - np.asarray(Tj)).max())
                 for (_, Tj), (_, Tp) in zip(ref.trajectory, probe.trajectory)]
    return request.param, {
        "rows": ref._metrics, "traj": np.stack([np.asarray(T) for _, T in ref.trajectory]),
        "store": (ref.template_ref_kf, ref.kf_counter), "kfs_valid": np.asarray(ref.kfs.valid),
        "probe_gap": probe_gap}


# ------------------------------------------------------------------ tests --


def _held(rows, traj, store, kfs_valid, ref: dict) -> None:
    """The rules of the module's docstring, ``rows`` ... against ``ref``."""
    assert len(rows) == len(ref["rows"]) == 9
    for a, b in zip(rows, ref["rows"]):
        assert a["state"] == b["state"] == "OK"
        assert a["keyframe"] == b["keyframe"] and a["template"] == b["template"], (a, b)
        assert abs(a["matches"] - b["matches"]) <= 2, (a, b)
        assert abs(a["inliers"] - b["inliers"]) <= 3, (a, b)
    for t, (Ta, Tb, gap) in enumerate(zip(traj, ref["traj"], ref["probe_gap"])):
        assert np.abs(Ta - Tb).max() <= max(2e-2, 3 * gap), t
    assert tuple(int(x) for x in store[:2]) == tuple(ref["store"])
    np.testing.assert_array_equal(kfs_valid, ref["kfs_valid"])


def _port(rank: dict, case: str):
    return (json.loads(str(rank[f"{case}_rows"])), rank[f"{case}_traj"], rank[f"{case}_store"],
            rank[f"{case}_kfs_valid"])


def test_world4_matches_the_jax_four_device_system(port_worlds, jax_runs):
    case, ref = jax_runs
    ranks = port_worlds[4]
    rows, traj, store, kfs_valid = _port(ranks[0], case)
    assert int(store[2]) == 4 and int(store[3]) > 0  # a world of 4, all-reduces made
    _held(rows, traj, store, kfs_valid, ref)


@pytest.mark.parametrize("world", [2, 3])
def test_worlds_2_and_3_match_world_1(port_worlds, jax_runs, world):
    """Held to the port's world 1, the pose within max(2e-2, 3x the JAX
    probe's gap) at each frame."""
    case, ref = jax_runs
    one = _port(port_worlds[1][0], case)
    base = {"rows": one[0], "traj": one[1], "store": tuple(int(x) for x in one[2][:2]),
            "kfs_valid": one[3], "probe_gap": ref["probe_gap"]}
    rows, traj, store, kfs_valid = _port(port_worlds[world][0], case)
    assert int(store[2]) == world
    _held(rows, traj, store, kfs_valid, base)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_ranks_are_bit_equal(port_worlds, world):
    """Every rank of a world: the same rows, trajectory, store and
    all-reduce count, bit for bit."""
    ranks = port_worlds[world]
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_in_process_world4_equals_the_launched_world4(port_worlds, driven_world4, case):
    """The world a System makes in this process: four ranks on the CPU,
    bit-equal to one another (their digests) and rank 0 bit-equal to rank 0
    of the launched world 4."""
    d = driven_world4[case]
    assert d["devices"] == ["cpu"] * 4 and len(set(d["digests"])) == 1
    rows, traj, store, kfs_valid = _port(port_worlds[4][0], case)
    assert d["rows"] == rows
    np.testing.assert_array_equal(d["traj"], traj)
    np.testing.assert_array_equal(d["store"], store)
    np.testing.assert_array_equal(d["kfs_valid"], kfs_valid)


def test_in_process_world4_matches_the_jax_four_device_system(driven_world4, jax_runs):
    case, ref = jax_runs
    d = driven_world4[case]
    assert int(d["store"][2]) == 4 and int(d["store"][3]) > 0
    _held(d["rows"], d["traj"], d["store"], d["kfs_valid"], ref)


# ------------------------------------------- every forwarded call, world 2 --

SCRIPT_FRAMES = 12
SNAPS = ("localization", "tuning", "restart", "reset", "world1_checkpoint", "jax_checkpoint")


def _script(s, frames, ckpt: str, jax_ckpt: str, digests) -> dict:
    """Every call that rank 0 of a world forwards, on ``s``: frames with
    localization mode on and off, ``apply_tuning`` mid-run, ``restart``,
    ``reset``, ``load_state`` of a world-1 checkpoint and of a JAX one, each
    followed by frames and a ``flush``.  {snapshot: rows, trajectory,
    keyframe slots, every rank's digest} after each step."""
    snaps = {}

    def track(ts):
        for t in ts:
            s.track_monocular(frames[t], float(t))

    def snap(name):
        s.flush()
        snaps[name] = {"rows": json.loads(json.dumps(s._metrics)),
                       "traj": np.stack([np.asarray(T) for _, T in s.trajectory]),
                       "kfs_valid": s.kfs.valid.numpy(), "digests": digests(s)}

    track(range(4))
    s.activate_localization_mode()
    track(range(4, 6))
    s.deactivate_localization_mode()
    snap("localization")
    track(range(6, 8))
    s.apply_tuning({"sft.lm_iterations": 8, "Regularizer.laplacian": 0.5})
    track(range(8, 10))
    snap("tuning")
    s.restart()
    track(range(10, 12))
    snap("restart")
    s.reset()
    track(range(3))
    snap("reset")
    s.load_state(ckpt)  # written after frame 5
    track(range(6, 9))
    snap("world1_checkpoint")
    s.load_state(jax_ckpt)  # written after frame 5
    track(range(6, 9))
    snap("jax_checkpoint")
    return snaps


@pytest.fixture(scope="module")
def forwarded_calls(port_worlds, tmp_path_factory):
    """The script at world 1 (in this process) and at world 2 (a world made
    by the System in this process), on the static case's first 12
    frames, after the launched worlds; the checkpoints from the port at
    world 1 and from the JAX System on its 4-device mesh, both after frame
    5.  {world: snapshots}."""
    from defslam_tpu.system import System as JaxSystem
    from defslam_tpu_torch.parallel import driver
    from defslam_tpu_torch.system import System

    tmp = tmp_path_factory.mktemp("forwarded")
    seq = _sequence(0.0, SCRIPT_FRAMES)
    frames = np.asarray(seq.frames)
    ckpt, jax_ckpt = str(tmp / "world1.npz"), str(tmp / "jax.npz")
    j = JaxSystem(_jax_config(seq, 4))
    for t in range(6):
        j.track_monocular(seq.frames[t], float(t))
    j.save_state(jax_ckpt)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        w1 = System(_port_config(seq, 1), device="cpu")
        for t in range(6):
            w1.track_monocular(frames[t], float(t))
        w1.save_state(ckpt)
        w1.shutdown()
        for world, digests in ((1, lambda s: [driver.state_digest(s)]),
                               (2, lambda s: s._driver.gather(s, driver.state_digest))):
            s = System(_port_config(seq, world), device="cpu")
            try:
                assert s.group.size == world and (s._driver is not None) == (world > 1)
                out[world] = _script(s, frames, ckpt, jax_ckpt, digests)
            finally:
                s.shutdown()
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("snap", SNAPS)
def test_every_forwarded_call_at_world_2(forwarded_calls, snap):
    """The ranks bit-equal (their digests) after each step, and rank 0 held
    to world 1 under the same calls: states, keyframe and template flags
    and keyframe slots equal, matches within 2, inliers within 3, poses
    within 2e-2 (tests/test_torch_checkpoint.py's rules for a continued
    run)."""
    two, one = forwarded_calls[2][snap], forwarded_calls[1][snap]
    assert len(two["digests"]) == 2 and len(set(two["digests"])) == 1
    assert len(two["rows"]) == len(one["rows"]) and len(two["traj"]) == len(one["traj"])
    for a, b in zip(two["rows"], one["rows"]):
        assert a["state"] == b["state"], (a, b)
        assert a["keyframe"] == b["keyframe"] and a["template"] == b["template"], (a, b)
        assert abs(a["matches"] - b["matches"]) <= 2 and abs(a["inliers"] - b["inliers"]) <= 3, (a, b)
    assert np.abs(two["traj"] - one["traj"]).max() <= 2e-2
    np.testing.assert_array_equal(two["kfs_valid"], one["kfs_valid"])


if __name__ == "__main__":
    _rank(*sys.argv[1:3])
