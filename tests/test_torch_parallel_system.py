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


def _sequence(motion: float):
    from defslam_tpu.io.synthetic import make_sequence

    kw = {"camera_motion": motion} if motion else {}
    return make_sequence(n_frames=9, height=96, width=128, max_amp=0.04, seed=2, **kw)


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


if __name__ == "__main__":
    _rank(*sys.argv[1:3])
