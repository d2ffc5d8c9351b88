"""The port's multi-device path (``defslam_tpu_torch.parallel``) against the
JAX package's (``defslam_tpu.parallel``), on the CPU.

A JAX mesh of N devices lives in one process; the port's world of N ranks
is N processes over gloo, one device each.  World 1 runs in the test's
own process; world 2 runs in worker processes started from this file (``python tests/test_torch_parallel.py
rank world rendezvous inputs.npz outdir jobs``), which import no JAX and
meet through a ``file://`` rendezvous in the test's temporary directory.
Every input is made here with numpy (the SfT problems through the port's
mesh functions) and handed to both packages as the same arrays.

Tolerances are ``tests/test_parallel.py``'s, sharded against single-device
and Schur against dense within one package: pose and nodes 1e-4 (the
Schur nodes 2e-4), at least 99% of the inlier gate equal, warps 1e-4,
normals 3e-3 (on the normals the mapping step's covariance gate keeps: two
of the 64 random problems are unobservable).  The port against the JAX
package's SfT is held to ``tests/test_torch_sft.py``'s 2e-4 where both LMs
take the same path (the single-device solves of the two packages are
1.0e-4 apart on the 10x10 problem here).  Against the port's own
single-device functions at world 1 the results are equal bit for bit
(the gathers are exact).  The ranks of a world return bit-equal
replicated and gathered results.

The System at world 1 against the JAX System on a one-device mesh (the
same legacy keyframe chain): ``tests/test_parallel.py:152-193``'s 9-frame
config, and the same with camera motion, where both swap the template at
both keyframes.  States, keyframe and template flags equal, match counts
within 2 and inlier counts within 3 (the mapping-run rule of
``tests/test_torch_system.py``), the pose within max(2e-2, 3x the gap that
a 1e-7 relative perturbation of the template after frame 0 opens in the
JAX package's own run).  The moving run is that sensitive in the port as
well: its own pose at frame 8 moves by up to 0.23 between 1, 2 and 4 CPU
threads (the order of float32 sums), so the threads are pinned to 2 as in
the other test files.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from defslam_tpu_torch import parallel
from defslam_tpu_torch.config import Config, MeshConfig, ParallelConfig, SfTConfig
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.mapping import normals as nrm
from defslam_tpu_torch.ops import bspline
from defslam_tpu_torch.parallel import sharded
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import sft

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 120
SFT_CFG = Config(sft=SfTConfig(lm_iterations=15))
SCHUR_CFG = Config(sft=SfTConfig(lm_iterations=12), mesh=MeshConfig(nodes_u=16, nodes_v=16))
WARP_DOM = (-0.5, 0.5, -0.4, 0.4)
K_TOY = [[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]]


# ---------------------------------------------------------------- inputs --


def _toy_obs(p=64, o=2, seed=0) -> dict:
    """tests/test_parallel.py's normal-solve problem."""
    rng = np.random.default_rng(seed)
    return dict(
        uv1=rng.uniform(-0.2, 0.2, (p, o, 2)).astype(np.float32),
        uv2=rng.uniform(-0.2, 0.2, (p, o, 2)).astype(np.float32),
        J12=(np.tile(np.eye(2), (p, o, 1, 1)) + rng.normal(0, 0.05, (p, o, 2, 2))).astype(np.float32),
        Huu=rng.normal(0, 0.1, (p, o, 2)).astype(np.float32),
        Hvv=rng.normal(0, 0.1, (p, o, 2)).astype(np.float32),
        mask=np.ones((p, o), bool),
    )


def _warp_batch(n_pairs=8, seed=1) -> dict:
    """tests/test_parallel.py's warp-fit problem."""
    rng = np.random.default_rng(seed)
    uv1 = rng.uniform(-0.4, 0.4, (n_pairs, mapper.PAIR_CAP, 2)).astype(np.float32)
    uv2 = uv1 + 0.01 * rng.normal(size=uv1.shape).astype(np.float32)
    return dict(uv1=uv1, uv2=uv2, mask=np.ones((n_pairs, mapper.PAIR_CAP), bool),
                pair_valid=np.ones(n_pairs, bool))


def _sft_problem(nu, nv, n, seed, noise, masked) -> dict:
    """tests/test_parallel.py's SfT problems, made through the port's mesh
    functions: a plane template over [-0.4, 0.4] x [-0.3, 0.3], n points
    embedded at random, observed from the identity pose with pixel noise,
    a tenth of them masked where ``masked``.  The SfTData fields as numpy."""
    topo = meshmod.grid_topology(nu, nv)
    dom = torch.tensor([-0.4, 0.4, -0.3, 0.3])
    K = torch.tensor(K_TOY)
    nodes = meshmod.grid_nodes_from_surface(
        lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1), dom, topo)
    tmpl = meshmod.make_template(nodes, topo)
    rng = np.random.default_rng(seed)
    uvp = torch.as_tensor(np.stack([rng.uniform(-0.38, 0.38, n), rng.uniform(-0.28, 0.28, n)],
                                   1).astype(np.float32))
    facet, bary, _ = meshmod.embed_uv(uvp, dom, topo)
    pts = meshmod.facet_positions(nodes, topo, facet, bary)
    obs = cam.project(K, pts) + torch.as_tensor(rng.normal(0, noise, (n, 2)).astype(np.float32))
    mask = rng.uniform(size=n) > 0.1 if masked else np.ones(n, bool)
    data = sft.data_from_template(tmpl, K, torch.eye(4), obs_uv=obs, obs_face=facet,
                                  obs_bary=bary, obs_invsigma2=torch.ones(n),
                                  obs_mask=torch.as_tensor(mask), n_kp=float(n))
    return {f: getattr(data, f).numpy() for f in sft.SfTData._fields}


def _inputs() -> dict:
    """Every problem of this file, flattened into one npz-able dict."""
    out = {}
    for prefix, d in (("obs_", _toy_obs()), ("warp_", _warp_batch()),
                      ("sft_", _sft_problem(10, 10, 128, 5, 1.0, True)),
                      ("schur_", _sft_problem(16, 16, 512, 7, 0.8, False))):
        out.update({prefix + k: v for k, v in d.items()})
    # one damped system of the 16x16 problem, coupled as the mesh couples
    d = _port_sft_data(_part(out, "schur_"))
    H, g, _ = sft.normal_equations(d.T0, d.nodes0, d, meshmod.grid_topology(16, 16), SCHUR_CFG,
                                   SCHUR_CFG.regularizer.temporal)
    out["spd_A"] = (H + 1e-3 * torch.diag(torch.diagonal(H) + 1e-9)).numpy()
    out["spd_g"] = g.numpy()
    return out


def _part(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}


def _port_sft_data(d: dict) -> sft.SfTData:
    return sft.SfTData(**{f: torch.as_tensor(d[f]) for f in sft.SfTData._fields})


def _jax_sft_data(d: dict):
    import jax.numpy as jnp

    from defslam_tpu.tracking import sft as jsft

    fields = {f: jnp.asarray(d[f]) for f in jsft.SfTData._fields}
    fields["obs_face"] = jnp.asarray(d["obs_face"].astype(np.int32))
    return jsft.SfTData(**fields)


# ---------------------------------------------------------- the computation --


def _run_jobs(group: sharded.Group, inputs: dict, jobs) -> dict:
    """The sharded computations of this file on ``group``; numpy results."""
    out = {}
    if "normals" in jobs:
        o = _part(inputs, "obs_")
        obs = nrm.PairObs(**{k: torch.as_tensor(v) for k, v in o.items()})
        r = sharded.sharded_normal_solves(group, obs, torch.zeros(o["mask"].shape[0], 2))
        out.update({f"normals_{k}": v.numpy() for k, v in r._asdict().items()})
    if "warps" in jobs:
        b = _part(inputs, "warp_")
        dom = torch.tensor(WARP_DOM)
        c = Config()
        bend = bspline.bending_matrix(dom, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v)
        batch = mapper.WarpBatch(**{k: torch.as_tensor(v) for k, v in b.items()})
        dps, ctrl = sharded.sharded_warp_fits(group, batch, dom, bend, c)
        out.update({f"warps_{k}": v.numpy() for k, v in dps._asdict().items()})
        out["warps_ctrl"] = ctrl.numpy()
    for job, cfg in (("sft", SFT_CFG), ("schur", SCHUR_CFG)):
        if job in jobs:
            r = sharded.sft_solve_sharded(group, _port_sft_data(_part(inputs, job + "_")), cfg)
            out.update({f"{job}_{k}": v.numpy() for k, v in r._asdict().items()})
    if "schur_direct" in jobs:
        c = SCHUR_CFG.mesh
        part = sharded._node_partition(c.nodes_u, c.nodes_v, group.size, "cpu")
        x = sharded._schur_solve(torch.as_tensor(inputs["spd_A"]),
                                 torch.as_tensor(inputs["spd_g"]), part, group)
        out["schur_direct_x"] = x.numpy()
    out["n_all_reduce"] = np.asarray(group.n_all_reduce)
    return out


def _worker(rank: int, world: int, rdv: str, inputs_path: str, outdir: str, jobs: str) -> None:
    torch.set_num_threads(1)
    cfg = Config(parallel=ParallelConfig(enabled=True, coordinator=f"file://{rdv}",
                                         num_processes=world, process_id=rank))
    assert parallel.init_distributed(cfg, "cpu", timeout=COLLECTIVE_TIMEOUT_S) == (world > 1)
    try:
        with np.load(inputs_path) as f:
            inputs = dict(f)
        out = _run_jobs(sharded.make_group(world), inputs, jobs.split(","))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        parallel.shutdown()


def _spawn(tmp: pathlib.Path, world: int, jobs: str) -> list[dict]:
    """Run the jobs on a world of ``world`` worker processes; each rank's
    results."""
    inputs_path = tmp / "inputs.npz"
    if not inputs_path.exists():
        np.savez(inputs_path, **_inputs())
    outdir = tmp / f"world{world}"
    outdir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp / f"rdv{world}"),
         str(inputs_path), str(outdir), jobs],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world1(inputs):
    """All jobs at world 1, in this process (a gloo group on a HashStore)."""
    cfg = Config(parallel=ParallelConfig(enabled=True))
    assert parallel.init_distributed(cfg, "cpu", timeout=COLLECTIVE_TIMEOUT_S) is False
    try:
        return [_run_jobs(sharded.make_group(1), inputs,
                          ["normals", "warps", "sft", "schur", "schur_direct"])]
    finally:
        parallel.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world2"), 2, "normals,warps,sft,schur,schur_direct")


@pytest.fixture
def runs(request):
    return request.getfixturevalue(request.param)


def _jax_mesh(n):
    from defslam_tpu.parallel import sharded as jsharded

    return jsharded.make_mesh(n)


# ----------------------------------------------------------------- tests --


@pytest.mark.parametrize("runs", ["world1", "world2"], indirect=True)
def test_sharded_normals_match_reference(inputs, runs):
    import jax.numpy as jnp

    from defslam_tpu.mapping import normals as jnrm
    from defslam_tpu.parallel import sharded as jsharded

    o = _part(inputs, "obs_")
    jobs = jnrm.PairObs(**{k: jnp.asarray(v) for k, v in o.items()})
    ref = jsharded.sharded_normal_solves(_jax_mesh(len(runs)), jobs, jnp.zeros((64, 2)))
    single = nrm.solve_k1k2(nrm.PairObs(**{k: torch.as_tensor(v) for k, v in o.items()}),
                            torch.zeros(64, 2))
    # the covariance gate of the mapping step: 2 of the 64 random problems
    # are unobservable (covariance ~1e10), and their k wander off (~1e5)
    # along the flat direction in either package
    gate = mapper.normal_reliability_gate(single, Config().regularizer.reliability).numpy()
    assert gate.sum() >= 56
    for r in runs:
        got = nrm.NormalResult(*(torch.as_tensor(r[f"normals_{k}"]) for k in nrm.NormalResult._fields))
        assert (mapper.normal_reliability_gate(got, Config().regularizer.reliability).numpy()
                == gate).all()
        np.testing.assert_allclose(r["normals_k"][gate], np.asarray(ref.k)[gate], atol=3e-3)
        np.testing.assert_allclose(r["normals_cost"], np.asarray(ref.cost), rtol=1e-4, atol=1e-7)
        assert (r["normals_valid"] == np.asarray(ref.valid)).all()
        # each point's LM is independent of the batch: the shares are exact
        for k, v in single._asdict().items():
            np.testing.assert_array_equal(r[f"normals_{k}"], v.numpy())


@pytest.mark.parametrize("runs", ["world1", "world2"], indirect=True)
def test_sharded_warp_fits_match_reference(inputs, runs):
    import jax.numpy as jnp

    from defslam_tpu.config import Config as JConfig
    from defslam_tpu.mapping import mapper as jmapper
    from defslam_tpu.ops import bspline as jbspline
    from defslam_tpu.parallel import sharded as jsharded

    b = _part(inputs, "warp_")
    jc = JConfig()
    dom = jnp.asarray(WARP_DOM, jnp.float32)
    B = jbspline.bending_matrix(dom, jc.mapping.warp_ctrl_u, jc.mapping.warp_ctrl_v)
    jbatch = jmapper.WarpBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    ref, _ = jsharded.sharded_warp_fits(_jax_mesh(len(runs)), jbatch, dom, B, jc)
    for r in runs:
        np.testing.assert_allclose(r["warps_warped"], np.asarray(ref.warped), atol=1e-4)
        assert (r["warps_mask"] == np.asarray(ref.mask)).all()
    if len(runs) == 1:
        c = Config()
        dom_t = torch.tensor(WARP_DOM)
        single, ctrl = mapper.fit_warps(
            mapper.WarpBatch(**{k: torch.as_tensor(v) for k, v in b.items()}), dom_t,
            bspline.bending_matrix(dom_t, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v), c)
        for k, v in single._asdict().items():
            np.testing.assert_array_equal(runs[0][f"warps_{k}"], v.numpy())
        np.testing.assert_array_equal(runs[0]["warps_ctrl"], ctrl.numpy())


@pytest.mark.parametrize("runs", ["world1", "world2"], indirect=True)
def test_sharded_sft_matches_reference(inputs, runs):
    """Against the JAX package's sharded solver on a mesh of the same size,
    and against the single-device solve (the JAX test's comparison)."""
    from defslam_tpu.config import Config as JConfig
    from defslam_tpu.config import SfTConfig as JSfTConfig
    from defslam_tpu.parallel import sharded as jsharded
    from defslam_tpu.template import mesh as jmesh
    from defslam_tpu.tracking import sft as jsft

    d = _part(inputs, "sft_")
    jc = JConfig(sft=JSfTConfig(lm_iterations=15))
    ref = jsharded.sft_solve_sharded(_jax_mesh(len(runs)), _jax_sft_data(d), jc)
    single = jsft.solve(_jax_sft_data(d), jmesh.grid_topology(10, 10), jc)
    port_single = sft.solve(_port_sft_data(d), meshmod.grid_topology(10, 10), SFT_CFG)
    for r in runs:
        for other, tol in ((port_single, 1e-4), (ref, 2e-4), (single, 2e-4)):
            np.testing.assert_allclose(r["sft_T"], np.asarray(other.T), atol=tol)
            np.testing.assert_allclose(r["sft_nodes"], np.asarray(other.nodes), atol=tol)
            assert (r["sft_inlier"] == np.asarray(other.inlier)).mean() > 0.99
        np.testing.assert_allclose(r["sft_chi2"], np.asarray(ref.chi2), rtol=1e-3, atol=5e-3)


def test_schur_partition_matches_dense(inputs, world2, world1):
    """16x16 nodes, 512 observations: the Schur partition engages at world 2
    (8 u-rows a rank), and the result matches the dense
    solve: world 1's (the same LM, one Cholesky), JAX's single-device
    ``sft.solve`` (the JAX test's comparison) and JAX's sharded solver on a
    mesh of the same size."""
    from defslam_tpu.config import Config as JConfig
    from defslam_tpu.config import MeshConfig as JMeshConfig
    from defslam_tpu.config import SfTConfig as JSfTConfig
    from defslam_tpu.parallel import sharded as jsharded
    from defslam_tpu.template import mesh as jmesh
    from defslam_tpu.tracking import sft as jsft

    jc = JConfig(sft=JSfTConfig(lm_iterations=12), mesh=JMeshConfig(nodes_u=16, nodes_v=16))
    d = _jax_sft_data(_part(inputs, "schur_"))
    refs = [(world1[0]["schur_T"], world1[0]["schur_nodes"])] + [
        (np.asarray(r.T), np.asarray(r.nodes)) for r in (
            jsft.solve(d, jmesh.grid_topology(16, 16), jc),
            jsharded.sft_solve_sharded(_jax_mesh(2), d, jc))]
    for r in world2:
        for T, nodes in refs:
            np.testing.assert_allclose(r["schur_T"], T, atol=1e-4)
            np.testing.assert_allclose(r["schur_nodes"], nodes, atol=2e-4)


def test_schur_solve_drops_only_cross_strip_couplings(inputs, world2):
    """One damped system of the 16x16 problem at world 2.  The partitioned
    elimination equals the dense solve of the system without the couplings
    between the two strips' interiors, and those are not zero: the
    curvature term's 1-ring around an interface node couples the rows on
    both sides of it.  The JAX package's partition drops them as well (its
    docstring calls it exact); the LM's accept test absorbs the
    approximation (test_schur_partition_matches_dense)."""
    A = inputs["spd_A"].astype(np.float64)
    g = inputs["spd_g"].astype(np.float64)
    ii, vi, _ = (t.numpy() for t in sharded._node_partition(16, 16, 2, "cpu"))
    a0, a1 = ii[0][vi[0]], ii[1][vi[1]]
    assert np.abs(A[np.ix_(a0, a1)]).max() > 1.0
    A[np.ix_(a0, a1)] = 0.0
    A[np.ix_(a1, a0)] = 0.0
    x = np.linalg.solve(A, g)
    for r in world2:
        np.testing.assert_allclose(r["schur_direct_x"], x, atol=1e-6)


def test_ranks_agree_bit_for_bit(world2):
    """Every replicated or gathered result is equal on both ranks, and each
    rank made as many all-reduces."""
    assert world2[1].keys() == world2[0].keys()
    for k, v in world2[1].items():
        np.testing.assert_array_equal(v, world2[0][k], err_msg=k)


def test_node_partition_matches_reference():
    from defslam_tpu.parallel import sharded as jsharded

    for nu, nv, n in ((16, 16, 2), (16, 16, 4), (12, 8, 3), (10, 10, 1)):
        ours = sharded._node_partition(nu, nv, n, "cpu")
        ref = jsharded._node_partition(nu, nv, n)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_make_group_refuses_a_world_that_does_not_fit():
    """n_devices 0 or the world size; anything else raises (there is no
    fall-back onto other devices), as does a group without a process group
    and a device the group's backend does not serve."""
    cfg = Config(parallel=ParallelConfig(enabled=True))
    with pytest.raises(RuntimeError):
        sharded.make_group(0)
    parallel.init_distributed(cfg, "cpu", timeout=COLLECTIVE_TIMEOUT_S)
    try:
        assert parallel.init_distributed(cfg, "cpu") is False  # idempotent
        with pytest.raises(RuntimeError):  # a CUDA System needs NCCL, not this gloo group
            parallel.init_distributed(cfg, "cuda")
        assert sharded.make_group(0).size == sharded.make_group(1).size == 1
        for n in (2, 8):
            with pytest.raises(ValueError):
                sharded.make_group(n)
    finally:
        parallel.shutdown()
    assert not torch.distributed.is_initialized()


# ------------------------------------------------- the System, world 1 --


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["static", "moving"])
def system_runs(request):
    """The JAX System on a one-device mesh, its 1e-7 probe, and the port's
    parallel System at world 1, on test_parallel.py:152-193's config
    (``moving``: with camera motion 0.5, which swaps the template)."""
    import jax.numpy as jnp

    from defslam_tpu.config import (CapacityConfig, MappingConfig, OrbConfig, TrackingConfig)
    from defslam_tpu.config import Config as JConfig
    from defslam_tpu.config import ParallelConfig as JParallelConfig
    from defslam_tpu.config import SfTConfig as JSfTConfig
    from defslam_tpu.io.synthetic import make_sequence
    from defslam_tpu.system import System as JaxSystem
    from defslam_tpu_torch.convert import config_from_dict
    from defslam_tpu_torch.system import System

    kw = {"camera_motion": request.param} if request.param else {}
    seq = make_sequence(n_frames=9, height=96, width=128, max_amp=0.04, seed=2, **kw)
    cfg = JConfig(
        camera=seq.camera,
        orb=OrbConfig(n_features=160, n_levels=2, max_keypoints=192),
        sft=JSfTConfig(lm_iterations=10),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
        mapping=MappingConfig(schwarp_lm_iterations=1, points_to_template=60, chi_limit=0.2),
        parallel=JParallelConfig(enabled=True, n_devices=1),
    )

    def run_jax(perturb):
        s = JaxSystem(cfg)
        assert s.mesh.devices.size == 1
        for t, f in enumerate(seq.frames):
            s.track_monocular(f, float(t))
            if t == 0 and perturb:
                noise = np.random.default_rng(1).normal(0, perturb, (cfg.mesh.n_nodes, 3))
                s.template = s.template._replace(
                    nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
        s.flush()
        return s

    ref, probe = run_jax(0.0), run_jax(1e-7)
    port = System(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    try:
        assert port.group is not None and port.group.size == 1
        results = [port.track_monocular(f, float(t)) for t, f in enumerate(seq.frames)]
        port.flush()
    finally:
        port.shutdown()
    return ref, probe, port, results


def test_system_parallel_matches_reference(system_runs):
    ref, probe, port, _ = system_runs
    assert len(port._metrics) == len(ref._metrics) == 9
    for mj, mt in zip(ref._metrics, port._metrics):
        assert mt["state"] == mj["state"] == "OK"
        assert mt["keyframe"] == mj["keyframe"] and mt["template"] == mj["template"], (mj, mt)
        assert abs(mt["matches"] - mj["matches"]) <= 2, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 3, (mj, mt)
    for (_, Tj), (_, Tp), (_, Tt) in zip(ref.trajectory, probe.trajectory, port.trajectory):
        probe_gap = np.abs(np.asarray(Tp) - np.asarray(Tj)).max()
        assert np.abs(Tt - np.asarray(Tj)).max() <= max(2e-2, 3 * probe_gap)
    assert port.template_ref_kf == ref.template_ref_kf and port.kf_counter == ref.kf_counter
    assert torch.equal(port.kfs.valid, torch.as_tensor(np.asarray(ref.kfs.valid)))


def test_system_parallel_keyframes(system_runs):
    """The legacy chain: keyframe frames are synchronous (a validated numpy
    pose comes back, not an in-flight tensor), no deferred diagnostics, the
    template flag in the metrics row, the frame's all-reduces counted, and
    the process group gone after ``shutdown``."""
    ref, _, port, results = system_runs
    for m, pose in zip(port._metrics[1:], results[1:]):
        assert isinstance(pose, np.ndarray) == m["keyframe"]
    assert port.last_map_diag is None and port._pending_map is None
    swaps = [m["template"] for m in port._metrics[1:] if m["keyframe"]]
    assert swaps == [m["template"] for m in ref._metrics[1:] if m["keyframe"]]
    assert port.group.n_all_reduce > 0 and port.group.all_reduce_bytes > 0
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
