"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip on a host without one; on the card run
``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file imports
no JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from defslam_tpu_torch.ops import cuda_build, hamming


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hamming kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 1536), (200, 333), (256, 128), (1, 1),
                                 (2049, 1537), (17, 9), (5, 4), (64, 1535)])
def test_hamming_kernel_matches_plain(cuda_device, n, m):
    rng = np.random.default_rng(n * 7 + m)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32), device=cuda_device)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)).astype(np.int32), device=cuda_device)
    before = cuda_build.LAUNCHES["hamming_matrix"]
    out = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hamming_matrix"] == before + 1
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_hamming_kernel_sign_bit_words(cuda_device):
    """Every word 0x80000000 or 0xFFFFFFFF: the kernel must treat the int32
    words as unsigned bits."""
    from chip_smoke import hamming_cases

    a, b = hamming_cases(cuda_device)["signbit"]
    assert (a < 0).all() and (b < 0).all()
    out = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_hamming_kernel_writes_into_out(cuda_device, offset):
    """``out=``: the same buffer comes back, and an output that is not
    16-byte aligned (offsets 1 and 2) takes the kernel's 4-byte stores."""
    rng = np.random.default_rng(5)
    n, m = 100, 64
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32), device=cuda_device)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)).astype(np.int32), device=cuda_device)
    flat = torch.full((n * m + 8,), -7, dtype=torch.int32, device=cuda_device)
    out = flat[offset:offset + n * m].view(n, m)
    got = hamming.hamming_matrix(a, b, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))
    assert (flat[:offset] == -7).all() and (flat[offset + n * m:] == -7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "ragged", "one", "outside", "dead", "ties",
                                  "nan", "wide", "dense", "deadpairs", "overflow"])
def test_windowed_match_kernel_matches_plain(cuda_device, case):
    """The cases of ``chip_smoke.windowed_cases``: the mapping path's
    shape, ragged shapes, one element, nothing in the window, dead rows and
    pairs, minima tied across lanes and warps, NaN positions, more columns
    than one staged round, every pair admitted (the row queues overflow),
    only pair 0 alive, and rows that overflow their queue beside rows that
    do not in one warp."""
    from chip_smoke import windowed_cases
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.ops import matching, windowed_match as wm

    args, radius = windowed_cases(Config(), cuda_device)[case]
    before = cuda_build.LAUNCHES["windowed_match"]
    out = wm.windowed_match(*args, radius, matching.INVALID)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["windowed_match"] == before + 1
    ref = wm.windowed_match_plain(*args, radius, matching.INVALID)
    for o, r, name in zip(out, ref, ("best", "idx", "second")):
        assert o.dtype == r.dtype and torch.equal(o, r), (case, name)
    if case == "outside":
        assert (out[0] == matching.INVALID).all() and (out[1] == 0).all()
    if case == "ties":
        assert (out[0] == out[2]).all()
    if case == "deadpairs":
        assert (out[0][1:] == matching.INVALID).all() and (out[1][1:] == 0).all()


@pytest.mark.cuda
def test_windowed_match_kernel_writes_into_out(cuda_device):
    """``out=``: best and second are the two planes of the given int32
    buffer, idx the given int64 tensor, with one launch and no cast."""
    from chip_smoke import windowed_cases, windowed_out
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.ops import matching, windowed_match as wm

    args, radius = windowed_cases(Config(), cuda_device)["ragged"]
    pre = windowed_out(args[0].shape[0], args[0].shape[1], cuda_device)
    best, idx, second = wm.windowed_match(*args, radius, matching.INVALID, out=pre)
    torch.cuda.synchronize()
    assert best.data_ptr() == pre[0][0].data_ptr() and second.data_ptr() == pre[0][1].data_ptr()
    assert idx.data_ptr() == pre[1].data_ptr() and idx.dtype == torch.int64
    ref = wm.windowed_match_plain(*args, radius, matching.INVALID)
    assert all(torch.equal(o, r) for o, r in zip((best, idx, second), ref))


@pytest.mark.cuda
def test_hamming_kernel_at_the_relocalization_shape(cuda_device):
    """Relocalization's one launch: the frame's 1536 descriptors against all
    24 keyframe slots' 1536 each, (1536, 8) x (36864, 8), exact."""
    rng = np.random.default_rng(24)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (1536, 8)).astype(np.int32),
                        device=cuda_device)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (24 * 1536, 8)).astype(np.int32),
                        device=cuda_device)
    before = cuda_build.LAUNCHES["hamming_matrix"]
    out = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hamming_matrix"] == before + 1
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_keyframe_votes_launch_the_kernel_once(cuda_device):
    """``pose_opt.keyframe_votes`` on the card: one B1 launch over every
    slot, and the votes and matches of the CPU's plain route."""
    from defslam_tpu_torch.config import CapacityConfig, Config, OrbConfig
    from defslam_tpu_torch.frontend import Features
    from defslam_tpu_torch.mapstore import state as store
    from defslam_tpu_torch.tracking import pose_opt

    cfg = Config(orb=OrbConfig(max_keypoints=256), capacity=CapacityConfig(max_keyframes=6))
    torch.manual_seed(0)
    rng = np.random.default_rng(7)
    kfs = store.empty_keyframes(cfg, "cpu")
    words = rng.integers(-2**31, 2**31, (6, 256, 8)).astype(np.int32)
    desc = torch.as_tensor(words)
    flip = torch.as_tensor(rng.integers(0, 2, (256, 8)).astype(np.int32))
    kfs = kfs._replace(desc=desc, kp_valid=torch.rand(6, 256) < 0.9,
                       point_id=torch.arange(6 * 256).reshape(6, 256),
                       valid=torch.tensor([True, True, True, False, True, True]))
    feats = Features(xy=torch.zeros(256, 2), response=torch.zeros(256),
                     level=torch.zeros(256, dtype=torch.int32), angle=torch.zeros(256),
                     desc=desc[1] ^ flip, valid=torch.rand(256) < 0.9)
    cpu = pose_opt.keyframe_votes(feats, kfs, cfg)
    on = lambda nt: type(nt)(*(t.to(cuda_device) for t in nt))  # noqa: E731
    before = cuda_build.LAUNCHES["hamming_matrix"]
    card = pose_opt.keyframe_votes(on(feats), on(kfs), cfg)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hamming_matrix"] == before + 1
    assert all(torch.equal(c.cpu(), r) for c, r in zip(card, cpu))
    assert int(cpu[0][1]) > 100 and int(cpu[0].sum()) == int(cpu[0][1])  # only slot 1 matches


@pytest.mark.cuda
def test_readback_on_the_card(cuda_device):
    """``utils.Readback``: pinned copies behind the queued work, ready once
    the event has passed, the values of the device tensors."""
    from defslam_tpu_torch.utils import Readback

    x = torch.arange(1000, dtype=torch.int32, device=cuda_device)
    y = torch.randn(4, 4, device=cuda_device)
    rb = Readback.start((x, y))
    a, b = rb.get()
    assert rb.ready()
    assert np.array_equal(a, np.arange(1000)) and np.array_equal(b, y.cpu().numpy())


def _small_pipelined_system(cuda_device, parallel=False, keyframe_period=100, **tracking):
    from defslam_tpu_torch.config import (
        CapacityConfig, Config, OrbConfig, ParallelConfig, SfTConfig, TrackingConfig,
    )
    from defslam_tpu_torch.io.synthetic import make_sequence
    from defslam_tpu_torch.system import System

    seq = make_sequence(n_frames=8, height=120, width=160, max_amp=0.08)
    cfg = Config(camera=seq.camera, orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
                 sft=SfTConfig(lm_iterations=15),
                 tracking=TrackingConfig(keyframe_period=keyframe_period, **tracking),
                 capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
                 parallel=ParallelConfig(enabled=parallel))
    frames = [torch.as_tensor(f, device=cuda_device) for f in seq.frames]
    return System(cfg, device=cuda_device), frames


@pytest.mark.cuda
def test_pipelined_dispatch_makes_no_host_wait(cuda_device):
    """A non-keyframe pipelined dispatch runs under
    ``set_sync_debug_mode("error")``: nothing on it makes the host wait
    for the card (the frame's readback waits on an event, later)."""
    s, frames = _small_pipelined_system(cuda_device)
    for t in range(5):
        s.track_monocular(frames[t], float(t))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(5, 8):
            pose = s.track_monocular(frames[t], float(t))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.is_tensor(pose) and pose.is_cuda
    s.flush()
    assert [m["state"] for m in s._metrics] == ["OK"] * 8 and s.n_rollbacks == 0


@pytest.mark.cuda
def test_parallel_frame_dispatch_makes_no_host_wait(cuda_device):
    """Parallel mode at world 1 over NCCL: a frame without a keyframe,
    after a legacy keyframe at frame 4, runs under
    ``set_sync_debug_mode("error")`` (the all-reduces queue on the stream
    and make the host wait for nothing)."""
    from defslam_tpu_torch import parallel
    from defslam_tpu_torch.config import Config

    parallel.init_distributed(Config(), cuda_device, timeout=120)  # the System finds it up
    s, frames = _small_pipelined_system(cuda_device, parallel=True, keyframe_period=4)
    try:
        assert s.group is not None and s.group.size == 1
        for t in range(5):
            s.track_monocular(frames[t], float(t))
        torch.cuda.synchronize()
        calls = s.group.n_all_reduce
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(5, 8):
                pose = s.track_monocular(frames[t], float(t))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.is_tensor(pose) and pose.is_cuda
        assert s.group.n_all_reduce > calls
        s.flush()
        assert [m["state"] for m in s._metrics] == ["OK"] * 8 and s.n_rollbacks == 0
        assert [m["keyframe"] for m in s._metrics] == [True, False, False, False, True,
                                                        False, False, False]
    finally:
        s.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_sharded_sft_over_nccl_repeats_and_matches_the_cpu(cuda_device):
    """``sft_solve_sharded`` at world 1 over NCCL, at full width (1536
    observations on the default 10x10 template): two calls are bit-equal,
    and the same call over gloo on the CPU agrees in pose and nodes within
    1e-4, or within 3x the gap a 1e-7 relative perturbation of the start
    nodes opens on the CPU where that is larger (on this flat template it
    moves the nodes by 2.9e-4: rounding moves them along the solve's flat
    directions), with >= 99% of the inlier gate equal."""
    import datetime

    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.parallel import sharded

    cfg = Config()
    results = {}
    for device, backend in ((cuda_device, "nccl"), (torch.device("cpu"), "gloo")):
        torch.distributed.init_process_group(
            backend, store=torch.distributed.HashStore(), world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=120))
        try:
            group = sharded.make_group(1)
            data = _full_width_sft_data(device)
            runs = [sharded.sft_solve_sharded(group, data, cfg) for _ in range(2)]
            if device.type == "cpu":
                noise = torch.as_tensor(np.random.default_rng(1).normal(0, 1e-7, (100, 3)),
                                        dtype=torch.float32)
                runs.append(sharded.sft_solve_sharded(
                    group, data._replace(nodes0=data.nodes0 * (1 + noise)), cfg))
            assert group.n_all_reduce > 0
        finally:
            torch.distributed.destroy_process_group()
        for a, b in zip(runs[0], runs[1]):
            assert torch.equal(a, b)
        results[device.type] = runs
    g, c = results["cuda"][0], results["cpu"][0]
    probe = results["cpu"][2]
    for k in ("T", "nodes"):
        gap = (getattr(g, k).cpu() - getattr(c, k)).abs().max()
        tol = max(1e-4, 3 * float((getattr(probe, k) - getattr(c, k)).abs().max()))
        assert gap <= tol, (k, float(gap), tol)
    assert (g.inlier.cpu() == c.inlier).float().mean() >= 0.99


def _full_width_sft_data(device):
    """1536 points embedded at random in the default 10x10 plane template,
    seen from the identity with 0.5 px noise (seed 3)."""
    from defslam_tpu_torch.geometry import camera as cam
    from defslam_tpu_torch.template import mesh as meshmod
    from defslam_tpu_torch.tracking import sft

    topo = meshmod.grid_topology(10, 10)
    dom = torch.tensor([-0.4, 0.4, -0.3, 0.3], device=device)
    K = torch.tensor([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], device=device)
    nodes = meshmod.grid_nodes_from_surface(
        lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1), dom, topo)
    rng = np.random.default_rng(3)
    n = 1536
    uvp = torch.as_tensor(np.stack([rng.uniform(-0.38, 0.38, n), rng.uniform(-0.28, 0.28, n)], 1),
                          dtype=torch.float32, device=device)
    facet, bary, _ = meshmod.embed_uv(uvp, dom, topo)
    obs = cam.project(K, meshmod.facet_positions(nodes, topo, facet, bary)) + torch.as_tensor(
        rng.normal(0, 0.5, (n, 2)), dtype=torch.float32, device=device)
    return sft.data_from_template(
        meshmod.make_template(nodes, topo), K, torch.eye(4, device=device), obs_uv=obs,
        obs_face=facet, obs_bary=bary, obs_invsigma2=torch.ones(n, device=device),
        obs_mask=torch.ones(n, dtype=torch.bool, device=device), n_kp=float(n))


@pytest.mark.cuda
def test_stereo_app_on_the_card_gives_the_cpu_run(cuda_device, tmp_path):
    """The stereo app at 160x120 on ``cuda`` against the same app with
    ``--device cpu``: Matches.txt rows alike (timestamps, states, keyframe
    and template flags equal; counts within 2% or 1, the card-vs-CPU rule
    of chip_smoke.py), and the Hamming kernel launched on the card."""
    from defslam_tpu_torch import cli
    from defslam_tpu_torch.tools import make_synth_dataset

    data = tmp_path / "seq"
    make_synth_dataset.main([str(data), "--frames", "8", "--width", "160", "--height", "120"])
    settings = (data / "settings.yaml").read_text()
    rows = {}
    for device in ("cuda", "cpu"):
        y = tmp_path / f"{device}.yaml"
        y.write_text(settings.replace(str(data / "out"), str(tmp_path / device))
                     + "ORBextractor.nFeatures: 300\n")
        before = dict(cuda_build.LAUNCHES)
        assert cli.main(["stereo", str(y), str(data), "--start", "0", "--device", device]) == 0
        if device == "cuda":
            assert cuda_build.LAUNCHES["hamming_matrix"] > before.get("hamming_matrix", 0)
        rows[device] = [r.split() for r in (tmp_path / device / "Matches.txt").read_text()
                        .splitlines()]
    assert len(rows["cuda"]) == len(rows["cpu"]) == 8
    for g, c in zip(rows["cuda"], rows["cpu"]):
        assert g[0] == c[0] and g[3:] == c[3:], (g, c)
        for k in (1, 2):
            assert abs(int(g[k]) - int(c[k])) <= max(1, 0.02 * int(c[k])), (g, c)
    assert all(r[-1] == "OK" for r in rows["cuda"])


@pytest.mark.cuda
def test_rigid_system_on_the_card_gives_the_cpu_run(cuda_device):
    """The rigid mode's run of tests/test_torch_rigid_system.py (320x240,
    14 frames of a static scene) on ``cuda`` against ``device="cpu"``:
    states and the initialization frame equal, keyframe counts equal,
    point counts within 2% and poses within 1e-3 (a 1e-7 perturbation of
    the map after the initialization moves the CPU run's pose 1.5e-4 by
    frame 13), and the Hamming kernel launched on every tracked frame."""
    from defslam_tpu_torch.config import CapacityConfig, Config, OrbConfig, TrackingConfig
    from defslam_tpu_torch.io.synthetic import make_sequence
    from defslam_tpu_torch.rigid.system import RigidSystem

    seq = make_sequence(n_frames=14, height=240, width=320, max_amp=0.0, camera_motion=0.5, seed=3)
    cfg = Config(camera=seq.camera, orb=OrbConfig(n_features=600, n_levels=4, max_keypoints=768),
                 tracking=TrackingConfig(keyframe_period=4),
                 capacity=CapacityConfig(max_map_points=2048, max_keyframes=8))
    rows = {}
    for device in ("cuda", "cpu"):
        s = RigidSystem(cfg, device=device)
        before = cuda_build.LAUNCHES.get("hamming_matrix", 0)
        out = []
        for t in range(14):
            p = s.track_monocular(seq.frames[t], float(t))
            out.append((s.state.name, p, int(s.points.valid.sum()), int(s.kfs.valid.sum())))
        if device == "cuda":
            tracked = sum(p is not None for _, p, _, _ in out) - 1
            assert cuda_build.LAUNCHES["hamming_matrix"] - before >= tracked
        rows[device] = out
    for g, c in zip(rows["cuda"], rows["cpu"]):
        assert g[0] == c[0] and g[3] == c[3]
        assert (g[1] is None) == (c[1] is None)
        if g[1] is not None:
            assert np.abs(g[1] - c[1]).max() <= 1e-3
        assert abs(g[2] - c[2]) <= 0.02 * c[2]
    assert rows["cuda"][-1][0] == "OK"


@pytest.fixture
def last_card(cuda_device):
    """The last visible card, with cuda:0 current; skips with one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards: the last one runs while cuda:0 is current")
    assert torch.cuda.current_device() == 0
    return torch.device("cuda", n - 1)


@pytest.mark.cuda
def test_tracking_slice_on_the_last_card_equals_card_0(last_card):
    """The small System (8 frames, 160x120, synchronous, keyframes at 0 and
    4) on the last card, the process current on cuda:0, gives card 0's run
    bit for bit; B1 and B2 launch on that card."""
    runs = {}
    for dev in (torch.device("cuda", 0), last_card):
        s, frames = _small_pipelined_system(dev, keyframe_period=4, pipelined=False)
        before = dict(cuda_build.LAUNCHES)
        for t, f in enumerate(frames):
            s.track_monocular(f, float(t))
        s.flush()
        assert s.device == dev and s.pose.device == dev
        launched = {k: cuda_build.LAUNCHES[k] - before.get(k, 0) for k in cuda_build.LAUNCHES}
        assert launched["hamming_matrix"] >= 7 and launched["windowed_match"] == 2
        runs[dev.index] = (s._metrics, [T for _, T in s.trajectory])
    assert torch.cuda.current_device() == 0
    (rows0, traj0), (rows1, traj1) = runs[0], runs[last_card.index]
    assert rows1 == rows0 and [r["state"] for r in rows0] == ["OK"] * 8
    assert all(np.array_equal(a, b) for a, b in zip(traj0, traj1))


@pytest.mark.cuda
def test_readback_on_the_last_card(last_card):
    """``utils.Readback`` of tensors on the last card while cuda:0 is
    current: the event is that card's, and the values arrive."""
    from defslam_tpu_torch.utils import Readback

    x = torch.arange(1000, dtype=torch.int32, device=last_card)
    y = torch.randn(4, 4, device=last_card)
    rb = Readback.start((x, y))
    a, b = rb.get()
    assert rb.ready() and torch.cuda.current_device() == 0
    assert np.array_equal(a, np.arange(1000)) and np.array_equal(b, y.cpu().numpy())


@pytest.mark.cuda
def test_graph_timing_captures_on_the_last_card(last_card):
    """``chip_smoke.cuda_graph_ms`` with the last card current captures its
    launches there: 20 B1 launches at 2048x1536 take at least the kernel's
    bound (0.0038 ms each); an empty graph replays in ~0.0005."""
    from chip_smoke import cuda_graph_ms

    rng = np.random.default_rng(3)
    a, b = (torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32), device=last_card)
            for n in (2048, 1536))
    out = torch.empty((2048, 1536), dtype=torch.int32, device=last_card)
    with torch.cuda.device(last_card):
        before = cuda_build.LAUNCHES["hamming_matrix"]
        ms = cuda_graph_ms(lambda: hamming.hamming_matrix(a, b, out=out))
    assert ms > 0.0038 and cuda_build.LAUNCHES["hamming_matrix"] > before
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))
