"""Two processes, one gloo group: the port's counterpart of
``tests/test_multihost.py``.

Each process is a rank of ``parallel.init_distributed`` (a ``file://``
rendezvous in the test's temporary directory, no port), and the
observation-sharded SfT solve all-reduces its normal-equation blocks
across the process boundary.  The two ranks must return bit-equal
replicated results, within 1e-4 (pose) and 5e-4 (nodes) of the JAX
package's single-process ``sft.solve`` on the same problem, as in the JAX
test.  The workers are this file run as a script (``python
tests/test_torch_multihost.py rank rendezvous outdir``); they import no JAX.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from defslam_tpu_torch import parallel
from defslam_tpu_torch.config import Config, ParallelConfig, SfTConfig
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.parallel import sharded
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import sft

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


def _toy_sft_data(n_obs: int = 64, mesh_nodes: int = 10) -> sft.SfTData:
    """``__graft_entry__._toy_sft_data`` in the port: a plane template, n_obs
    random embedded points seen from the identity pose with 0.5 px noise."""
    topo = meshmod.grid_topology(mesh_nodes, mesh_nodes)
    dom = torch.tensor([-0.4, 0.4, -0.3, 0.3])
    nodes = meshmod.grid_nodes_from_surface(
        lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1), dom, topo)
    tmpl = meshmod.make_template(nodes, topo)
    rng = np.random.default_rng(0)
    uvp = torch.as_tensor(np.stack([rng.uniform(-0.38, 0.38, n_obs),
                                    rng.uniform(-0.28, 0.28, n_obs)], 1), dtype=torch.float32)
    facet, bary, _ = meshmod.embed_uv(uvp, dom, topo)
    K = torch.tensor([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    pts = meshmod.facet_positions(nodes, topo, facet, bary)
    obs_uv = cam.project(K, pts) + torch.as_tensor(rng.normal(0, 0.5, (n_obs, 2)),
                                                   dtype=torch.float32)
    return sft.data_from_template(tmpl, K, torch.eye(4), obs_uv=obs_uv, obs_face=facet,
                                  obs_bary=bary, obs_invsigma2=torch.ones(n_obs),
                                  obs_mask=torch.ones(n_obs, dtype=torch.bool),
                                  n_kp=float(n_obs))


def _worker(rank: int, rdv: str, outdir: str) -> None:
    torch.set_num_threads(1)
    cfg = Config(sft=SfTConfig(lm_iterations=5),
                 parallel=ParallelConfig(enabled=True, coordinator=f"file://{rdv}",
                                         num_processes=2, process_id=rank))
    assert parallel.init_distributed(cfg, "cpu", timeout=120)
    try:
        group = sharded.make_group(2)
        assert (group.size, group.rank) == (2, rank)
        res = sharded.sft_solve_sharded(group, _toy_sft_data(), cfg)
        assert torch.isfinite(res.T).all() and torch.isfinite(res.nodes).all()
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), T=res.T.numpy(),
                 nodes=res.nodes.numpy(), inlier=res.inlier.numpy(), chi2=res.chi2.numpy())
    finally:
        parallel.shutdown()


def test_two_process_sharded_sft(tmp_path):
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _toy_sft_data as jax_toy_sft_data
    from defslam_tpu.config import Config as JConfig
    from defslam_tpu.config import SfTConfig as JSfTConfig
    from defslam_tpu.template import mesh as jmesh
    from defslam_tpu.tracking import sft as jsft

    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(tmp_path / "rdv"),
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    r0, r1 = (dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1))
    for k in r0:  # both ranks hold the identical replicated solution
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    # the port's toy problem is the JAX package's, to float32 rounding
    ours = _toy_sft_data()
    theirs = jax_toy_sft_data(n_obs=64)
    for f in sft.SfTData._fields:
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)),
                                   atol=1e-4, err_msg=f)
    # and the two-process solve is the JAX package's single-process one
    cfg = JConfig(sft=JSfTConfig(lm_iterations=5))
    d = jsft.SfTData(**{f: jnp.asarray(getattr(ours, f).numpy()) for f in sft.SfTData._fields})
    d = d._replace(obs_face=d.obs_face.astype(jnp.int32))
    ref = jsft.solve(d, jmesh.grid_topology(10, 10), cfg)
    np.testing.assert_allclose(r0["T"], np.asarray(ref.T), atol=1e-4)
    np.testing.assert_allclose(r0["nodes"], np.asarray(ref.nodes), atol=5e-4)
    assert (r0["inlier"] == np.asarray(ref.inlier)).mean() > 0.99


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
