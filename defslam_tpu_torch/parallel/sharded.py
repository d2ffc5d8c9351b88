"""The group of ranks and the sharded solvers.

Port of ``defslam_tpu/parallel/sharded.py``.  The JAX package shards over
a ``jax.sharding.Mesh`` axis "dp"; here the axis is the ranks of a
``torch.distributed`` group, one device per process (:class:`Group`).
Each rank takes the contiguous share ``[rank * n / world, (rank + 1) * n /
world)`` of the sharded axis, as the mesh's ``P("dp")`` does:

- **Mapping**: warp fits over the covisible pairs and the per-point normal
  solves are independent per pair and per point.  Each rank solves its
  share and the full result is gathered onto every rank.
- **SfT**: a Levenberg-Marquardt whose observation rows are sharded.  Each
  rank assembles its rows' normal-equation blocks (``sft._obs_normal_eq_impl``);
  the six blocks travel as one flat buffer in one all-reduce per
  iteration, the robust cost in one per evaluation, and ``sft._prepare``'s
  viewed-node counts in one per stage.  The regularizer terms, the damped
  solve and the accept/reject step are replicated: every rank computes
  them from the same reduced values, so they are bit-equal across ranks
  (the CPU's early exit depends on them).  For templates of 256 or more
  nodes the damped solve is node-partitioned (a Schur reduction onto the
  camera and the strip boundaries, :func:`_schur_solve`).

Gathers write each rank's share into a zero-filled full buffer and sum it
with one all-reduce: exact (x + 0 = x), and the one collective that NCCL
and gloo both offer for CUDA and CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.mapping import normals as nrm
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import sft as sftmod

# The sharded LM's convergence test, copied from the JAX package's sharded
# solver (its single-device solver uses cfg.sft.lm_rtol, 1e-5).
SHARDED_RTOL = 1e-6
SFT_OBS_FIELDS = ("obs_uv", "obs_face", "obs_bary", "obs_invsigma2", "obs_mask")


class Group:
    """The ranks that share the sharded work: the default process group.
    Counts its all-reduce calls and the bytes they carry, and feeds the
    tracer's counter ``parallel.all_reduce`` with them."""

    def __init__(self):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.n_all_reduce = 0
        self.all_reduce_bytes = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t)
        nbytes = t.numel() * t.element_size()
        self.n_all_reduce += 1
        self.all_reduce_bytes += nbytes
        profiling.count("parallel.all_reduce", nbytes)
        return t

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of an axis of length n."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not divide over {self.size} ranks: pad it")
        s = n // self.size
        return self.rank * s, (self.rank + 1) * s

    def gather_rows(self, parts, n: int) -> list[torch.Tensor]:
        """The full (n, ...) tensors from every rank's share ``parts`` (rows
        ``rows(n)``), in their dtypes, in one all-reduce of float64 (exact
        for float32, bool and integers below 2**53)."""
        lo, hi = self.rows(n)
        bufs = []
        for p in parts:
            full = torch.zeros((n,) + tuple(p.shape[1:]), dtype=torch.float64, device=p.device)
            full[lo:hi] = p
            bufs.append(full.reshape(-1))
        flat = self.all_reduce(torch.cat(bufs))
        out, off = [], 0
        for p, b in zip(parts, bufs):
            out.append(flat[off:off + b.numel()].reshape((n,) + tuple(p.shape[1:])).to(p.dtype))
            off += b.numel()
        return out


def make_group(n_devices: int = 0) -> Group:
    """The group over the default process group (``parallel.init_distributed``
    brings it up).  ``n_devices`` 0 means the whole world; any other value
    must equal the world size: there is no fall-back onto other devices."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    world = dist.get_world_size()
    if n_devices not in (0, world):
        raise ValueError(f"parallel.n_devices={n_devices}, but the world has {world} ranks "
                         "(one device per process)")
    return Group()


# ------------------------------------------------------- mapping sharding --


def sharded_normal_solves(group: Group, obs: nrm.PairObs, k_init: torch.Tensor,
                          num_iters: int = 30) -> nrm.NormalResult:
    """Per-point normal solves sharded over the point axis."""
    p = k_init.shape[0]
    lo, hi = group.rows(p)
    r = nrm.solve_k1k2(nrm.PairObs(*(a[lo:hi] for a in obs)), k_init[lo:hi],
                       num_iters=num_iters)
    return nrm.NormalResult(*group.gather_rows(list(r), p))


def sharded_warp_fits(group: Group, batch: mapper.WarpBatch, dom: torch.Tensor,
                      bending: torch.Tensor, cfg: Config):
    """Warp fits sharded over the pair axis; the domain and the bending
    matrix are replicated.  Returns (DiffProps, ctrl) as
    ``mapper.fit_warps``."""
    n = batch.pair_valid.shape[0]
    lo, hi = group.rows(n)
    dps, ctrl = mapper.fit_warps(mapper.WarpBatch(*(a[lo:hi] for a in batch)), dom, bending, cfg)
    *full, ctrl = group.gather_rows(list(dps) + [ctrl], n)
    return type(dps)(*full), ctrl


# ----------------------------------------------------------- sharded SfT --


@functools.lru_cache(maxsize=8)
def _node_partition_np(nu: int, nv: int, n_dev: int):
    if nu % n_dev:
        raise ValueError("nodes_u must divide over the ranks")
    s = nu // n_dev
    if s < 2 and n_dev > 1:
        raise ValueError("the Schur partition needs >= 2 u-rows per rank")
    ni_max = 3 * s * nv  # strip 0: all s rows are interior
    interior = np.zeros((n_dev, ni_max), np.int64)
    valid = np.zeros((n_dev, ni_max), bool)
    iface_nodes = []
    for d in range(n_dev):
        rows = range(d * s, (d + 1) * s)
        if d > 0:
            iface_nodes.extend(d * s * nv + np.arange(nv))
            rows = range(d * s + 1, (d + 1) * s)
        nodes = np.concatenate([u * nv + np.arange(nv) for u in rows])
        params = (6 + 3 * nodes[:, None] + np.arange(3)).reshape(-1)
        interior[d, :len(params)] = params
        valid[d, :len(params)] = True
    iface_nodes = np.asarray(iface_nodes, np.int64)
    iface = np.concatenate([np.arange(6),
                            (6 + 3 * iface_nodes[:, None] + np.arange(3)).reshape(-1)])
    return interior, valid, iface


def _node_partition(nu: int, nv: int, n_dev: int, device):
    """Static u-strip partition of the (nu x nv) node grid for the Schur
    solve, as the JAX package's: rank d owns the u-rows [d*s, (d+1)*s); the
    first row of every strip d > 0 is interface (with the 6 camera
    parameters), the other rows are that rank's interior.  Returns
    (interior parameter index (D, Ni) int64, its validity (D, Ni) bool,
    interface parameter index (Nb,) int64) in the 6 + 3M numbering,
    interiors padded to the widest strip."""
    return tuple(torch.as_tensor(a, device=device) for a in _node_partition_np(nu, nv, n_dev))


def _schur_solve(A: torch.Tensor, g: torch.Tensor, part, group: Group) -> torch.Tensor:
    """The SPD solve A x = g by non-overlapping block elimination, as the
    JAX package's: each rank factors its interior block and reduces it onto
    the interface system, the summed interface system is solved
    replicated, and the interiors back-substitute locally.  The couplings
    between different ranks' interiors are dropped: the solve is exact only
    without them, and the curvature term's 1-ring around an interface node
    does couple the rows on both sides of it, so inside the LM this is an
    approximate step that the accept test screens.  A failed factor puts
    NaN in the rank's share, so the caller's finiteness test rejects the
    step on every rank alike."""
    ii_all, vi_all, bi = part
    ii, vi = ii_all[group.rank], vi_all[group.rank]
    n, ni = g.shape[0], ii.shape[0]
    eye = torch.eye(ni, dtype=A.dtype, device=A.device)
    Aii = torch.where(vi[:, None] & vi[None, :], A[ii][:, ii], eye)
    Aib = torch.where(vi[:, None], A[ii][:, bi], torch.zeros((), dtype=A.dtype, device=A.device))
    gi = torch.where(vi, g[ii], torch.zeros_like(g[ii]))
    L, info = torch.linalg.cholesky_ex(Aii)
    Y = torch.cholesky_solve(torch.cat([Aib, gi[:, None]], dim=1), L)
    Yb, yg = Y[:, :-1], Y[:, -1]
    nb = bi.shape[0]
    red = group.all_reduce(torch.cat([(Aib.T @ Yb).reshape(-1), Aib.T @ yg]))
    S = A[bi][:, bi] - red[:nb * nb].reshape(nb, nb)
    rhs = g[bi] - red[nb * nb:]
    Lb, info_b = torch.linalg.cholesky_ex(S)
    xb = torch.cholesky_solve(rhs[:, None], Lb)[:, 0]
    xi = torch.cholesky_solve((gi - Aib @ xb)[:, None], L)[:, 0]
    xi = torch.where(vi & (info == 0), xi, torch.where(vi, float("nan"), 0.0))
    buf = torch.zeros(n + 1, dtype=A.dtype, device=A.device)
    buf[torch.where(vi, ii, n)] = xi
    x = group.all_reduce(buf[:n].contiguous())
    x[bi] = x[bi] + xb
    return torch.where(info_b == 0, x, torch.full_like(x, float("nan")))


def _chi2_facets(T, nodes, data: sftmod.SfTData, topo) -> torch.Tensor:
    """Per-observation chi2 through the facet embedding (the JAX package's
    sharded solver does not use the blend matrix here)."""
    pw = meshmod.facet_positions(nodes, topo, data.obs_face, data.obs_bary)
    uv = cam.project(data.K, se3.transform(T, pw))
    return torch.sum((uv - data.obs_uv) ** 2, dim=-1) * data.obs_invsigma2


def _reduce_blocks(group: Group, blocks):
    """The observation blocks summed over the ranks in one all-reduce."""
    flat = group.all_reduce(torch.cat([b.reshape(-1) for b in blocks]))
    out, off = [], 0
    for b in blocks:
        out.append(flat[off:off + b.numel()].reshape(b.shape))
        off += b.numel()
    return out


def _lm_stage(group: Group, data: sftmod.SfTData, topo, cfg: Config, reg_temp: float,
              iters: int, part):
    """One LM stage over this rank's observation rows, from (data.T0,
    data.nodes0): ``iters`` trips, the state frozen once done (the CPU
    stops there).  Returns (T, nodes, cost), replicated."""
    sc = cfg.sft
    m = data.nodes0.shape[0]
    pre = sftmod._prepare(data, topo, cfg, reg_temp, reduce=group.all_reduce)

    def cost_at(T, nodes):
        c_o = group.all_reduce(sftmod.obs_cost(T, nodes, data, pre, sc.huber_delta).reshape(1))
        return c_o[0] + sftmod.reg_cost(nodes, data, pre)

    T, nodes = data.T0, data.nodes0
    cost = cost_at(T, nodes)
    dev = nodes.device
    lam = torch.full((), sc.lm_lambda_init, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        H_cc, H_cn, H_nn_o, g_c, g_n_o, _c = _reduce_blocks(
            group, sftmod._obs_normal_eq_impl(T, nodes, data, pre, sc.huber_delta))
        H_nn_r, g_n_r, _c = sftmod.reg_normal_eq(nodes, data, pre)
        H, g = sftmod.dense_system(H_cc, H_cn, H_nn_o + H_nn_r, g_c, g_n_o + g_n_r, pre)
        A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        if part is not None:
            dx = -_schur_solve(A, g, part, group)
        else:
            L, info = torch.linalg.cholesky_ex(A)
            dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
            dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        T_new = se3.se3_exp(dx[:6]) @ T
        nodes_new = nodes + dx[6:].reshape(m, 3)
        c_new = cost_at(T_new, nodes_new)
        accept = (c_new < cost) & torch.isfinite(c_new)
        converged = accept & (cost - c_new <= SHARDED_RTOL * (cost + 1e-30))
        live = ~done
        take = live & accept
        T = torch.where(take, T_new, T)
        nodes = torch.where(take, nodes_new, nodes)
        cost = torch.where(take, c_new, cost)
        lam_new = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              sc.lm_lambda_min, sc.lm_lambda_max)
        lam = torch.where(live, lam_new, lam)
        done = done | (live & (converged | (lam_new >= sc.lm_lambda_max)))
        if dev.type == "cpu" and bool(done):  # replicated: every rank leaves together
            break
    return T, nodes, cost


def sft_solve_sharded(group: Group, data: sftmod.SfTData, cfg: Config,
                      num_iters: int | None = None,
                      reg_temp: float | None = None) -> sftmod.SfTResult:
    """The two-stage robust SfT of ``sft.solve`` with the observation rows
    sharded over the group: the full robust solve, the chi2 gate on each
    rank's rows, a short polish on the gated inliers.  ``data`` is the
    whole problem on every rank; each takes its rows.  The result is
    replicated, its per-observation inlier and chi2 gathered back to the
    full observation axis.  Differences from ``sft.solve``, copied from the
    JAX package's sharded solver: the convergence test (SHARDED_RTOL) and
    the chi2 through the facet embedding."""
    c = cfg
    n = data.obs_uv.shape[0]
    lo, hi = group.rows(n)
    d = data._replace(**{f: getattr(data, f)[lo:hi] for f in SFT_OBS_FIELDS})
    topo = meshmod.grid_topology(c.mesh.nodes_u, c.mesh.nodes_v)
    iters = num_iters or c.sft.lm_iterations
    rt = c.regularizer.temporal if reg_temp is None else reg_temp
    use_schur = (group.size > 1 and c.mesh.n_nodes >= 256 and c.mesh.nodes_u % group.size == 0
                 and c.mesh.nodes_u // group.size >= 2)
    part = (_node_partition(c.mesh.nodes_u, c.mesh.nodes_v, group.size, data.nodes0.device)
            if use_schur else None)
    thr = c.sft.chi2_threshold

    T1, nodes1, _ = _lm_stage(group, d, topo, c, rt, iters, part)
    inlier = d.obs_mask & (_chi2_facets(T1, nodes1, d, topo) <= thr)
    d2 = d._replace(T0=T1, nodes0=nodes1, obs_mask=inlier)
    T2, nodes2, cost = _lm_stage(group, d2, topo, c, rt, max(iters // 5, 5), part)
    chi2f = _chi2_facets(T2, nodes2, d, topo)
    inlier_f, chi2_full = group.gather_rows([d.obs_mask & (chi2f <= thr), chi2f], n)
    return sftmod.SfTResult(T=T2, nodes=nodes2, inlier=inlier_f, chi2=chi2_full, cost=cost)
