"""Shape-from-Template: joint camera + mesh deformation solve.

Port of ``defslam_tpu/tracking/sft.py`` (the reference's
``Optimizer::DefPoseOptimization``, DefOptimizer.cc:251-578): barycentric
reprojection of every observed template-embedded map point (Huber delta
sqrt(5.991) on the sqrt(invSigma2)-weighted pixel error, information
normalized by the frame's keypoint count), mean-curvature preservation,
edge inextensibility and a temporal anchor to the rest shape, with only the
LocalZone nodes free.

The normal equations are assembled from analytic per-term blocks through
the same dense blend matrix ``bmat`` and one-hot ring/edge maps as the JAX
package: plain matmuls, no scatter-add, so the sums are deterministic on
the GPU (``index_add_`` on CUDA floats is not).  The dense (6+3M) system is
solved by Cholesky each LM iteration.

The LM loop runs a fixed trip count whose state freezes once it is done
(converged, or lambda at its cap): the same iterates as the reference's
early-exit while-loop, without a host sync per iteration on the GPU.  On
the CPU the loop stops at ``done``, which changes nothing but time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.template import mesh as meshmod


class SfTData(NamedTuple):
    """Static-shape inputs of one SfT solve."""

    K: torch.Tensor  # (3, 3) intrinsics
    T0: torch.Tensor  # (4, 4) initial world->camera pose
    nodes0: torch.Tensor  # (M, 3) initial node positions
    nodes_rest: torch.Tensor  # (M, 3) rest shape (EdgesReference anchor)
    rest_len: torch.Tensor  # (E,)
    lap_rest: torch.Tensor  # (M,)
    lap_w: torch.Tensor  # (M, R)
    curv_scale: torch.Tensor  # (M,)
    interior: torch.Tensor  # (M,) bool
    mean_edge: torch.Tensor  # () median rest edge length
    obs_uv: torch.Tensor  # (N, 2) observed pixels
    obs_face: torch.Tensor  # (N,) facet id of the observed map point
    obs_bary: torch.Tensor  # (N, 3)
    obs_invsigma2: torch.Tensor  # (N,) per-level information
    obs_mask: torch.Tensor  # (N,) bool
    n_kp: torch.Tensor  # () frame keypoint count (pFrame->N)


class SfTResult(NamedTuple):
    T: torch.Tensor  # (4, 4) optimized pose
    nodes: torch.Tensor  # (M, 3) optimized mesh
    inlier: torch.Tensor  # (N,) bool chi2 gate
    chi2: torch.Tensor  # (N,) per-observation chi2 at the solution
    cost: torch.Tensor


def data_from_template(tmpl: meshmod.Template, K, T0, obs_uv, obs_face, obs_bary,
                       obs_invsigma2, obs_mask, n_kp=None) -> SfTData:
    if n_kp is None:
        n_kp = obs_mask.sum()
    return SfTData(
        K=K, T0=T0, nodes0=tmpl.nodes, nodes_rest=tmpl.nodes_rest,
        rest_len=tmpl.rest_len, lap_rest=tmpl.lap_rest, lap_w=tmpl.lap_w,
        curv_scale=tmpl.curv_scale, interior=tmpl.interior,
        mean_edge=tmpl.mean_edge, obs_uv=obs_uv, obs_face=obs_face,
        obs_bary=obs_bary, obs_invsigma2=obs_invsigma2, obs_mask=obs_mask,
        n_kp=torch.as_tensor(n_kp, dtype=torch.float32, device=obs_uv.device),
    )


class _Pre(NamedTuple):
    """Per-solve constants (masks, index tables, folded weights)."""

    fcorners: torch.Tensor  # (N, 3) node ids of each observation's facet
    ringx: torch.Tensor  # (M, 1+R) [self | ring]
    e0: torch.Tensor  # (E,)
    e1: torch.Tensor
    viewed: torch.Tensor  # (M,) bool
    optlap: torch.Tensor  # (M,) bool — free nodes
    w_obs_base: torch.Tensor  # (N,)
    c_lap: torch.Tensor  # (M,)
    c_edge: torch.Tensor  # (E,)
    c_temp: torch.Tensor  # ()
    col_free: torch.Tensor  # (6+3M,)
    sw: torch.Tensor  # (M,) sum of lap weights
    oh_ring: torch.Tensor  # (M, 1+R, M) ring slot -> node
    oh_ev: torch.Tensor  # (E, 2, M) edge endpoint -> node
    bmat: torch.Tensor  # (N, M) dense barycentric blend


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as a true division (``scalar / tensor`` in torch is a
    reciprocal times the scalar, which rounds differently)."""
    return torch.full_like(den, num) / den


def _blend(obs_face, obs_bary, topo: meshmod.MeshTopology, m: int):
    faces = meshmod.topo_tensor(topo, "faces", obs_bary)
    fcorners = faces[torch.clamp(obs_face, 0, topo.faces.shape[0] - 1)]
    bmat = torch.einsum("nk,nkm->nm", obs_bary, F.one_hot(fcorners, m).float())
    return fcorners, bmat


def _prepare(data: SfTData, topo: meshmod.MeshTopology, cfg: Config,
             reg_temp: float) -> _Pre:
    reg = cfg.regularizer
    nodes0 = data.nodes0
    m = nodes0.shape[0]
    ring = meshmod.topo_tensor(topo, "ring", nodes0)
    ring_mask = meshmod.topo_tensor(topo, "ring_mask", nodes0)
    edges = meshmod.topo_tensor(topo, "edges", nodes0)
    fcorners, bmat = _blend(data.obs_face, data.obs_bary, topo, m)
    touched = torch.zeros(m, dtype=torch.int32, device=nodes0.device)
    touched.index_add_(
        0, fcorners.reshape(-1), data.obs_mask.to(torch.int32).repeat_interleave(3)
    )
    viewed = touched > 0
    optlap = viewed
    for _ in range(max(int(reg.local_zone), 0)):
        optlap = optlap | (optlap[ring] & ring_mask).any(dim=1)

    n_optlap = torch.clamp(optlap.sum(), min=1).float()
    c_lap = torch.sqrt(_div(reg.laplacian, n_optlap)) * data.curv_scale * (
        optlap & data.interior
    )
    e0, e1 = edges[:, 0], edges[:, 1]
    edge_act = optlap[e0] | optlap[e1]
    n_edge = torch.clamp(edge_act.sum(), min=1).float()
    c_edge = torch.sqrt(_div(reg.inextensibility, n_edge)) * edge_act
    c_temp = torch.sqrt(torch.full((), reg_temp, dtype=torch.float32, device=nodes0.device)) / (
        torch.clamp(data.mean_edge, min=1e-9)
    )
    w_obs_base = torch.sqrt(
        data.obs_invsigma2 / torch.clamp(data.n_kp, min=1.0)
    ) * data.obs_mask
    ringx = torch.cat([torch.arange(m, device=nodes0.device)[:, None], ring], dim=1)
    col_free = torch.cat(
        [torch.ones(6, device=nodes0.device), optlap.float().repeat_interleave(3)]
    )
    return _Pre(
        fcorners=fcorners, ringx=ringx, e0=e0, e1=e1, viewed=viewed,
        optlap=optlap, w_obs_base=w_obs_base, c_lap=c_lap, c_edge=c_edge,
        c_temp=c_temp, col_free=col_free,
        sw=torch.clamp(data.lap_w.sum(dim=1), min=1e-12),
        oh_ring=F.one_hot(ringx, m).float(),
        oh_ev=F.one_hot(edges, m).float(),
        bmat=bmat,
    )


def _project_obs(T, nodes, data: SfTData, pre: _Pre, huber_delta: float):
    """Weighted reprojection residuals and their Huber weights."""
    pc = se3.transform(T, pre.bmat @ nodes)
    z = pc[:, 2]
    front = z > 1e-6
    zs = torch.where(front, z, torch.ones_like(z))
    fx, fy = data.K[0, 0], data.K[1, 1]
    u = fx * pc[:, 0] / zs + data.K[0, 2]
    v = fy * pc[:, 1] / zs + data.K[1, 2]
    w_o = pre.w_obs_base * front
    r2 = (torch.stack([u, v], dim=-1) - data.obs_uv) * w_o[:, None]
    sq = torch.sum(r2 * r2, dim=-1)
    nrm = torch.sqrt(sq + 1e-12) * torch.sqrt(torch.clamp(data.n_kp, min=1.0))
    hub = torch.clamp(_div(huber_delta, nrm), max=1.0)
    return pc, zs, w_o, r2, sq, hub


def obs_cost(T, nodes, data: SfTData, pre: _Pre, huber_delta: float):
    """Robust observation cost at (T, nodes) (no Jacobians)."""
    *_, sq, hub = _project_obs(T, nodes, data, pre, huber_delta)
    return 0.5 * torch.sum(hub * sq)


def reg_terms(nodes, data: SfTData, pre: _Pre):
    """Regularizer residuals + analytic blocks: (r_curv (M,), Jc (M,1+R,3),
    r_edge (E,), Je (E,2,3), r_temp (M,3), tw (M,))."""
    m = nodes.shape[0]
    zc = torch.einsum("mr,mrd->md", data.lap_w, nodes[pre.ringx[:, 1:]]) / pre.sw[:, None]
    dvec = nodes - zc
    dn = torch.linalg.norm(dvec, dim=-1)
    r_curv = pre.c_lap * (dn - data.lap_rest)
    jfac = torch.where(dn > 1e-15, 1.0 / torch.clamp(dn, min=1e-15), torch.zeros_like(dn))
    dhat = dvec * jfac[:, None]
    coef = torch.cat(
        [torch.ones((m, 1), device=nodes.device), -(data.lap_w / pre.sw[:, None])], dim=1
    )
    Jc = (pre.c_lap[:, None] * coef)[:, :, None] * dhat[:, None, :]

    dv_e = nodes[pre.e0] - nodes[pre.e1]
    ln = torch.linalg.norm(dv_e, dim=-1)
    r_edge = pre.c_edge * (ln / data.rest_len - 1.0)
    ue = dv_e * (pre.c_edge / (torch.clamp(ln, min=1e-12) * data.rest_len))[:, None]
    Je = torch.stack([ue, -ue], dim=1)

    tw = pre.c_temp * pre.viewed.float()
    r_temp = tw[:, None] * (nodes - data.nodes_rest)
    return r_curv, Jc, r_edge, Je, r_temp, tw


def reg_cost(nodes, data: SfTData, pre: _Pre):
    r_curv, _, r_edge, _, r_temp, _ = reg_terms(nodes, data, pre)
    return 0.5 * (
        torch.sum(r_curv * r_curv) + torch.sum(r_edge * r_edge) + torch.sum(r_temp * r_temp)
    )


def _block_diag_eye(w: torch.Tensor) -> torch.Tensor:
    """(M,) -> (M, M, 3, 3) with w_i * I3 on the diagonal blocks."""
    m = w.shape[0]
    eye_m = torch.eye(m, dtype=w.dtype, device=w.device)
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device)
    return (w[:, None] * eye_m)[:, :, None, None] * eye3[None, None]


def reg_normal_eq(nodes, data: SfTData, pre: _Pre):
    """Regularizer contribution: (H_nn (M,M,3,3), g_n (M,3), cost ())."""
    r_curv, Jc, r_edge, Je, r_temp, tw = reg_terms(nodes, data, pre)
    Or = pre.oh_ring
    cH = Jc[:, :, None, :, None] * Jc[:, None, :, None, :]  # (M,A,A,3,3)
    t1 = torch.einsum("mai,mabkl->mibkl", Or, cH)
    H_nn = torch.einsum("mbj,mibkl->ijkl", Or, t1)
    g_n = torch.einsum("mai,max->ix", Or, Jc * r_curv[:, None, None])

    Oe = pre.oh_ev
    eH = Je[:, :, None, :, None] * Je[:, None, :, None, :]  # (E,2,2,3,3)
    t2 = torch.einsum("eai,eabkl->eibkl", Oe, eH)
    H_nn = H_nn + torch.einsum("ebj,eibkl->ijkl", Oe, t2)
    g_n = g_n + torch.einsum("eai,eax->ix", Oe, Je * r_edge[:, None, None])

    H_nn = H_nn + _block_diag_eye(tw**2)
    g_n = g_n + tw[:, None] * r_temp
    cost = 0.5 * (
        torch.sum(r_curv * r_curv) + torch.sum(r_edge * r_edge) + torch.sum(r_temp * r_temp)
    )
    return H_nn, g_n, cost


def dense_system(H_cc, H_cn, H_nn, g_c, g_n, pre: _Pre):
    """Blocks -> pinned dense (6+3M, 6+3M) system: fixed (non-LocalZone)
    node coordinates get zeroed rows/columns and a unit diagonal."""
    m = g_n.shape[0]
    nf = pre.optlap.to(g_n.dtype)
    H_nn = H_nn * nf[:, None, None, None] * nf[None, :, None, None]
    H_nn = H_nn + _block_diag_eye(1.0 - nf)
    H_cn = H_cn * nf[:, None, None]
    g_n = g_n * nf[:, None]
    d = 6 + 3 * m
    H = torch.zeros((d, d), dtype=g_n.dtype, device=g_n.device)
    H[:6, :6] = H_cc
    Hcn = H_cn.permute(1, 0, 2).reshape(6, 3 * m)
    H[:6, 6:] = Hcn
    H[6:, :6] = Hcn.T
    H[6:, 6:] = H_nn.permute(0, 2, 1, 3).reshape(3 * m, 3 * m)
    return H, torch.cat([g_c, g_n.reshape(-1)])


def _obs_normal_eq_impl(T, nodes, data: SfTData, pre: _Pre, huber_delta: float):
    """Observation half of the normal equations: (H_cc (6,6), H_cn (M,6,3),
    H_nn (M,M,3,3), g_c (6,), g_n (M,3), cost ()); every node-block
    reduction is a matmul against ``pre.bmat``."""
    m = nodes.shape[0]
    n = data.obs_uv.shape[0]
    pc, zs, w_o, r2, sq, hub = _project_obs(T, nodes, data, pre, huber_delta)
    cost = 0.5 * torch.sum(hub * sq)
    sh = torch.sqrt(hub)
    fx, fy = data.K[0, 0], data.K[1, 1]
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(zs)
    duv = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * pc[:, 0] * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * pc[:, 1] * iz2], dim=-1),
        ],
        dim=-2,
    ) * (w_o * sh)[:, None, None]
    Jxi = torch.cat([duv, -torch.einsum("nai,nij->naj", duv, se3.hat(pc))], dim=-1)
    B = torch.einsum("nac,cd->nad", duv, T[:3, :3])
    r2w = r2 * sh[:, None]

    H_cc = torch.einsum("nai,naj->ij", Jxi, Jxi)
    g_c = torch.einsum("nai,na->i", Jxi, r2w)
    G = torch.einsum("nai,naj->nij", B, B)
    CB = torch.einsum("nai,naj->nij", Jxi, B)
    gB = torch.einsum("nai,na->ni", B, r2w)
    Bm = pre.bmat
    BG = Bm[:, :, None] * G.reshape(n, 1, 9)
    H_nn = (Bm.T @ BG.reshape(n, m * 9)).reshape(m, m, 3, 3)
    H_cn = (Bm.T @ CB.reshape(n, 18)).reshape(m, 6, 3)
    g_n = Bm.T @ gB
    return H_cc, H_cn, H_nn, g_c, g_n, cost


def normal_equations(T, nodes, data: SfTData, topo: meshmod.MeshTopology,
                     cfg: Config, reg_temp: float):
    """(H, g, cost) of the block assembly at (T, nodes)."""
    pre = _prepare(data, topo, cfg, reg_temp)
    H_cc, H_cn, H_nn_o, g_c, g_n_o, c_o = _obs_normal_eq_impl(
        T, nodes, data, pre, cfg.sft.huber_delta
    )
    H_nn_r, g_n_r, c_r = reg_normal_eq(nodes, data, pre)
    H, g = dense_system(H_cc, H_cn, H_nn_o + H_nn_r, g_c, g_n_o + g_n_r, pre)
    return H, g, c_o + c_r


def _chi2(T, nodes, data: SfTData, bmat: torch.Tensor) -> torch.Tensor:
    uv = cam.project(data.K, se3.transform(T, bmat @ nodes))
    return torch.sum((uv - data.obs_uv) ** 2, dim=-1) * data.obs_invsigma2


def _lm(data: SfTData, topo: meshmod.MeshTopology, cfg: Config, reg_temp: float,
        iters: int):
    """Levenberg-Marquardt from (data.T0, data.nodes0): ``iters`` trips, the
    state frozen once done.  Returns (T, nodes, cost)."""
    sc = cfg.sft
    m = data.nodes0.shape[0]
    pre = _prepare(data, topo, cfg, reg_temp)

    def cost_at(T, nodes):
        return obs_cost(T, nodes, data, pre, sc.huber_delta) + reg_cost(nodes, data, pre)

    T, nodes = data.T0, data.nodes0
    cost = cost_at(T, nodes)
    dev = nodes.device
    lam = torch.full((), sc.lm_lambda_init, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        H_cc, H_cn, H_nn_o, g_c, g_n_o, _c = _obs_normal_eq_impl(
            T, nodes, data, pre, sc.huber_delta
        )
        H_nn_r, g_n_r, _c = reg_normal_eq(nodes, data, pre)
        H, g = dense_system(H_cc, H_cn, H_nn_o + H_nn_r, g_c, g_n_o + g_n_r, pre)
        A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        # cholesky_ex does not raise on a matrix that is not positive
        # definite; the step is then rejected (the reference's NaN step)
        L, info = torch.linalg.cholesky_ex(A)
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
        dx = torch.where((info == 0) & torch.isfinite(dx), dx, torch.zeros_like(dx))
        T_new = se3.se3_exp(dx[:6]) @ T
        nodes_new = nodes + dx[6:].reshape(m, 3)
        c_new = cost_at(T_new, nodes_new)
        accept = (c_new < cost) & torch.isfinite(c_new)
        converged = accept & (cost - c_new <= sc.lm_rtol * (cost + 1e-30))
        live = ~done
        take = live & accept
        T = torch.where(take, T_new, T)
        nodes = torch.where(take, nodes_new, nodes)
        cost = torch.where(take, c_new, cost)
        lam_new = torch.clamp(
            torch.where(accept, lam * 0.5, lam * 4.0), sc.lm_lambda_min, sc.lm_lambda_max
        )
        lam = torch.where(live, lam_new, lam)
        done = done | (live & (converged | (lam_new >= sc.lm_lambda_max)))
        if dev.type == "cpu" and bool(done):
            break
    return T, nodes, cost


def solve(data: SfTData, topo: meshmod.MeshTopology, cfg: Config,
          reg_temp: float | None = None) -> SfTResult:
    """Robust LM solve, chi2 outlier gate, then a short polish on the gated
    inliers (DefOptimizer.cc:509-577 plus the JAX package's polish)."""
    r_temp = cfg.regularizer.temporal if reg_temp is None else reg_temp
    thr = cfg.sft.chi2_threshold
    T1, nodes1, _ = _lm(data, topo, cfg, r_temp, cfg.sft.lm_iterations)
    _, bmat = _blend(data.obs_face, data.obs_bary, topo, data.nodes0.shape[0])
    inlier = data.obs_mask & (_chi2(T1, nodes1, data, bmat) <= thr)
    d2 = data._replace(T0=T1, nodes0=nodes1, obs_mask=inlier)
    T2, nodes2, cost = _lm(d2, topo, cfg, r_temp, max(cfg.sft.lm_iterations // 5, 5))
    chi2f = _chi2(T2, nodes2, data, bmat)
    inlier_f = data.obs_mask & (chi2f <= thr)
    return SfTResult(T=T2, nodes=nodes2, inlier=inlier_f, chi2=chi2f, cost=cost)
