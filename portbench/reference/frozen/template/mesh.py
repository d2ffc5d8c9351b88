"""Template mesh: regular triangular grid, Laplacian structure and
barycentric point embedding.

Port of ``defslam_tpu/template/mesh.py`` (the subset the tracking path
uses).  Topology depends only on the grid size and is a numpy constant;
node positions and the rest-state quantities are tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen.utils import device_constant

MAX_RING = 8  # max neighbors of a grid-with-diagonal node (interior: 6)


class MeshTopology(NamedTuple):
    """Static (numpy) topology of a nodes_u x nodes_v grid mesh."""

    faces: np.ndarray  # (F, 3) int32 node ids, CCW in (u, v) param space
    edges: np.ndarray  # (E, 2) int32 unique undirected edges
    ring: np.ndarray  # (M, MAX_RING) int32 neighbor ids (padded with 0)
    ring_mask: np.ndarray  # (M, MAX_RING) bool
    pair1: np.ndarray  # (M, MAX_RING) int32 common neighbors of (i, ring)
    pair2: np.ndarray  # (M, MAX_RING) int32
    pair_ok: np.ndarray  # (M, MAX_RING) bool — both common neighbors exist
    boundary: np.ndarray  # (M,) bool — reference setBoundary rule
    nodes_u: int
    nodes_v: int


class Template(NamedTuple):
    """State of the active template (tensors on the System's device)."""

    nodes: torch.Tensor  # (M, 3) current node positions (world)
    nodes_rest: torch.Tensor  # (M, 3) rest shape
    rest_len: torch.Tensor  # (E,) rest edge lengths
    lap_rest: torch.Tensor  # (M,) rest |mean curvature| magnitudes
    lap_w: torch.Tensor  # (M, MAX_RING) mean-value weights at rest
    curv_scale: torch.Tensor  # (M,) sqrt(sum_e 1/rest_len_e^2) per node
    interior: torch.Tensor  # (M,) bool — curvature residual applies
    mean_edge: torch.Tensor  # () median rest edge length
    valid: torch.Tensor  # () bool


@functools.lru_cache(maxsize=8)
def grid_topology(nodes_u: int, nodes_v: int) -> MeshTopology:
    """Triangulated regular grid; node id = iu * nodes_v + iv."""
    nid = lambda iu, iv: iu * nodes_v + iv  # noqa: E731
    faces = []
    edges = set()
    for iu in range(nodes_u - 1):
        for iv in range(nodes_v - 1):
            a = nid(iu, iv)
            b = nid(iu + 1, iv)
            c = nid(iu + 1, iv + 1)
            d = nid(iu, iv + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
            for e in ((a, b), (b, c), (a, c), (c, d), (a, d)):
                edges.add(tuple(sorted(e)))
    faces = np.asarray(faces, np.int32)
    edges = np.asarray(sorted(edges), np.int32)
    m = nodes_u * nodes_v
    ring_lists: list[list[int]] = [[] for _ in range(m)]
    for a, b in edges:
        ring_lists[a].append(b)
        ring_lists[b].append(a)
    ring = np.zeros((m, MAX_RING), np.int32)
    mask = np.zeros((m, MAX_RING), bool)
    for i, nbrs in enumerate(ring_lists):
        assert len(nbrs) <= MAX_RING
        ring[i, : len(nbrs)] = nbrs
        mask[i, : len(nbrs)] = True
    # common-neighbor pairs + boundary flags (LaplacianMesh.cc:75-95)
    adj = [set(nbrs) for nbrs in ring_lists]
    pair1 = np.zeros((m, MAX_RING), np.int32)
    pair2 = np.zeros((m, MAX_RING), np.int32)
    pair_ok = np.zeros((m, MAX_RING), bool)
    boundary = np.zeros(m, bool)
    for i, nbrs in enumerate(ring_lists):
        for k, j in enumerate(nbrs):
            common = sorted(adj[i] & adj[j])
            if len(common) >= 2:
                pair1[i, k], pair2[i, k] = common[0], common[1]
                pair_ok[i, k] = True
            elif len(common) == 1:
                boundary[j] = True
    return MeshTopology(
        faces=faces, edges=edges, ring=ring, ring_mask=mask, pair1=pair1,
        pair2=pair2, pair_ok=pair_ok, boundary=boundary,
        nodes_u=nodes_u, nodes_v=nodes_v,
    )


def topo_tensor(topo: MeshTopology, field: str, like: torch.Tensor) -> torch.Tensor:
    """The topology's array ``field`` on ``like``'s device (int arrays as
    int64), copied there once per grid size and device."""
    a = getattr(topo, field)
    return device_constant(("topology", topo.nodes_u, topo.nodes_v, field), lambda: a,
                           like.device, torch.int64 if a.dtype.kind in "iu" else None)


def mean_value_weights(nodes: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Per-neighbor mean-value weights (M, MAX_RING):
    w_ij = (tan(|th1|/2) + tan(|th2|/2)) / |Ni - Nj| (LaplacianMesh.cc:96-115);
    entries without two common neighbors get 0."""
    ring = topo_tensor(topo, "ring", nodes)
    ni = nodes[:, None, :]
    e_j = nodes[ring] - ni

    def half_tan(other):
        e_o = nodes[topo_tensor(topo, other, nodes)] - ni
        cross = torch.linalg.norm(torch.linalg.cross(e_o, e_j, dim=-1), dim=-1)
        dot = torch.sum(e_o * e_j, dim=-1)
        return torch.tan(0.5 * torch.atan2(cross, torch.abs(dot)))

    w = (half_tan("pair1") + half_tan("pair2")) / torch.clamp(
        torch.linalg.norm(e_j, dim=-1), min=1e-12
    )
    ok = topo_tensor(topo, "pair_ok", nodes) & topo_tensor(topo, "ring_mask", nodes)
    return torch.where(ok, w, torch.zeros_like(w))


def weighted_laplacian(nodes: torch.Tensor, topo: MeshTopology, w: torch.Tensor):
    """delta_i = x_i - sum_j w_ij x_j / sum_j w_ij (LaplacianMesh.cc:119-147),
    zero on rows without weight."""
    sw = w.sum(dim=1)
    zc = torch.einsum("mr,mrd->md", w, nodes[topo_tensor(topo, "ring", nodes)]) / torch.clamp(
        sw, min=1e-12
    )[:, None]
    return torch.where((sw > 1e-12)[:, None], nodes - zc, torch.zeros_like(nodes))


def edge_lengths(nodes: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    e = topo_tensor(topo, "edges", nodes)
    d = nodes[e[:, 0]] - nodes[e[:, 1]]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy/JAX median: the mean of the two middle values for an even
    count (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def make_template(nodes: torch.Tensor, topo: MeshTopology) -> Template:
    """Freeze the node positions as the rest shape: mean-value weights,
    rest curvature magnitudes, per-node curvature edge scale and the median
    edge length (Template::getEdgeMeanSize)."""
    w = mean_value_weights(nodes, topo)
    lap = weighted_laplacian(nodes, topo, w)
    rest_len = edge_lengths(nodes, topo)
    ring = topo_tensor(topo, "ring", nodes)
    ring_len = torch.linalg.norm(nodes[ring] - nodes[:, None, :], dim=-1)
    inv_l2 = torch.where(
        topo_tensor(topo, "ring_mask", nodes), 1.0 / torch.clamp(ring_len, min=1e-12) ** 2,
        torch.zeros_like(ring_len),
    )
    return Template(
        nodes=nodes,
        nodes_rest=nodes,
        rest_len=rest_len,
        lap_rest=torch.linalg.norm(lap, dim=-1),
        lap_w=w,
        curv_scale=torch.sqrt(inv_l2.sum(dim=1)),
        interior=~topo_tensor(topo, "boundary", nodes),
        mean_edge=_median(rest_len),
        valid=torch.ones((), dtype=torch.bool, device=nodes.device),
    )


def embed_uv(uv: torch.Tensor, dom: torch.Tensor, topo: MeshTopology):
    """Embed retina points (P, 2) into mesh facets, closed form: the grid
    cell and the side of its (a, c) diagonal pick the facet.  Returns
    (facet (P,) int64, bary (P, 3) f32, inside (P,) bool)."""
    nu, nv = topo.nodes_u, topo.nodes_v
    su = (uv[:, 0] - dom[0]) / (dom[1] - dom[0]) * (nu - 1)
    sv = (uv[:, 1] - dom[2]) / (dom[3] - dom[2]) * (nv - 1)
    inside = (su >= 0) & (su <= nu - 1) & (sv >= 0) & (sv <= nv - 1)
    su = torch.clamp(su, 0.0, nu - 1 - 1e-6)
    sv = torch.clamp(sv, 0.0, nv - 1 - 1e-6)
    iu = torch.floor(su).long()
    iv = torch.floor(sv).long()
    fu = su - iu
    fv = sv - iv
    q = iu * (nv - 1) + iv
    lower = fu >= fv
    facet = torch.where(lower, 2 * q, 2 * q + 1)
    w1 = torch.where(lower, fu - fv, fu)
    w2 = torch.where(lower, fv, fv - fu)
    bary = torch.stack([1.0 - w1 - w2, w1, w2], dim=-1)
    return facet, bary, inside


def facet_positions(nodes: torch.Tensor, topo: MeshTopology, facet: torch.Tensor,
                    bary: torch.Tensor) -> torch.Tensor:
    """Barycentric reconstruction (DefMapPoint::RecalculatePosition):
    (P,) facet ids + (P, 3) weights -> (P, 3) positions."""
    f = topo_tensor(topo, "faces", nodes)[torch.clamp(facet, 0, len(topo.faces) - 1)]
    return torch.einsum("pk,pkd->pd", bary, nodes[f])


def grid_nodes_from_surface(surf_xyz_fn, dom: torch.Tensor, topo: MeshTopology):
    """Sample the (nu x nv) node grid over the retina domain through a
    surface function (u, v) -> xyz (Surface::getVertex)."""
    nu, nv = topo.nodes_u, topo.nodes_v
    gu = torch.linspace(0.0, 1.0, nu, device=dom.device) * (dom[1] - dom[0]) + dom[0]
    gv = torch.linspace(0.0, 1.0, nv, device=dom.device) * (dom[3] - dom[2]) + dom[2]
    gu[-1], gv[-1] = dom[1], dom[3]
    U, V = torch.meshgrid(gu, gv, indexing="ij")
    return surf_xyz_fn(U.reshape(-1), V.reshape(-1))
