"""Typed configuration for the whole framework.

Replaces the reference's two-tier config (runtime YAML via cv::FileStorage +
compile-time macros in ``Modules/Settings/set_MAC.h`` / ``CC_MAC.h`` /
``Thirdparty/BBS/bbs_MAC.h``) with one frozen dataclass tree.  Defaults are the
reference's shipped operating point (``scripts/stereo0_template.yaml``).

All capacity knobs (max keypoints / points / keyframes, mesh size, spline
grid) live here and are Python ints: every store and work tensor has a static
shape derived from them.

This is the PyTorch port's own copy of ``defslam_tpu/config.py`` (the port
imports nothing of the JAX package).  ``yaml`` is imported only inside
:func:`load_raw_yaml`, so the package imports without PyYAML installed.
``parallel`` is not used by the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics.  Reference: Tracking.cc:49-100 (YAML Camera.*)."""

    fx: float = 541.107
    fy: float = 541.107
    cx: float = 318.308
    cy: float = 235.285
    # OpenCV radial/tangential distortion — applied to extracted keypoint
    # coordinates inside the frontend (Frame::UndistortKeyPoints parity).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 7.0

    @property
    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def dist(self):
        return (self.k1, self.k2, self.p1, self.p2, self.k3)

    @property
    def has_distortion(self) -> bool:
        return any(abs(c) > 0.0 for c in self.dist)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """Feature frontend budget.  Reference: YAML ORBextractor.* (1200 feats,
    scale 1.2, 8 pyramid levels, FAST thresholds 20/7)."""

    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    # Two-threshold FAST (ORBextractor.cc:765-857): per grid tile, corners
    # above ini_th are primary detections; a tile with nothing above ini_th
    # retries at min_th (ops.fast.select_grid_topk admission rule).
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Static per-frame keypoint capacity (padded + masked).  When
    # max_keypoints < the total per-level budget, truncation preserves each
    # level's proportional quota (never a global response top-k).
    # NOTE: the reference's 64x48 frame grid (Frame.h FRAME_GRID_COLS/ROWS)
    # has no knob here by design — windowed spatial queries are dense masked
    # distance matrices (ops.matching.window_mask), not grid lookups.
    max_keypoints: int = 1536


@dataclasses.dataclass(frozen=True)
class RegularizerConfig:
    """SfT regularizer weights.  Reference: DefTracking.cc:55-74
    (YAML Regularizer.*) and scripts/stereo0_template.yaml defaults."""

    laplacian: float = 700.0
    inextensibility: float = 12000.0
    temporal: float = 0.05
    local_zone: int = 2
    reliability: float = 0.7


@dataclasses.dataclass(frozen=True)
class SfTConfig:
    """Shape-from-Template solver budget.  Reference: DefOptimizer.cc:509-513
    (50 LM iterations), chi2 outlier threshold 5.991 (2-dof 95%)."""

    lm_iterations: int = 50
    chi2_threshold: float = 5.991
    huber_delta: float = 2.4477  # sqrt(5.991), matches g2o's robust kernel
    lm_lambda_init: float = 1e-4
    lm_lambda_max: float = 1e8
    lm_lambda_min: float = 1e-10
    # early-exit: stop when an accepted step improves the cost by less
    # than lm_rtol * cost.  The reference's g2o loop always runs its full
    # 50 iterations; the while_loop exit trades identical-accuracy late
    # iterations for frame latency (accuracy-gated in bench.py and the
    # mid-scale e2e).  1e-5 measured cost-identical to 1e-6 at 2/3 the
    # solve time on the full-scale bench frame (round 4)
    lm_rtol: float = 1e-5


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """NRSfM / local-mapping parameters.  Reference: DefLocalMapping.cc:58-64
    (YAML LocalMapping.*), SchwarpDatabase.cc:213-222 (3 LM iters),
    bbs_MAC.h (13x15 control grid), NormalEstimator.cc:139 (<=200 iters)."""

    points_to_template: int = 70
    # Sim3 registration acceptance gate.  DELIBERATE SEMANTIC DEVIATION from
    # the reference: LocalMapping.chiLimit there bounds a g2o chi2 SUM over
    # the registration edges (SurfaceRegistration.cc:126-135), which scales
    # with the pair count and the map's metric scale; here it bounds the
    # median registration residual RELATIVE to the median map-point range
    # (mapping/registration.py:86-88) — scale-free and count-free, so one
    # value works across sequences.  A reference YAML's chiLimit value must
    # be retuned (the shipped default 0.07 targets this semantic).
    chi_limit: float = 0.07
    bending: float = 0.10
    schwarp_regularizer: float = 0.05
    # B-spline warp control grid (reference bbs_MAC.h: 13 x 15).
    warp_ctrl_u: int = 13
    warp_ctrl_v: int = 15
    schwarp_lm_iterations: int = 3
    # map-consistency surface polish at re-templating (NO reference
    # equivalent — the reference accepts the SfN surface as-is after the
    # Sim3): after registration, the surface control depths are re-fit to
    # ALSO pass through the existing inlier map points (targets weighted by
    # this factor against grid anchors of the SfN shape).  Intended to
    # remove the spline-shaped registration residual that forces a camera
    # jump at the RegTemp=0 re-anchor; measured: helps a small off-center
    # fixture (ATE 0.079 -> 0.063) but trades depth accuracy at full bench
    # scale (0.027 -> 0.048 median depth err, ATE unchanged) because the
    # insertion-time targets carry deformation staleness.  Default OFF
    # (reference behavior); enable per-sequence when swap continuity
    # matters more than instantaneous depth.
    consistency_polish: float = 0.0
    # per-point (k1,k2) normal solves are warm-started from the previous
    # keyframe step; 12 LM iterations measured indistinguishable from 30
    # on the synthetic accuracy gates while the vmapped solve is the
    # largest single block of keyframe-chain device time (round-4 trace).
    # The reference allows Ceres up to 200 but converges far earlier
    # (NormalEstimator.cc:139)
    normal_lm_iterations: int = 12
    # minimum covisible shared points for a warp pair (SchwarpDatabase.cc:83)
    min_shared_points: int = 20
    # warp reprojection error gate in px (SchwarpDatabase.cc:288-292)
    warp_error_px: float = 10.0
    # minimum normals before shape-from-normals runs (Surface.cc:62-67)
    min_normals: int = 10
    # minimum registered point pairs for Sim3 alignment
    # (SurfaceRegistration.cc:106)
    min_registration_points: int = 15
    # shape-from-normals depth-surface control grid (1-valued spline)
    sfn_ctrl_u: int = 13
    sfn_ctrl_v: int = 15
    # flat-extension prior for the SfN surface OUTSIDE the normal support
    # (sfn.solve): a linear tilt lies in the bending penalty's null space,
    # so newly explored regions otherwise extrapolate an arbitrary tilt
    # that compounds over re-templating (the round-4 diagnosed ATE
    # limiter).  Weak zero-gradient rows bias the unsupported extension
    # toward constant depth.  0 = reference behavior (free extrapolation).
    sfn_flat_extension: float = 0.3
    # tilt continuation for that extension prior (sfn.solve): 0 targets
    # constant depth (round-4 behavior, a bounded but real bias at
    # template swaps); > 0 targets the RBF-weighted continuation of the
    # supported region's own normal-implied slope, fading to flat away
    # from support — the round-5 tilt-regularized extension.
    sfn_tilt_extension: float = 1.0
    # per-keyframe retina domains (DefKeyFrame::NormaliseKeypoints,
    # DefKeyFrame.cc:94-133): derive the warp domain from the new KF's
    # keypoint bbox and the SfN domain from the reference KF's bbox, each
    # with the reference's 0.10 relative margin, instead of one shared
    # camera-wide domain.  Concentrates the full control grid on the
    # feature cloud (matters for vignetted/off-center imagery); bending
    # matrices come from the exact jittable affine rescaling
    # (ops/bspline.bending_matrix_dyn).  The template grid itself stays on
    # the camera-wide domain.
    per_kf_domain: bool = False
    # bbox margin fraction (the reference's 0.10, DefKeyFrame.cc:104-110)
    kf_domain_margin: float = 0.10


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Template mesh.  Reference hard-codes a 10x10 node grid
    (TriangularMesh.cc:63-65) -> 100 nodes, 162 facets."""

    nodes_u: int = 10
    nodes_v: int = 10

    @property
    def n_nodes(self) -> int:
        return self.nodes_u * self.nodes_v

    @property
    def n_faces(self) -> int:
        return 2 * (self.nodes_u - 1) * (self.nodes_v - 1)

    @property
    def n_edges(self) -> int:
        nu, nv = self.nodes_u, self.nodes_v
        # horizontal + vertical + one diagonal per quad
        return nu * (nv - 1) + nv * (nu - 1) + (nu - 1) * (nv - 1)


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static SoA capacities (pad + mask everywhere)."""

    max_map_points: int = 4096
    max_keyframes: int = 24
    # per-keyframe observation table capacity = OrbConfig.max_keypoints
    # covisible warp pairs fitted per mapping step (top-covisible selection;
    # also the FIXED pair-batch shape — keep small, each pair is a 390-param
    # LM fit)
    max_warp_pairs: int = 8


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracker cadence.  Reference: keyframe every 10 frames
    (DefTracking.cc:175-178); projection search window 20 px
    (DefTracking.cc TrackWithMotionModel)."""

    keyframe_period: int = 10
    projection_window: float = 20.0
    match_th_high: int = 75  # ORBmatcher.h TH_HIGH
    match_th_low: int = 50  # ORBmatcher.h TH_LOW
    nn_ratio: float = 0.9
    min_inliers_ok: int = 10
    # consecutive LOST frames tolerated (relocalization attempts against
    # the stored keyframes) before the map is reset and re-initialized.
    # The reference's DefSLAM mode resets immediately
    # (DefTracking.cc:194-207); its ORBSLAM mode relocalizes forever —
    # this knob spans both, sized to survive a multi-frame full occlusion
    lost_patience: int = 10
    # candidate compaction for the per-frame projection search: only valid
    # template-embedded in-frustum points enter the (P, K) match tensors,
    # gathered into this many slots (the reference's grid lookup touches
    # only window-local candidates; this is the batched equivalent).
    # Overflow is counted in FrameMatches.n_dropped, never silent.
    match_capacity: int = 2048
    # pipelined frame loop: overlap the host's stats readback of frame t
    # with up to `pipeline_depth` newer frames' device compute (the
    # reference's PARALLEL tracking/mapping overlap, set_MAC.h:22,
    # re-expressed for async device dispatch).  Tracking failures are
    # detected up to `pipeline_depth` frames late and rolled back (the
    # failed frame + newer in-flight frames replay synchronously);
    # keyframe frames are pipelined too.  Depth 2 hides a host<->device
    # round trip longer than one frame's device compute; depth 1 validates
    # each frame while the next one is dispatched.  pipelined=False is the
    # synchronous protocol (each frame validated before its call returns).
    pipelined: bool = True
    pipeline_depth: int = 2
    # split the keyframe mapping chain into TWO device dispatches with the
    # next frame's compute interleaved between them (mapper.keyframe_step_a
    # / _b): no single dispatch then exceeds ~half the chain's device time,
    # which bounds keyframe-adjacent p95/p99 frame latency.  The cost is
    # one frame of extra swap latency: a template regenerated at keyframe t
    # becomes visible to tracking at frame t+2 instead of t+1 (the
    # reference's PARALLEL mode has the same asynchrony, System.cc:140-142,
    # with an unbounded lag).  Synchronous-equivalence tests keep this off.
    split_keyframe_dispatch: bool = False


@dataclasses.dataclass(frozen=True)
class GtConfig:
    """Ground-truth evaluation harness.  Reference: CC_MAC.h:24-30
    (NCC window sizes and acceptance threshold)."""

    ncc_template: int = 11  # template half-extent in px (odd window)
    ncc_search: int = 31  # search band half-extent along epipolar line
    ncc_threshold: float = 0.85


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    """Offline viewer outputs (the reference's live Pangolin viewer has no
    headless equivalent; DefFrameDrawer parity is per-frame annotated PNG
    export, viewer/frame_drawer.py)."""

    save_frames: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Multi-chip execution (no reference equivalent — the reference's only
    parallelism is 3 CPU threads, System.cc:140-169; SURVEY 5.7-5.8 defines
    the TPU-native scaling obligations this config drives).

    ``enabled`` shards the production System over a jax.sharding.Mesh:
    observation-sharded SfT (psum'd normal-equation blocks over ICI) in the
    frame loop, pair-sharded warp fits and point-sharded normal solves in
    the mapping step.  ``coordinator`` switches on multi-host
    jax.distributed (one process per host, DCN between hosts, ICI inside)."""

    enabled: bool = False
    n_devices: int = 0  # 0 = all visible devices
    # multi-host plumbing (jax.distributed.initialize); "" = single process
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    regularizer: RegularizerConfig = dataclasses.field(
        default_factory=RegularizerConfig
    )
    sft: SfTConfig = dataclasses.field(default_factory=SfTConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    gt: GtConfig = dataclasses.field(default_factory=GtConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    output_dir: str = "./out"
    save_results: bool = False
    seed: int = 0

    @staticmethod
    def from_yaml(path: str) -> "Config":
        """Load a config from a YAML file.

        Accepts both our nested schema and the reference's flat
        ``Camera.fx``-style keys (scripts/stereo0_template.yaml) so existing
        DefSLAM setting files keep working.
        """
        raw = load_raw_yaml(path)
        if any("." in k for k in raw):
            raw = _from_reference_yaml(raw)
        return _build(Config, raw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def replace_path(cfg: Config, path: tuple, value) -> Config:
    """A new frozen Config with the field at ``path`` replaced; the value is
    coerced to the current field's type (a YAML float must not turn an int
    field into a float).  Raises KeyError on an unknown path, so live-tuning
    typos are loud."""
    node = cfg
    for p in path[:-1]:
        if not hasattr(node, p):
            raise KeyError(f"no config section {'.'.join(path)}")
        node = getattr(node, p)
    leaf = path[-1]
    if not hasattr(node, leaf):
        raise KeyError(f"no config field {'.'.join(path)}")
    cur = getattr(node, leaf)
    if isinstance(cur, bool):
        value = bool(value)
    elif isinstance(cur, int):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    new = dataclasses.replace(node, **{leaf: value})
    # rebuild the ancestors bottom-up
    for i in range(len(path) - 2, -1, -1):
        parent = cfg
        for p in path[:i]:
            parent = getattr(parent, p)
        new = dataclasses.replace(parent, **{path[i]: new})
    return new


def reference_key_path(key: str) -> tuple:
    """A parameter name as a path: a reference YAML key
    ('Regularizer.laplacian', scripts/stereo0_template.yaml) or a dotted
    path into this schema ('sft.lm_iterations')."""
    if key in _REF_KEYMAP:
        return _REF_KEYMAP[key]
    return tuple(key.split("."))


def load_raw_yaml(path: str) -> dict:
    """Parse a settings file into a flat dict, tolerating the reference's
    cv::FileStorage quirks: the '%YAML:1.0' directive (invalid for PyYAML),
    %PLACEHOLDER% values (substituted by Twiddle.py), and '!!opencv-matrix'
    nodes (returned as numpy arrays of the declared shape) — so the
    reference's shipped YAMLs (scripts/*.yaml, calibration_files/*.yaml)
    load unmodified.  Used by Config.from_yaml and the stereo rectification
    loader (io.datasets.rectify_maps, LEFT.*/RIGHT.* keys)."""
    import re

    import numpy as np
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [
        re.sub(r'^(\s*[\w.]+\s*:\s*)(%.*)$', r'\1"\2"', ln)
        for ln in text.splitlines()
        if not ln.lstrip().startswith("%YAML")
    ]

    class _CvLoader(yaml.SafeLoader):
        pass

    def _cv_matrix(loader, node):
        m = loader.construct_mapping(node, deep=True)
        return np.asarray(m["data"], np.float64).reshape(
            int(m["rows"]), int(m["cols"])
        )

    _CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _cv_matrix)
    return yaml.load("\n".join(lines), Loader=_CvLoader) or {}


def _build(cls, raw: dict):
    kwargs: dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name, field in fields.items():
        if name not in raw:
            continue
        sub = field.type if isinstance(field.type, type) else None
        ftype = field.default_factory if field.default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if ftype is not None and dataclasses.is_dataclass(ftype):
            kwargs[name] = _build(ftype, raw[name])
        elif sub is not None and dataclasses.is_dataclass(sub):
            kwargs[name] = _build(sub, raw[name])
        else:
            kwargs[name] = raw[name]
    return cls(**kwargs)


# Mapping from the reference's flat YAML keys to our nested schema.
_REF_KEYMAP = {
    "Camera.fx": ("camera", "fx"),
    "Camera.fy": ("camera", "fy"),
    "Camera.cx": ("camera", "cx"),
    "Camera.cy": ("camera", "cy"),
    "Camera.k1": ("camera", "k1"),
    "Camera.k2": ("camera", "k2"),
    "Camera.p1": ("camera", "p1"),
    "Camera.p2": ("camera", "p2"),
    "Camera.k3": ("camera", "k3"),
    "Camera.width": ("camera", "width"),
    "Camera.height": ("camera", "height"),
    "Camera.fps": ("camera", "fps"),
    "ORBextractor.nFeatures": ("orb", "n_features"),
    "ORBextractor.scaleFactor": ("orb", "scale_factor"),
    "ORBextractor.nLevels": ("orb", "n_levels"),
    "ORBextractor.iniThFAST": ("orb", "ini_th_fast"),
    "ORBextractor.minThFAST": ("orb", "min_th_fast"),
    "Regularizer.laplacian": ("regularizer", "laplacian"),
    "Regularizer.Inextensibility": ("regularizer", "inextensibility"),
    "Regularizer.temporal": ("regularizer", "temporal"),
    "Regularizer.LocalZone": ("regularizer", "local_zone"),
    "Regularizer.Reliability": ("regularizer", "reliability"),
    "LocalMapping.pointsToTemplate": ("mapping", "points_to_template"),
    "LocalMapping.chiLimit": ("mapping", "chi_limit"),
    "LocalMapping.Bending": ("mapping", "bending"),
    "LocalMapping.Schwarp.Regularizer": ("mapping", "schwarp_regularizer"),
    "File.outputdir": ("output_dir",),
    "Viewer.SaveResults": ("save_results",),
}


def _from_reference_yaml(raw: dict) -> dict:
    nested: dict[str, Any] = {}
    for key, value in raw.items():
        path = _REF_KEYMAP.get(key)
        if path is None:
            continue
        if key == "Viewer.SaveResults":
            value = bool(value)
        node = nested
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return nested
