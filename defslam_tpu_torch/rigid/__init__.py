"""Rigid ORB-SLAM2 comparison mode (the reference's ``#ifdef ORBSLAM``
build, ``Modules/Settings/set_MAC.h:24-25``), ported from
``defslam_tpu/rigid``:

- :mod:`.initializer`: batched H/F RANSAC two-view initialization, the
  sample sets drawn apart from the solve (``draw_sets``);
- :mod:`.triangulation`: epipolar search, batched DLT triangulation and
  point fusion (kernel B1);
- :mod:`.culling`: keyframe redundancy;
- :mod:`.ba`: Schur-complement bundle adjustment, Sim(3) and
  essential-graph optimization;
- :mod:`.loop_closing`: loop detection (one B1 launch over every slot),
  Sim(3) verification and correction;
- :mod:`.system`: :class:`RigidSystem`, the orchestrator (``cli mono
  --orbslam``).
"""
