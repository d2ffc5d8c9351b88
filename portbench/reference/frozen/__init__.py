"""A frozen copy of the plain paths of ``defslam_tpu_torch``: the frontend,
the projection matcher, the SfT, the keyframe step, the pose LM and the
bundle adjustment, as the port computed them when the benchmark was
defined.

It is the benchmark's reference for those layers: kernels B1 and B2 are
their plain versions here on every device (``ops/hamming.py``,
``ops/windowed_match.py``), and the sharded SfT is left out (the
reference solves a frame on one device).  Nothing here imports the
program; later changes to the program do not reach it.

Every floating-point tensor it makes is of torch's default type: float32
as the port computes, or float64 where the reference sets it so.
"""
