"""badslam_torch — direct RGB-D SLAM in PyTorch with hand-written CUDA kernels.

A port of ``badslam_tpu`` (JAX/XLA/Pallas) to PyTorch on NVIDIA Hopper
GPUs. The module layout mirrors ``badslam_tpu``: every module here is the
counterpart of the module of the same path there, with the same public
names and the same array layouts (``[H, W]`` planes, quaternions in wxyz
order), so the two packages can be held to each other by tests.

The port covers the main path with loop detection off: preprocessing
(with the bilateral depth filter as a CUDA kernel), the image pyramid,
coarse-to-fine pairwise tracking against the base keyframe, the keyframe
store and surfel map, the alternating keyframe bundle adjustment (with the
image gather as a CUDA kernel), the PCG bundle adjustment, self-calibration
of the camera intrinsics and the depth deformation, trajectory
deformation, the point-cloud export, and the front end and CLI that drive
them, plus the generic LM optimizer (``utils/lm.py``). Loop closure and the
other later slices are refused with ``NotImplementedError`` where a
configuration asks for them.

The package imports ``torch`` and never ``jax``, and nothing of
``badslam_tpu``: it carries its own copy of what it needs from there
(``config.py``).
"""

__version__ = "0.1.0"
