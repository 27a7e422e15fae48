"""cubesat_apds_tpu_torch — the PyTorch / CUDA port of cubesat_apds_tpu.

The localization main path (AKAZE → Hamming kNN-2 ratio match → RANSAC
homography → PnP-RANSAC), big-DB and spatially pruned serving, as plain
PyTorch on tensors, with three kernels
written by hand for NVIDIA Hopper (sm_90a) in ``csrc/``:

  * ``fed_cycle.cu``       one FED nonlinear-diffusion cycle per launch
  * ``sample_patches.cu``  per-keypoint nearest-neighbour patch sampling
  * ``knn2_hamming.cu``    Hamming kNN-2 of packed descriptors (big DBs)

Layout mirrors the JAX package so each module's counterpart is easy to
find:

  core/          tensor dataclasses, configs, camera model
  ops/           resampling, AKAZE features, matching, geometry
  ops/kernels/   the CUDA kernel wrappers, each beside its plain twin
  pipelines/     localize (frame → pose), stream, preprocess, calibrate
  parallel/      a [dp, tp] mesh of device slots: sharded kNN-2, serving
  convert.py     state exchange with the JAX package through numpy

Every function takes its device from its input tensors: CPU tensors run
the plain PyTorch versions, CUDA tensors run the kernels. The entry
points that place state (``convert.*_from``, ``Localizer``) put it on the
card unless the caller asks for the CPU. Nothing here imports jax.
"""

__version__ = "0.1.0"
