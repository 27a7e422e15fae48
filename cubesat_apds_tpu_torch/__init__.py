"""cubesat_apds_tpu_torch — the PyTorch / CUDA port of cubesat_apds_tpu.

Everything the JAX package does, as plain PyTorch on tensors, with three
kernels written by hand for NVIDIA Hopper (sm_90a) in ``csrc/``:

  * ``fed_cycle.cu``       one FED nonlinear-diffusion cycle per launch
  * ``sample_patches.cu``  per-keypoint nearest-neighbour patch sampling
  * ``knn2_hamming.cu``    Hamming kNN-2 of packed descriptors (big DBs)

Layout mirrors the JAX package so each module's counterpart is easy to
find:

  core/          tensor dataclasses, configs, camera model, attitude
  ops/           resampling, AKAZE features, matching, geometry, warps
  ops/kernels/   the CUDA kernel wrappers, each beside its plain twin
  io/            GeoTIFF / COG decode and the mosaic
  store/         the npz and binary feature stores
  pipelines/     localize (frame → pose), stream, preprocess, calibrate
  parallel/      a [dp, tp] mesh of device slots: sharded kNN-2, serving
  utils/         accuracy runner, synthetic scenes, profiling, viz
  cli.py         the command line (``apds-torch``); bench.py its `bench`
  convert.py     state exchange with the JAX package through numpy

Every function takes its device from its input tensors: CPU tensors run
the plain PyTorch versions, CUDA tensors run the kernels. The entry
points that place state (``convert.*_from``, ``Localizer``) put it on the
card unless the caller asks for the CPU. Nothing here imports jax, and
importing the package builds no kernel and starts no CUDA context.
"""

__version__ = "0.1.0"

from cubesat_apds_tpu_torch.core.types import (  # noqa: F401
    CameraModel,
    Keypoints,
    Matches,
    Correspondences,
    PoseSolution,
    HomographyResult,
)
from cubesat_apds_tpu_torch.core.config import (  # noqa: F401
    AkazeConfig,
    MatchConfig,
    PipelineConfig,
    RansacConfig,
    PnPConfig,
    MosaicConfig,
    MAX_POINTS,
)

# The functional surface, lazily resolved (PEP 562) so `import
# cubesat_apds_tpu_torch` stays cheap: the JAX package's names, each from
# its port module.
_LAZY = {
    "detect_and_compute": "cubesat_apds_tpu_torch.ops.features.akaze",
    "detect_and_compute_batch": "cubesat_apds_tpu_torch.ops.features.akaze",
    "detect_and_compute_tiled": "cubesat_apds_tpu_torch.ops.features.akaze",
    "knn_match": "cubesat_apds_tpu_torch.ops.match",
    "crosscheck_match": "cubesat_apds_tpu_torch.ops.match",
    "find_homography_ransac": "cubesat_apds_tpu_torch.ops.geometry.homography",
    "solve_pnp_ransac": "cubesat_apds_tpu_torch.ops.geometry.pnp",
    "warp_perspective": "cubesat_apds_tpu_torch.ops.warp",
    "FeatureStore": "cubesat_apds_tpu_torch.store.feature_store",
    "BinaryFeatureStore": "cubesat_apds_tpu_torch.store.binary_store",
    "MosaicDataset": "cubesat_apds_tpu_torch.io.mosaic",
    "preprocess": "cubesat_apds_tpu_torch.pipelines.preprocess",
    "Localizer": "cubesat_apds_tpu_torch.pipelines.localize",
    "localize_frame": "cubesat_apds_tpu_torch.pipelines.localize",
    "localize_frame_jit": "cubesat_apds_tpu_torch.pipelines.localize",
    "localize_coarse_to_fine": "cubesat_apds_tpu_torch.pipelines.localize",
    "load_device_db": "cubesat_apds_tpu_torch.pipelines.localize",
    "StreamingLocalizer": "cubesat_apds_tpu_torch.pipelines.stream",
    "calibrate_camera": "cubesat_apds_tpu_torch.ops.geometry.calibration",
    "make_mesh": "cubesat_apds_tpu_torch.parallel.mesh",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
