"""Typed configuration with the reference's hard-coded defaults lifted out.

Every constant below is traceable to the reference (SURVEY.md §5 "Config /
flag system"): AKAZE params feature_extraction/src/lib.rs:64-73, max points
2^18−1 lib.rs:12-13, γ=1/2.2 geotiff_extractor/.../mod.rs:14, default tile
scaling 1024² + band order mod.rs:66-73, homography reprojection threshold
3.0 homographier/.../mod.rs:248, minimum LoD resolution 500
preprocessor/src/level_of_detail.rs:4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Reference: feature_extraction/src/lib.rs:12-13
MAX_POINTS_SHIFT = 18
MAX_POINTS = (1 << MAX_POINTS_SHIFT) - 1  # 262,143

# Reference: geotiff_extractor/src/image_extractor/mod.rs:14
GAMMA_VALUE = 1.0 / 2.2

# Reference: preprocessor/src/level_of_detail.rs:4
MINIMUM_RESOLUTION = 500

# Packed MLDB descriptor: 486 bits → 61 bytes (full-size, 3 channels).
MLDB_BITS = 486
DESC_BYTES = 61
# Device-side unpacked layout is padded to a lane-friendly 512 bits.
DESC_BITS_PADDED = 512


@dataclasses.dataclass(frozen=True)
class AkazeConfig:
    """AKAZE detector/descriptor parameters.

    Defaults replicate the reference's creation call
    (feature_extraction/src/lib.rs:64-73): DESCRIPTOR_MLDB, full descriptor
    (486 bits), 3 channels, threshold 0.001, 4 octaves, 4 sublevels,
    PM-G2 diffusivity, max_points = 2^18−1.
    """

    threshold: float = 0.001
    octaves: int = 4
    sublevels: int = 4
    diffusivity: str = "pm_g2"      # perona-malik g2: 1 / (1 + (|∇L|/k)^2)
    descriptor_channels: int = 3
    descriptor_pattern_size: int = 10
    max_points: int = MAX_POINTS
    # Practical per-call static capacity (device output shape). The
    # reference cap (2^18−1) is the semantic limit; per-tile extraction
    # rarely exceeds a few thousand, so pipelines pick smaller capacities.
    capacity: int = 8192
    soffset: float = 1.6            # base scale σ₀
    derivative_factor: float = 1.5
    kcontrast_percentile: float = 0.7
    kcontrast_nbins: int = 300
    fed_tau_max: float = 0.25
    # MLDB descriptor mode: "exact" reproduces the reference's cell
    # means over every integer sample of the rotated pattern (441
    # nearest-neighbour samples/keypoint); "fast" samples each cell ONCE
    # from a blur-matched pyramid (29 samples/keypoint) — an
    # anti-aliased approximation of the same descriptor (end-task study:
    # benchmarks/study_fast_parity.py; 0.81 inlier Jaccard vs exact).
    # "exact" is the DEFAULT again since round 3: the flat linearized
    # gather lowered the 441-sample load below the 100 fps budget
    # (103.8 fps measured e2e, PERF.md round 3), so the oracle-validated
    # reference-faithful sampling needs no speed trade anymore. "fast"
    # remains the opt-in throughput mode (120 fps). "hybrid" sits
    # between: 2×2 blur-matched subcell samples per cell in the rotated
    # frame (116 samples/keypoint), halving fast's box-vs-Gaussian and
    # rotation mismatch. Build DB and frames with ONE mode — descriptors
    # across modes don't mix.
    descriptor_mode: str = "exact"
    # Subdivision for descriptor_mode="hybrid": sub×sub blur-matched
    # samples per MLDB cell (2 → 116 samples/kp, 0.90 inlier Jaccard vs
    # exact; 3 → 261 samples/kp — see PERF.md round 3).
    hybrid_subcells: int = 2
    # Orientation sampling: "exact" = the full 109-point disc; "fast" =
    # a 55-point checkerboard subset (halves the dominant remaining
    # gather; √2 more noise on the resultant-vector estimate).
    orientation_mode: str = "exact"
    # Per-level candidate extraction: "approx" = lax.approx_max_k with
    # recall_target 0.95 (the TPU-native partial reduce, ~4× cheaper);
    # "exact" = sort-based lax.top_k (used by the oracle-parity tests to
    # quantify the approx recall loss — see test_akaze_oracle.py).
    detect_topk: str = "approx"
    # Keypoint sampling backend for orientation + MLDB: "gather" is the
    # direct point-gather (fastest measured on v5e — TPU gathers are
    # per-index-latency-bound but the one-hot alternative pays more in
    # patch materialization); "onehot" routes through patch extraction +
    # MXU one-hot contractions. Identical results (equivalence-tested).
    sampler: str = "gather"
    # Adaptive capacity ladder for the orientation+descriptor stage: the
    # per-keypoint gathers (the dominant cost) run over a lax.switch of
    # capacity prefixes (rungs every max(capacity/n, 256) slots) sized
    # to the LIVE keypoint count, so a frame with 1100 keypoints in a
    # 2048-slot capacity pays ~5/8 of the gather wall. Exact: detection
    # emits a response-sorted valid prefix, and slots past the count are
    # masked zeros either way. 1 disables (single full-capacity branch);
    # vmapped (batched) calls always use the full path — a switch under
    # vmap runs all branches. Default 8 (measured A/B on the v5e,
    # benchmarks/exp_r3g_adaptive.py: 103.4 → 122.3 fps e2e on the bench
    # scene; the 256-slot rung floor keeps small-capacity compiles
    # single-branch, so tests and tiny tiles pay no extra compiles).
    adaptive_buckets: int = 8

    def __post_init__(self):
        # An unrecognized mode string would silently fall through the
        # three-way dispatch to exact sampling (and stamp stores with a
        # tag no config can ever match) — reject it up front.
        if self.descriptor_mode not in ("exact", "fast", "hybrid"):
            raise ValueError(
                f"descriptor_mode={self.descriptor_mode!r}: expected "
                "'exact', 'fast' or 'hybrid'")
        if self.orientation_mode not in ("exact", "fast"):
            raise ValueError(
                f"orientation_mode={self.orientation_mode!r}: expected "
                "'exact' or 'fast'")
        if self.descriptor_mode == "hybrid" and self.hybrid_subcells < 2:
            raise ValueError("hybrid_subcells must be >= 2")

    @property
    def num_levels(self) -> int:
        return self.octaves * self.sublevels

    @property
    def descriptor_tag(self) -> str:
        """Provenance string for stores: which sampling produced the
        descriptor bits. Hybrid bits differ per subdivision, so the tag
        carries it ("hybrid2" vs "hybrid3") — the store/config mix-guard
        compares tags, not bare mode names."""
        if self.descriptor_mode == "hybrid":
            return f"hybrid{self.hybrid_subcells}"
        return self.descriptor_mode


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching parameters.

    knn ratio test semantics follow get_knn_matches
    (feature_extraction/src/lib.rs:94-114): keep m₀ iff
    d₀ < d₁ · filter_strength. Crosscheck BF follows
    get_bruteforce_matches (lib.rs:116-126): mutual nearest neighbours.
    """

    k: int = 2
    ratio: float = 0.3              # reference test uses 0.3 (lib.rs:289)
    crosscheck: bool = False
    db_block: int = 65536           # descriptors per device tile for big DBs
    kernel: str = "auto"            # big-DB path: "auto" | "fused" | "scan"
    #   auto / fused = ops/kernels/match_kernel.knn2_fused: the CUDA kNN-2
    #   kernel (csrc/knn2_hamming.cu) on CUDA tensors, its plain twin
    #   (ops/match.knn2_blockwise) on CPU tensors; scan = the plain twin on
    #   either device. All three are bit-identical.


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Vectorized RANSAC homography parameters.

    Default reprojection threshold 3.0 follows find_homography_mat
    (homographier/src/homographier/mod.rs:248). The reference defers to
    OpenCV's sequential adaptive RANSAC; TPU-native is a fixed batch of
    hypotheses scored in parallel (SURVEY.md §7 hard part #2).
    """

    reproj_threshold: float = 3.0
    num_hypotheses: int = 512
    min_points: int = 4
    refine_iters: int = 3           # masked-DLT refinement rounds on inliers
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """PnP-RANSAC parameters (EPnP hypotheses).

    Mirrors pnp_solver_ransac's knobs (homographier mod.rs:320-369):
    iteration count, reprojection threshold, confidence — recast as a
    fixed hypothesis batch.
    """

    reproj_threshold: float = 8.0   # OpenCV solvePnPRansac default
    num_hypotheses: int = 256
    sample_size: int = 6            # ≥6 gives EPnP a well-posed system
    refine_iters: int = 5           # Gauss-Newton on inliers
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Raster ingestion options.

    Mirrors DatasetOptions defaults (geotiff_extractor mod.rs:66-73):
    1024×1024 tile scaling, band order (1, 2, 3).
    """

    tile_size: Tuple[int, int] = (1024, 1024)
    bands: Tuple[int, int, int] = (1, 2, 3)
    gamma: float = GAMMA_VALUE


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Zhang-method calibration parameters (calibrator/src/main.rs)."""

    min_images: int = 10            # reference asserts ≥10 (main.rs:30-34)
    lm_iters: int = 30
    lm_lambda0: float = 1e-3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    akaze: AkazeConfig = AkazeConfig()
    match: MatchConfig = MatchConfig()
    ransac: RansacConfig = RansacConfig()
    pnp: PnPConfig = PnPConfig()
    mosaic: MosaicConfig = MosaicConfig()
    calib: CalibConfig = CalibConfig()
