"""Parity of the PyTorch port's feature stack with the JAX package.

Inputs come from numpy seeds and go through both packages; the JAX side
runs on the CPU, with its Pallas kernels in interpret mode where a test
compares a kernel's plain twin. The CUDA kernels themselves are checked
against their twins in tests/test_torch_kernels.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.ops import resample as jres
from cubesat_apds_tpu.ops.features import akaze as jakaze
from cubesat_apds_tpu.ops.features import scale_space as jss
from cubesat_apds_tpu.ops.features.detect import detect_keypoints as jdetect
from cubesat_apds_tpu.ops.features.mldb import mldb_descriptors as jmldb
from cubesat_apds_tpu.ops.features.orientation import (
    compute_orientations as jorient)
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core.config import AkazeConfig
from cubesat_apds_tpu_torch.ops import resample as tres
from cubesat_apds_tpu_torch.ops.features import mldb as tmldb
from cubesat_apds_tpu_torch.ops.features import scale_space as tss
from cubesat_apds_tpu_torch.ops.features.detect import detect_keypoints
from cubesat_apds_tpu_torch.ops.features.orientation import (
    compute_orientations)
from cubesat_apds_tpu_torch.ops.kernels import diffusion as tdiff
from cubesat_apds_tpu_torch.ops.kernels import sample_kernel as tsk

torch.set_num_threads(2)

N = 128
CAP = 256
JCFG = JAkazeConfig(capacity=CAP, detect_topk="exact")
TCFG = AkazeConfig(capacity=CAP)


def _frame(seed, n=N):
    """bench.py's corner-rich synthetic frame, at n×n."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(120 * n * n // (512 * 512) + 30):
        cy, cx = rng.integers(4, n - 20, 2)
        s = int(rng.integers(4, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


@pytest.fixture(scope="module")
def img():
    return _frame(7)


@pytest.fixture(scope="module")
def jax_ref(img):
    """One jitted JAX run: scale space, detection, packed stack, and
    orientation + MLDB on JAX's own keypoints."""

    @jax.jit
    def front(x):
        ss = jss.build_scale_space(x, JCFG)
        kps, lx, ly = jdetect(ss, JCFG, CAP)
        packed = jakaze._packed_stack(ss.Lt, lx, ly)
        level_hw = jnp.asarray([a.shape for a in ss.Lt], jnp.int32)
        angle = jorient(packed, level_hw, kps.xy, kps.size, kps.class_id,
                        kps.octave, kps.valid)
        desc = jmldb(packed, level_hw, kps.xy, kps.size, angle, kps.class_id,
                     kps.octave, kps.valid)
        return ss.Lt, ss.Lsmooth, ss.kcontrast, kps, packed, level_hw, \
            angle, desc

    out = jax.device_get(front(jnp.asarray(img)))
    keys = ("Lt", "Lsmooth", "k", "kps", "packed", "level_hw", "angle",
            "desc")
    ref = dict(zip(keys, out))
    # The same scale space run op by op (no jit): the reference's own
    # spread between two executions, level by level.
    eager = jss.build_scale_space(jnp.asarray(img), JCFG)
    ref["Lt_eager"] = [np.asarray(a) for a in eager.Lt]
    ref["Lsmooth_eager"] = [np.asarray(a) for a in eager.Lsmooth]
    return ref


@pytest.fixture(scope="module")
def torch_ss(img):
    return tss.build_scale_space(torch.from_numpy(img), TCFG)


# --- kernel twins against the Pallas kernels (interpret mode) -------------

@pytest.mark.parametrize("case", ["whole", "strips"])
def test_fed_cycle_twin_matches_pallas(case):
    """Plain twin of kernel A vs the Pallas FED kernels in interpret mode,
    at tests/test_pallas_diffusion.py's shapes. atol 1e-5: the Pallas
    stencil is summed in another fused order than the twin's."""
    from jax.experimental.pallas import tpu as pltpu

    from cubesat_apds_tpu.ops.pallas import diffusion as D

    rng = np.random.default_rng(1234)
    h, t_total = (32, 1.0) if case == "whole" else (72, 2.0)
    L = rng.uniform(0, 1, (h, 128)).astype(np.float32)
    g = rng.uniform(0.2, 1.0, (h, 128)).astype(np.float32)
    taus = jss.fed_tau_by_process_time(t_total)
    with pltpu.force_tpu_interpret_mode():
        if case == "whole":
            ref = D._fed_cycle_pallas(jnp.asarray(L), jnp.asarray(g),
                                      jnp.asarray(taus), len(taus))
        else:
            ref = D._fed_cycle_strips(jnp.asarray(L), jnp.asarray(g),
                                      jnp.asarray(taus), len(taus),
                                      strip_h=32, halo=8)
    got = tdiff.fed_cycle(torch.from_numpy(L), torch.from_numpy(g), taus)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sampler_twin_matches_pallas_bit_exact():
    """Plain twin of kernel B vs pallas_sampler in interpret mode, on
    tests/test_pallas_sampler.py's inputs: bit-exact (both read bf16
    values and widen them to float32)."""
    from jax.experimental.pallas import tpu as pltpu

    from cubesat_apds_tpu.ops.pallas.sample_kernel import (
        PATCH_R, pallas_sampler)

    rng = np.random.default_rng(1234)
    L, Hmax, Wmax, C = 4, 128, 128, 4
    arr = rng.standard_normal((L, Hmax, Wmax, C)).astype(np.float32)
    arr[..., 3] = 0.0
    hw = np.array([[128, 128], [64, 64], [128, 128], [64, 64]], np.int32)
    K, S = 16, 33
    lvl = rng.integers(0, L, K).astype(np.int32)
    cx = np.array([rng.integers(0, w) for w in hw[lvl, 1]], np.int32)
    cy = np.array([rng.integers(0, h) for h in hw[lvl, 0]], np.int32)
    iy = cy[:, None] + rng.integers(-PATCH_R, PATCH_R + 1, (K, S))
    ix = cx[:, None] + rng.integers(-PATCH_R, PATCH_R + 1, (K, S))

    with pltpu.force_tpu_interpret_mode():
        ref = pallas_sampler(jnp.asarray(arr).astype(jnp.bfloat16),
                             jnp.asarray(hw), jnp.asarray(lvl),
                             jnp.asarray(cx), jnp.asarray(cy))(
            jnp.asarray(iy, jnp.int32), jnp.asarray(ix, jnp.int32))
    got = tsk.sample_patches_plain(
        torch.from_numpy(arr).to(torch.bfloat16), torch.from_numpy(hw),
        torch.from_numpy(lvl).long(), torch.from_numpy(iy),
        torch.from_numpy(ix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- resample and scale space ---------------------------------------------

@pytest.mark.parametrize("op", ["blur1.6", "blur1.0", "half", "half_odd",
                                "scharr_x", "scharr_y", "sep_edge"])
def test_resample_matches_jax(img, op):
    """Filters at 128², atol 1e-5 (same taps and term order; XLA may fuse
    the sums in another order, so the last bits may differ)."""
    x = img if op != "half_odd" else img[:127, :125]
    fns = {
        "blur1.6": (lambda m, a: m.gaussian_blur(a, 1.6)),
        "blur1.0": (lambda m, a: m.gaussian_blur(a, 1.0)),
        "half": (lambda m, a: m.half_sample(a)),
        "half_odd": (lambda m, a: m.half_sample(a)),
        "scharr_x": None, "scharr_y": None,
        "sep_edge": (lambda m, a: m.separable_conv2d(
            a, [1.0, 2.0, 0.0, -2.0, -1.0], [0.25, 0.5, 0.25])),
    }
    if op.startswith("scharr"):
        ref = getattr(jss, op)(jnp.asarray(x))
        got = getattr(tss, op)(torch.from_numpy(x))
    else:
        ref = fns[op](jres, jnp.asarray(x))
        got = fns[op](tres, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_k_percentile_same_bin(img, jax_ref, torch_ss):
    """The contrast factor drives all 15 FED cycles, so the histogram bin
    must be the same. Against JAX run op by op, k is equal exactly (the
    filters are the same float ops in the same order). Against the
    jitted JAX run, XLA's fusion moves hmax by an ulp; k = hmax·bin/300
    then agrees within 1e-6 relative, which adjacent bins (≥ 1/300
    apart) cannot."""
    k_jit = float(jax_ref["k"])
    assert abs(float(torch_ss.kcontrast) - k_jit) <= 1e-6 * k_jit
    for seed in (3, 4, 7):
        x = _frame(seed)
        assert float(tss.compute_k_percentile(torch.from_numpy(x))) == \
            float(jss.compute_k_percentile(jnp.asarray(x)))


@pytest.mark.parametrize("field", ["Lt", "Lsmooth"])
def test_scale_space_matches_jax(jax_ref, torch_ss, field):
    """All 16 levels at 128² against the jitted JAX run, atol 1e-5 — or,
    where larger, twice the JAX package's own spread between its jitted
    and op-by-op runs of the same level. FED cycles of ≥ 8 steps (octaves
    2–3) amplify float32 rounding (the τ schedule is not reordered), so
    past octave 1 the reference itself is only defined to that spread;
    octaves 0–1 must hold 1e-5 outright."""
    meta = torch_ss.meta
    for i, ref in enumerate(jax_ref[field]):
        got = getattr(torch_ss, field)[i].numpy()
        spread = float(np.abs(jax_ref[field + "_eager"][i] - ref).max())
        tol = 1e-5 if meta[i].octave <= 1 else max(1e-5, 2.0 * spread)
        np.testing.assert_allclose(got, np.asarray(ref), atol=tol,
                                   err_msg=f"{field} level {i}")


# --- detection, orientation, MLDB -----------------------------------------

def test_detection_matches_jax(jax_ref, torch_ss):
    """Keypoint SETS, not arrays: the keypoint-count mismatch and the share
    of JAX's keypoints without a port keypoint on the same level within
    1e-3 px are printed. On this frame both are measured at 0 (counts
    156 and 156), and held there; thresholds and NMS can turn ulp
    differences into flips on other inputs (tests/test_torch_build.py
    measures 2–3.5% on tie-rich synthetic squares)."""
    kps, _, _ = detect_keypoints(torch_ss, TCFG, CAP)
    jk = jax_ref["kps"]
    jv = np.asarray(jk.valid)
    tv = kps.valid.numpy()
    n_j, n_t = int(jv.sum()), int(tv.sum())
    jxy = np.asarray(jk.xy)[jv]
    jl = np.asarray(jk.class_id)[jv]
    txy = kps.xy.numpy()[tv]
    tl = kps.class_id.numpy()[tv]
    d = np.abs(jxy[:, None, :] - txy[None, :, :]).max(-1)
    same = (d <= 1e-3) & (jl[:, None] == tl[None, :])
    miss = 1.0 - same.any(1).mean()
    print(f"keypoint counts: JAX {n_j}, port {n_t} (mismatch "
          f"{abs(n_j - n_t) / n_j:.4%}); JAX keypoints unmatched {miss:.4%}")
    assert n_j > 20 and n_t == n_j and miss == 0.0


def _jax_kps_and_stack(jax_ref):
    kps = convert.keypoints_from(jax_ref["kps"], device="cpu")
    packed = torch.from_numpy(
        np.asarray(jax_ref["packed"], np.float32)).to(torch.bfloat16)
    return kps, packed, torch.from_numpy(np.array(jax_ref["level_hw"]))


def test_orientation_matches_jax(jax_ref):
    """On JAX's own keypoints and stack: angles within 1e-4 rad (mod 2π)
    on ≥ 99% of keypoints (the argmax over 42 windows can flip on a
    near-tie)."""
    kps, packed, level_hw = _jax_kps_and_stack(jax_ref)
    got = compute_orientations(packed, level_hw, kps.xy, kps.size,
                               kps.class_id, kps.octave, kps.valid).numpy()
    ref = np.asarray(jax_ref["angle"])
    v = kps.valid.numpy()
    d = np.abs(got - ref)[v]
    d = np.minimum(d, 2 * np.pi - d)
    assert (d <= 1e-4).mean() >= 0.99


def test_mldb_matches_jax(jax_ref):
    """On JAX's keypoints, angles and stack: the descriptor-bit mismatch
    rate is printed, measured at 0 on this frame and held there. (Summing
    the cell means in the reference's order — a product with the
    averaging matrices, or a sequential sum over each cell's samples —
    measured 1 flipped bit of 76,128 here: the port keeps its block
    sums.)"""
    kps, packed, level_hw = _jax_kps_and_stack(jax_ref)
    angle = torch.from_numpy(np.array(jax_ref["angle"], np.float32))
    got = tmldb.mldb_descriptors(packed, level_hw, kps.xy, kps.size, angle,
                                 kps.class_id, kps.octave, kps.valid).numpy()
    ref = np.asarray(jax_ref["desc"])
    v = kps.valid.numpy()
    bits_g = np.unpackbits(got[v], axis=1)
    bits_r = np.unpackbits(ref[v], axis=1)
    rate = float((bits_g != bits_r).mean())
    print(f"descriptor bits differing: {rate:.6%} of {bits_g.size}")
    assert v.sum() > 20 and rate == 0.0
    assert not got[~v].any()


def test_capacity_slots_equal_the_live_prefix():
    """detect_and_compute_batch runs orientation and MLDB on every slot of
    the capacity, reading nothing back to the host: the bits equal those
    of the live prefix alone (the valid keypoints are a response-sorted
    prefix, and both stages zero the invalid slots), for a batch whose
    images have different counts."""
    from cubesat_apds_tpu_torch.ops.features import akaze as takaze

    cap = 1024
    imgs = torch.stack([torch.from_numpy(_frame(s)) for s in (7, 3)])
    kps, packed, level_hw, _ = takaze._front_end(imgs, TCFG, cap, None)
    counts = kps.valid.sum(-1)
    n_live = int(counts.max())
    assert 0 < n_live < cap and int(counts.min()) < n_live
    a_full, d_full = takaze.orient_describe(kps, packed, level_hw, cap)
    a_pre, d_pre = takaze.orient_describe(kps, packed, level_hw, n_live)
    assert torch.equal(a_full, a_pre) and torch.equal(d_full, d_pre)
    f = takaze.detect_and_compute_batch(imgs, TCFG, cap)
    assert torch.equal(f.keypoints.angle, a_full)
    assert torch.equal(f.descriptors, d_full)


def test_mldb_cell_means_equal_averaging_matrices():
    """The block-sum cell means equal the product with the static
    averaging matrices of _grid_geometry (copied from the JAX package)."""
    rng = np.random.default_rng(5)
    samples = torch.from_numpy(rng.standard_normal((8, 441, 3)).astype(
        np.float32))
    for g in range(3):
        ref = np.einsum("cs,ksd->kcd", tmldb._AVG_MATS[g].astype(np.float64),
                        samples.numpy().astype(np.float64))
        np.testing.assert_allclose(tmldb._cell_means(samples, g).numpy(),
                                   ref, atol=1e-5)
