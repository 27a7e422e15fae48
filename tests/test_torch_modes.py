"""Parity of the port's approximate descriptor modes with the JAX package:
the blur-matched stacks, fast orientation, and the fast and hybrid MLDB
descriptors, on the same seeded numpy inputs through both packages.

The JAX side runs its scale space and detection once (jitted) and builds
each mode's stacks, orientations and descriptors as its
detect_and_compute does (`_prepare` and `_orient_describe`), stage by
stage; the port runs its own stages on JAX's arrays and end to end. Each
test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.core.config import AkazeConfig as JAkazeConfig
from cubesat_apds_tpu.ops import resample as jres
from cubesat_apds_tpu.ops.features import akaze as jakaze
from cubesat_apds_tpu.ops.features import mldb as jmldb
from cubesat_apds_tpu.ops.features import scale_space as jss
from cubesat_apds_tpu.ops.features.detect import detect_keypoints as jdetect
from cubesat_apds_tpu.ops.features.orientation import (
    compute_orientations as jorient)
from cubesat_apds_tpu_torch import convert
from cubesat_apds_tpu_torch.core.config import AkazeConfig, PipelineConfig
from cubesat_apds_tpu_torch.ops import resample as tres
from cubesat_apds_tpu_torch.ops.features import akaze as takaze
from cubesat_apds_tpu_torch.ops.features import mldb as tmldb
from cubesat_apds_tpu_torch.ops.features.orientation import (
    compute_orientations)
from cubesat_apds_tpu_torch.ops.features.scale_space import ScaleSpace

torch.set_num_threads(2)

N = 128
CAP = 256
# Two octaves: the frame's keypoints all lie on levels 0-7, and the eager
# JAX reference's cost grows with the number of levels.
OCTAVES = 2
MODES = {  # name: AkazeConfig keywords (the accuracy runner's pairs)
    "fast": dict(descriptor_mode="fast", orientation_mode="fast"),
    "hybrid2": dict(descriptor_mode="hybrid", hybrid_subcells=2),
    "hybrid3": dict(descriptor_mode="hybrid", hybrid_subcells=3),
}


def _frame(seed, n=N):
    """bench.py's corner-rich synthetic frame, at n×n."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(120 * n * n // (512 * 512) + 30):
        cy, cx = rng.integers(4, n - 20, 2)
        s = int(rng.integers(4, 20))
        img[cy:cy + s, cx:cx + s] = rng.uniform(0.2, 1.0)
    return img


def _jax_combined(lt, lx, ly, meta, cfg):
    """JAX's blur-matched [3L, H, W, 4] stack, as its _prepare builds it."""
    sigmas_fn = jmldb.approx_blur_sigmas_fn(cfg)
    base3 = [jnp.stack([lt[i], lx[i], ly[i]]) for i in range(len(lt))]
    grids = []
    for g in range(3):
        blurred = [jres.gaussian_blur(base3[i], sigmas_fn(m.sigma_size)[g])
                   for i, m in enumerate(meta)]
        grids.append(jakaze._packed_stack([b[0] for b in blurred],
                                          [b[1] for b in blurred],
                                          [b[2] for b in blurred]))
    return jnp.concatenate(grids, axis=0)


@pytest.fixture(scope="module")
def img():
    return _frame(7)


@pytest.fixture(scope="module")
def jax_ref(img):
    """JAX's front end once (mode-independent), then each mode's stack,
    angles and descriptors on JAX's own keypoints."""
    base = JAkazeConfig(capacity=CAP, octaves=OCTAVES, detect_topk="exact")

    @jax.jit
    def front(x):
        ss = jss.build_scale_space(x, base)
        kps, lx, ly = jdetect(ss, base, CAP)
        packed = jakaze._packed_stack(ss.Lt, lx, ly)
        level_hw = jnp.asarray([a.shape for a in ss.Lt], jnp.int32)
        return ss.Lt, lx, ly, kps, packed, level_hw

    lt, lx, ly, kps, packed, level_hw = front(jnp.asarray(img))
    meta = jss.evolution_metadata(base)
    # Jitted orientations are bit-equal to eager ones here; the blurs and
    # descriptors stay eager (jitted, XLA orders their sums otherwise).
    orient = {m: jax.jit(functools.partial(jorient, mode=m))
              for m in ("exact", "fast")}
    ref = dict(Lt=lt, lx=lx, ly=ly, kps=kps, packed=packed,
               level_hw=level_hw, meta=meta)
    for name, kw in MODES.items():
        cfg = JAkazeConfig(capacity=CAP, octaves=OCTAVES,
                           detect_topk="exact", **kw)
        combined = _jax_combined(lt, lx, ly, meta, cfg)
        angle = orient[cfg.orientation_mode](packed, level_hw, kps.xy,
                                             kps.size, kps.class_id,
                                             kps.octave, kps.valid)
        desc = jmldb.approx_mldb_fn(cfg)(
            combined, level_hw, len(lt), kps.xy, kps.size, angle,
            kps.class_id, kps.octave, kps.valid)
        ref[name] = jax.device_get(dict(combined=combined, angle=angle,
                                        desc=desc))
    return jax.device_get(ref)


def _tcfg(name, **kw):
    return AkazeConfig(capacity=CAP, octaves=OCTAVES, **MODES[name], **kw)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jax_kps(jax_ref):
    return convert.keypoints_from(jax_ref["kps"], device="cpu")


def _bits_differing(got, ref, valid):
    bg = np.unpackbits(got[valid], axis=1)
    br = np.unpackbits(ref[valid], axis=1)
    return float((bg != br).mean()), bg.size


# ---- config and blurs ------------------------------------------------------


def test_mode_config_validation_and_tags_match_jax():
    """descriptor_mode, orientation_mode and hybrid_subcells validate and
    tag as in the JAX package."""
    for kw in (dict(), dict(descriptor_mode="fast", orientation_mode="fast"),
               dict(descriptor_mode="hybrid", hybrid_subcells=3)):
        assert AkazeConfig(**kw).descriptor_tag == \
            JAkazeConfig(**kw).descriptor_tag
    for bad in (dict(descriptor_mode="fastest"),
                dict(orientation_mode="hybrid"),
                dict(descriptor_mode="hybrid", hybrid_subcells=1)):
        with pytest.raises(ValueError):
            JAkazeConfig(**bad)
        with pytest.raises(ValueError):
            AkazeConfig(**bad)


@pytest.mark.parametrize("op", ["blur11.5", "blur_ms3", "blur_ms9.7",
                                "blur_ms_odd"])
def test_gaussian_blurs_match_jax(img, op):
    """gaussian_blur at a grid-sized σ and gaussian_blur_ms (one and two
    2× round trips, an odd-sized input), atol 1e-5: the same taps and
    terms in the same order; XLA may fuse the sums in another order."""
    x = np.stack([img, img[::-1], img.T])
    sigma = {"blur11.5": 11.5, "blur_ms3": 3.0, "blur_ms9.7": 9.7,
             "blur_ms_odd": 6.0}[op]
    if op == "blur_ms_odd":
        x = x[:, :125, :99]
    fn = "gaussian_blur" if op.startswith("blur1") else "gaussian_blur_ms"
    ref = getattr(jres, fn)(jnp.asarray(x), sigma)
    got = getattr(tres, fn)(torch.from_numpy(np.ascontiguousarray(x)),
                            sigma)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", list(MODES))
def test_combined_stack_matches_jax(jax_ref, name):
    """The port's three grid stacks built from JAX's level images equal
    JAX's [3L, H, W, 4] stack: the float32 blurs agree within 1e-5 (the
    blur test's tolerance) before the bf16 rounding, so an element may
    round one bf16 step apart; measured and held: ≥ 99.9% equal bits,
    the rest within 1/128 relative."""
    lt = [torch.from_numpy(np.array(a))[None] for a in jax_ref["Lt"]]
    lx = [torch.from_numpy(np.array(a))[None] for a in jax_ref["lx"]]
    ly = [torch.from_numpy(np.array(a))[None] for a in jax_ref["ly"]]
    ss = ScaleSpace(Lt=lt, Lsmooth=None, meta=jax_ref["meta"],
                    kcontrast=None)
    grids = takaze._grid_stacks(ss, lx, ly, _tcfg(name))
    got = torch.cat([g[0] for g in grids]).float().numpy()
    ref = np.asarray(jax_ref[name]["combined"], np.float32)
    assert got.shape == ref.shape
    same = got == ref
    print(f"{name}: {same.mean():.6%} of the stack's values bit-equal")
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got, ref, rtol=1.0 / 128, atol=1e-30)


# ---- orientation and descriptors on JAX's stack ---------------------------


def test_fast_orientation_matches_jax(jax_ref):
    """The 57-point disc on JAX's keypoints and stack: angles within 1e-4
    rad (mod 2π) on ≥ 99% of keypoints, exact mode's tolerance."""
    kps = _jax_kps(jax_ref)
    got = compute_orientations(
        _bf16(jax_ref["packed"]), torch.from_numpy(
            np.array(jax_ref["level_hw"])), kps.xy, kps.size, kps.class_id,
        kps.octave, kps.valid, mode="fast").numpy()
    ref = np.asarray(jax_ref["fast"]["angle"])
    v = kps.valid.numpy()
    d = np.abs(got - ref)[v]
    d = np.minimum(d, 2 * np.pi - d)
    print(f"fast orientation: {(d <= 1e-4).mean():.4%} within 1e-4 rad")
    assert v.sum() > 20 and (d <= 1e-4).mean() >= 0.99


@pytest.mark.parametrize("name", list(MODES))
def test_approx_descriptors_match_jax_bit_exact(jax_ref, name):
    """mldb_descriptors_fast / _hybrid on JAX's [3L, H, W, 4] stack (cut
    into its three per-grid [L, H, W, 4] stacks), keypoints and angles:
    bit-exact, as exact mode is held (test_torch_features.py). Invalid
    slots are zeros."""
    kps = _jax_kps(jax_ref)
    level_hw = torch.from_numpy(np.array(jax_ref["level_hw"]))
    angle = torch.from_numpy(np.array(jax_ref[name]["angle"], np.float32))
    n_lvl = len(jax_ref["Lt"])
    combined = _bf16(jax_ref[name]["combined"])
    grids = tuple(combined[g * n_lvl:(g + 1) * n_lvl] for g in range(3))
    fn = tmldb.approx_mldb_fn(_tcfg(name))
    got = fn(grids, level_hw, kps.xy, kps.size, angle, kps.class_id,
             kps.octave, kps.valid).numpy()
    ref = np.asarray(jax_ref[name]["desc"])
    v = kps.valid.numpy()
    rate, n = _bits_differing(got, ref, v)
    print(f"{name}: descriptor bits differing {rate:.6%} of {n}")
    assert v.sum() > 20 and rate == 0.0
    assert not got[~v].any()


@pytest.mark.parametrize("name", list(MODES))
def test_public_approx_descriptors_take_jax_combined_stack(jax_ref, name):
    """mldb_descriptors_fast / _hybrid called with the JAX package's
    arguments (combined_stack [3L, H, W, 4], level_hw, n_levels, xy,
    size, angle, class_id, octave, valid[, sub]) on JAX's stack,
    keypoints and angles: bit-exact with JAX's descriptors. The stack's
    three grid parts are contiguous views, kernel B's input as it is."""
    kps = _jax_kps(jax_ref)
    level_hw = torch.from_numpy(np.array(jax_ref["level_hw"]))
    angle = torch.from_numpy(np.array(jax_ref[name]["angle"], np.float32))
    n_lvl = len(jax_ref["Lt"])
    combined = _bf16(jax_ref[name]["combined"])
    grids = tmldb.split_grids(combined, n_lvl)
    assert all(g.is_contiguous() and g.shape[0] == n_lvl for g in grids)
    args = (combined, level_hw, n_lvl, kps.xy, kps.size, angle,
            kps.class_id, kps.octave, kps.valid)
    if name == "fast":
        got = tmldb.mldb_descriptors_fast(*args)
    else:
        got = tmldb.mldb_descriptors_hybrid(
            *args, sub=MODES[name]["hybrid_subcells"])
    got = got.numpy()
    ref = np.asarray(jax_ref[name]["desc"])
    v = kps.valid.numpy()
    rate, n = _bits_differing(got, ref, v)
    assert v.sum() > 20 and rate == 0.0
    assert not got[~v].any()


@pytest.mark.parametrize("name", list(MODES))
def test_detect_and_compute_modes_end_to_end(img, jax_ref, name):
    """The port's detect_and_compute on the 128² frame in each mode
    against JAX's stages on the same frame, test_torch_features.py's
    tolerances: equal counts, every JAX keypoint within 1e-3 px on the
    same level, angles within 1e-4 rad on ≥ 99%, and no descriptor bit
    differing on the keypoints whose angles agree to 1e-4."""
    f = takaze.detect_and_compute(torch.from_numpy(img), _tcfg(name))
    kp = f.keypoints
    jk = jax_ref["kps"]
    jv = np.asarray(jk.valid)
    tv = kp.valid.numpy()
    assert tv.sum() == jv.sum() > 20
    np.testing.assert_array_equal(kp.class_id.numpy()[tv],
                                  np.asarray(jk.class_id)[jv])
    np.testing.assert_allclose(kp.xy.numpy()[tv], np.asarray(jk.xy)[jv],
                               atol=1e-3)
    d = np.abs(kp.angle.numpy()[tv] - np.asarray(jax_ref[name]["angle"])[jv])
    d = np.minimum(d, 2 * np.pi - d)
    close = d <= 1e-4
    assert close.mean() >= 0.99
    desc = f.descriptors.numpy()[tv][close]
    ref = np.asarray(jax_ref[name]["desc"])[jv][close]
    rate, n = _bits_differing(desc, ref, np.ones(len(desc), bool))
    print(f"{name}: end to end, angles within 1e-4 {close.mean():.4%}, "
          f"descriptor bits differing {rate:.6%} of {n}")
    assert rate == 0.0


def test_modes_batch_equals_single(img):
    """A batch of two frames in hybrid mode: each image's features equal
    its lone detect_and_compute's, bit for bit (the grid stacks fold the
    batch into the sampler's stack axis)."""
    cfg = _tcfg("hybrid2")
    imgs = torch.stack([torch.from_numpy(img),
                        torch.from_numpy(_frame(3))])
    fb = takaze.detect_and_compute_batch(imgs, cfg)
    for b in range(2):
        f1 = takaze.detect_and_compute(imgs[b], cfg)
        assert torch.equal(fb.descriptors[b], f1.descriptors)
        assert torch.equal(fb.keypoints.angle[b], f1.keypoints.angle)


# ---- provenance and a served scene ----------------------------------------


def test_descriptor_tag_provenance_through_preprocess(tmp_path, img):
    """A store built in fast mode records "fast"; check_descriptor_mode
    accepts a fast config against it and refuses exact and hybrid; a
    hybrid3 store refuses hybrid2."""
    from cubesat_apds_tpu_torch.io.mosaic import MosaicDataset
    from cubesat_apds_tpu_torch.io.tiff import write_geotiff
    from cubesat_apds_tpu_torch.pipelines.localize import (
        check_descriptor_mode)
    from cubesat_apds_tpu_torch.pipelines.preprocess import preprocess

    rgb = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
    write_geotiff(str(tmp_path / "m.tif"), rgb,
                  [10.0, 1e-5, 0.0, 56.0, 0.0, -1e-5])
    ds = MosaicDataset.from_folder(str(tmp_path), device="cpu")
    stores = {}
    for name in ("fast", "hybrid3"):
        cfg = PipelineConfig(akaze=_tcfg(name))
        stores[name], stats = preprocess(ds, config=cfg, amount_lod=1)
        assert stats.keypoints > 20
        assert stores[name].descriptor_mode == cfg.akaze.descriptor_tag
        check_descriptor_mode(stores[name], cfg)
    assert stores["fast"].descriptor_mode == "fast"
    assert stores["hybrid3"].descriptor_mode == "hybrid3"
    for store, wrong in ((stores["fast"], AkazeConfig()),
                         (stores["fast"], _tcfg("hybrid2")),
                         (stores["hybrid3"], _tcfg("hybrid2"))):
        with pytest.raises(ValueError, match="descriptor_mode"):
            check_descriptor_mode(store, PipelineConfig(akaze=wrong))


@pytest.mark.parametrize("mode", ["fast", "hybrid"])
def test_one_accuracy_scene_per_mode(mode):
    """One known-pose nadir scene in each mode on the CPU, at
    test_torch_accuracy.py's cut (a 512² rects world at 1 m GSD, a 256²
    frame from 750 m at focal 750 px: the runner's field of view), the
    accuracy runner's mode config at capacity 512: the DB built in that
    mode by preprocess, the frame localized with pose and homography ok
    and within test_accuracy.py's nominal bounds (attitude < 1°,
    position < 25 m, footprint < 3 m)."""
    from cubesat_apds_tpu_torch.pipelines.localize import Localizer
    from cubesat_apds_tpu_torch.utils import accuracy as A
    from cubesat_apds_tpu_torch.utils import synthetic as S

    cfg = A.mode_config(mode, capacity=512)
    mosaic, plane, ds = A.build_world(7, device="cpu", mosaic_size=512)
    store = A.build_db(ds, cfg, progress=lambda s: None)
    cam = S.make_camera(mosaic.geotransform, plane, target_px=(256.0, 256.0),
                        altitude_m=750.0, focal_px=750.0, frame=256)
    frame, H_true = S.render_frame(mosaic.bands[0] / 255.0,
                                   mosaic.geotransform, plane, cam,
                                   device="cpu")
    loc = Localizer(store, A.camera_model(cam, "cpu"), cfg, device="cpu")
    res = loc.localize(frame, solve_pose=True)
    assert bool(res.pose.ok) and bool(res.homography.ok)
    att, pos = S.pose_errors(res.pose.rvec.numpy(), res.pose.tvec.numpy(),
                             cam)
    fp = S.footprint_error_m(res.homography.H.numpy().astype(np.float64),
                             H_true, cam)
    print(f"{mode}: attitude {att:.4f} deg, position {pos:.2f} m, "
          f"footprint {fp:.2f} m")
    assert att < 1.0 and pos < 25.0 and fp < 3.0
