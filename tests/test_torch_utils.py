"""Parity of the port's host helpers with the JAX package's copies
(utils/progress.py, utils/viz.py): the counterparts of
tests/test_stream_utils.py's progress and viz checks; and public names
that the port keeps at the JAX package's module paths.

The same seeded numpy inputs go through both packages; the port's
drawing functions also take torch tensors. Drawn images and decoded
pixels are held bit-exact; a progress bar's text is held equal once its
rate, a wall-clock reading, is masked.
"""

import importlib
import inspect
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cubesat_apds_tpu.utils import progress as jprogress
from cubesat_apds_tpu.utils import viz as jviz
from cubesat_apds_tpu_torch import cli
from cubesat_apds_tpu_torch.utils import progress, viz


def _bar_text(mod, total, incs, finish):
    buf = io.StringIO()
    bar = mod.ProgressBar(total, "lod 2", width=20, stream=buf)
    for k in incs:
        bar.inc(k)
    if finish:
        bar.finish()
    return re.sub(r"\([0-9.]+/s\)", "(RATE)", buf.getvalue()), bar.n


@pytest.mark.parametrize("total,incs,finish", [
    (10, [1] * 10, False),
    (7, [3, 3, 3], False),
    (5, [1, 1], True),
])
def test_progress_bar_equals_jax(total, incs, finish):
    text, n = _bar_text(progress, total, incs, finish)
    jtext, jn = _bar_text(jprogress, total, incs, finish)
    assert (text, n) == (jtext, jn)
    assert f"{total}/{total}" in text and text.endswith("\n")


def test_multi_progress_quiet_writes_nothing(capsys):
    mp = progress.MultiProgress(quiet=True)
    bars = [mp.add(4, f"lod {i}") for i in range(3)]
    for b in bars:
        b.inc(4)
    assert [b.n for b in mp.bars] == [4, 4, 4]
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("as_tensor", [False, True])
def test_viz_draw_keypoints_equals_jax(rng, tmp_path, as_tensor):
    img = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    xy = rng.uniform(5, 59, (10, 2)).astype(np.float32)
    valid = rng.uniform(size=10) > 0.3
    want = jviz.draw_keypoints(img, xy, valid)
    args = ((torch.from_numpy(img), torch.from_numpy(xy),
             torch.from_numpy(valid)) if as_tensor else (img, xy, valid))
    out = viz.draw_keypoints(*args)
    np.testing.assert_array_equal(out, want)
    viz.write_image(str(tmp_path / "kp.png"), out)
    back = viz.read_image_gray(str(tmp_path / "kp.png"))
    np.testing.assert_array_equal(
        back, jviz.read_image_gray(str(tmp_path / "kp.png")))
    np.testing.assert_array_equal(back, cli._load_gray(str(tmp_path
                                                           / "kp.png")))
    assert back.shape == (64, 64)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_viz_draw_matches_equals_jax(rng, as_tensor):
    img1 = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    img2 = rng.uniform(0, 1, (64, 80)).astype(np.float32)
    kp1 = rng.uniform(5, 59, (6, 2)).astype(np.float32)
    kp2 = rng.uniform(5, 59, (6, 2)).astype(np.float32)
    q, t = np.arange(6), rng.permutation(6)
    want = jviz.draw_matches(img1, kp1, img2, kp2, q, t)
    T = torch.from_numpy
    args = ((T(img1), T(kp1), T(img2), T(kp2), T(q), T(t)) if as_tensor
            else (img1, kp1, img2, kp2, q, t))
    out = viz.draw_matches(*args)
    assert out.shape == (64, 144, 3)
    np.testing.assert_array_equal(out, want)


def test_export_matches_equals_jax(rng, tmp_path):
    img = rng.uniform(0, 1, (48, 48)).astype(np.float32)
    xy1 = rng.uniform(4, 44, (8, 2)).astype(np.float32)
    xy2 = rng.uniform(4, 44, (8, 2)).astype(np.float32)
    valid = rng.uniform(size=8) > 0.25

    def feats(xy, T):
        return SimpleNamespace(keypoints=SimpleNamespace(xy=T(xy)))

    def matches(T):
        return SimpleNamespace(query_idx=T(np.arange(8)),
                               train_idx=T(np.arange(8)[::-1].copy()),
                               valid=T(valid))

    ident = np.asarray
    want = jviz.export_matches(img, feats(xy1, ident), img,
                               feats(xy2, ident), matches(ident),
                               str(tmp_path / "j.png"))
    T = torch.from_numpy
    out = viz.export_matches(T(img), feats(xy1, T), T(img), feats(xy2, T),
                             matches(T), str(tmp_path / "t.png"))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(viz.read_image_gray(str(tmp_path / "t.png")),
                                  viz.read_image_gray(str(tmp_path / "j.png")))


@pytest.mark.parametrize("module,name", [
    ("ops.features.scale_space", "nld_step"),
    ("ops.features.scale_space", "fed_cycle"),
    ("utils.profiling", "time_jitted"),
])
def test_public_names_at_jax_module_paths(module, name):
    """A name the JAX package defines in `module` imports from the port's
    module of the same path, with the same parameters."""
    jfn = getattr(importlib.import_module(f"cubesat_apds_tpu.{module}"), name)
    tfn = getattr(importlib.import_module(f"cubesat_apds_tpu_torch.{module}"),
                  name)
    assert list(inspect.signature(tfn).parameters) == \
        list(inspect.signature(jfn).parameters)


def test_scale_space_steps_are_the_kernel_twins():
    """scale_space.nld_step and fed_cycle are kernel A's plain twins
    (ops/kernels/diffusion.py), and agree with the JAX package's within
    tests/test_torch_features.py's atol 1e-5 (XLA fuses the stencil's
    sums in another order)."""
    from cubesat_apds_tpu.ops.features import scale_space as jss
    from cubesat_apds_tpu_torch.ops.features import scale_space as tss
    from cubesat_apds_tpu_torch.ops.kernels import diffusion

    assert tss.nld_step is diffusion.nld_step
    assert tss.fed_cycle is diffusion.fed_cycle
    rng = np.random.default_rng(5)
    L = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    g = rng.uniform(0.2, 1, (24, 32)).astype(np.float32)
    taus = jss.fed_tau_by_process_time(1.0)
    got = tss.fed_cycle(torch.from_numpy(L), torch.from_numpy(g), taus)
    np.testing.assert_allclose(got.numpy(), np.asarray(jss.fed_cycle(
        L, g, taus)), atol=1e-5)
    one = tss.nld_step(torch.from_numpy(L), torch.from_numpy(g), taus[0])
    np.testing.assert_allclose(one.numpy(), np.asarray(jss.nld_step(
        L, g, taus[0])), atol=1e-5)


def test_time_jitted_times_a_call():
    """time_jitted returns the seconds per call of a steady state, after
    its warm-up calls, on the CPU as the JAX package's does."""
    from cubesat_apds_tpu_torch.utils.profiling import time_jitted

    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0, (x + 1.0, x - 1.0)

    t = time_jitted(fn, torch.ones(64), iters=5, warmup=2)
    assert t > 0.0 and len(calls) == 7
