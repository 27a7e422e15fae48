"""Parity of the port's host helpers with the JAX package's copies
(utils/progress.py, utils/viz.py): the counterparts of
tests/test_stream_utils.py's progress and viz checks.

The same seeded numpy inputs go through both packages; the port's
drawing functions also take torch tensors. Drawn images and decoded
pixels are held bit-exact; a progress bar's text is held equal once its
rate, a wall-clock reading, is masked.
"""

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
