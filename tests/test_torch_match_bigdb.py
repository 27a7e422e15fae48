"""The port's big-DB matching against the JAX package, bit for bit: the
kNN-2 twin (`knn2_blockwise`) against JAX's `knn2_blockwise` and its Pallas
kernel run by the interpreter, the kernel's layout, the big-DB branch of
`knn_match`, and the remaining dense functions (`knn_match_bits`,
`knn_matches_k`, `crosscheck_match`). Inputs come from numpy seeds at
Q ≈ 100, M ≈ 3,000 with DB blocks of 256 and 512 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubesat_apds_tpu.ops import match as jmatch
from cubesat_apds_tpu.ops.pallas import match_kernel as jmk
from cubesat_apds_tpu_torch.core.config import MatchConfig, PipelineConfig
from cubesat_apds_tpu_torch.core.types import CameraModel, Features, Keypoints
from cubesat_apds_tpu_torch.ops import match as tmatch
from cubesat_apds_tpu_torch.ops.kernels import match_kernel as tmk
from cubesat_apds_tpu_torch.pipelines.localize import (
    DeviceDb, Localizer, localize_from_features)

torch.set_num_threads(2)

Q, M = 100, 3000
INVALID = np.float32(3.0e38)


@pytest.fixture(scope="module")
def data():
    """Queries near DB rows, exact duplicates across block edges (ties:
    the lowest index must win, the duplicate stays second-best), and
    validity holes on both sides."""
    rng = np.random.default_rng(21)
    db = rng.integers(0, 256, (M, 61), dtype=np.uint8)
    noise = (rng.integers(0, 256, (Q, 61), dtype=np.uint8)
             & (rng.random((Q, 61)) < 0.04).astype(np.uint8) * 255)
    q = db[rng.integers(0, M, Q)] ^ noise
    q[0] = db[255]
    db[256] = db[255]                    # tie across a block edge
    db[2900] = db[255]
    q[1] = db[40]
    db[41] = db[40]                      # tie inside one block
    db_valid = rng.random(M) > 0.05
    db_valid[[255, 256, 2900, 40, 41]] = True
    q_valid = rng.random(Q) > 0.1
    q_valid[:2] = True
    return q, db, q_valid, db_valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref, names=("d0", "d1", "i0")):
    for name, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("block", [256, 512])
@pytest.mark.parametrize("width", ["packed", "unpacked"])
@pytest.mark.parametrize("holes", [False, True])
def test_twin_matches_jax_blockwise(data, block, width, holes):
    """knn2_blockwise on packed 61-byte rows or unpacked int8 bits, with
    and without validity holes, M = 3,000 ragged against the block."""
    q, db, _, dv = data
    dv = dv if holes else None
    qb_j = jmatch.unpack_bits(q)
    db_j = jnp.asarray(db) if width == "packed" else jmatch.unpack_bits(db)
    ref = jmatch.knn2_blockwise(qb_j, db_j, block,
                                None if dv is None else jnp.asarray(dv))
    db_t = _t(db) if width == "packed" else tmatch.unpack_bits(_t(db))
    got = tmatch.knn2_blockwise(tmatch.unpack_bits(_t(q)), db_t, block,
                                None if dv is None else _t(dv))
    _eq(got, ref)


@pytest.mark.parametrize("holes", [False, True])
def test_fused_twin_matches_jax_kernel_interpret(data, holes):
    """The port's knn2_fused on CPU tensors (the twin) against the JAX
    package's Pallas kernel run by the interpreter."""
    q, db, _, dv = data
    dv = dv if holes else None
    ref = jmk.knn2_fused(jmatch.unpack_bits(q), jmk.pack_words(db),
                         None if dv is None else jnp.asarray(dv),
                         q_tile=32, db_block=256, interpret=True)
    got = tmk.knn2_fused(tmk.pack_words(_t(q)), tmk.pack_words(_t(db)),
                         None if dv is None else _t(dv), block=512)
    _eq(got, ref)


def test_layout_matches_jax_and_words_form(data):
    """layout_db_blocks: the same vpop plane as the JAX layout (popcount
    for valid rows, the 2^29 + 1024 sentinel for invalid ones), and the
    layout form of knn2_fused equals the words form."""
    q, db, _, dv = data
    words, vpop = tmk.layout_db_blocks(tmk.pack_words(_t(db)), _t(dv))
    _, jvpop = jmk.layout_db_blocks(jmk.pack_words(db), jnp.asarray(dv),
                                    db_block=256)
    np.testing.assert_array_equal(vpop.numpy(),
                                  np.asarray(jvpop).reshape(-1)[:M])
    np.testing.assert_array_equal(words.numpy(), np.asarray(jmk.pack_words(db)))
    qw = tmk.pack_words(_t(q))
    _eq(tmk.knn2_fused(qw, (words, vpop), block=256),
        tmk.knn2_fused(qw, tmk.pack_words(_t(db)), _t(dv), block=256))


def test_pack_words_bit_order():
    """pack_words bit-exact with the JAX package's, and bit 32·w + b of a
    descriptor is bit b of little-endian word w (unpack_bits' order)."""
    p = np.random.default_rng(5).integers(0, 256, (16, 61), dtype=np.uint8)
    words = tmk.pack_words(_t(p)).numpy()
    np.testing.assert_array_equal(words, np.asarray(jmk.pack_words(p)))
    bits = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(bits.reshape(16, 512),
                                  tmatch.unpack_bits(_t(p)).numpy())


@pytest.mark.parametrize("block", [128, 256])
def test_ties_lowest_index_and_second_best(data, block):
    """Duplicated rows: the lowest index wins, across blocks too, and the
    second-best excludes only the winning row (an equal distance at
    another index counts). Against JAX's dense knn2 (one block)."""
    q, db, _, _ = data
    ref = jmatch.knn2(jmatch.unpack_bits(q), jmatch.unpack_bits(db))
    got = tmatch.knn2_blockwise(tmatch.unpack_bits(_t(q)), _t(db), block)
    _eq(got, ref)
    d0, d1, i0 = (t.numpy() for t in got)
    assert (i0[0], d0[0], d1[0]) == (255, 0.0, 0.0)
    assert (i0[1], d0[1], d1[1]) == (40, 0.0, 0.0)
    assert (d1 >= d0).all()


def test_second_best_of_a_unique_hit(data):
    """A query whose exact hit is unique keeps d1 > 0: the winner is
    excluded from the second place and nothing else."""
    q, db, _, _ = data
    qq = db[[7, 1234]]
    got = tmatch.knn2_blockwise(tmatch.unpack_bits(_t(qq)), _t(db), 256)
    ref = jmatch.knn2_blockwise(jmatch.unpack_bits(qq), jnp.asarray(db), 256)
    _eq(got, ref)
    d0, d1, i0 = (t.numpy() for t in got)
    assert list(i0) == [7, 1234] and (d0 == 0).all() and (d1 > 0).all()


@pytest.mark.parametrize("block", [256, 512])
def test_all_invalid_db(data, block):
    """No valid row: d0 = d1 = 3.0e38 and i0 = 0, as in JAX."""
    q, db, _, _ = data
    dv = np.zeros(M, bool)
    ref = jmatch.knn2_blockwise(jmatch.unpack_bits(q), jnp.asarray(db), block,
                                jnp.asarray(dv))
    got = tmatch.knn2_blockwise(tmatch.unpack_bits(_t(q)), _t(db), block,
                                _t(dv))
    _eq(got, ref)
    d0, d1, i0 = (t.numpy() for t in got)
    assert (d0 == INVALID).all() and (d1 == INVALID).all() and (i0 == 0).all()


@pytest.mark.parametrize("m", [257, 2999, 3001])
def test_ragged_db(data, m):
    """M not a multiple of the block: the tail pads with invalid rows."""
    q, _, _, _ = data
    db = np.random.default_rng(m).integers(0, 256, (m, 61), dtype=np.uint8)
    dv = np.random.default_rng(m + 1).random(m) > 0.2
    ref = jmatch.knn2_blockwise(jmatch.unpack_bits(q), jnp.asarray(db), 256,
                                jnp.asarray(dv))
    got = tmatch.knn2_blockwise(tmatch.unpack_bits(_t(q)), _t(db), 256,
                                _t(dv))
    _eq(got, ref)
    assert dv[got[2].numpy()].all()


@pytest.mark.parametrize("bad", ["uint8_512", "width_100"])
def test_db_width_rules(data, bad):
    """Width 512 in uint8 is ambiguous and any width other than ≤64
    packed or 512 unpacked is refused, as in JAX."""
    q, db, _, _ = data
    if bad == "uint8_512":
        db_t = tmatch.unpack_bits(_t(db)).to(torch.uint8)
    else:
        db_t = torch.zeros((M, 100), dtype=torch.int8)
    with pytest.raises(ValueError):
        tmatch.knn2_blockwise(tmatch.unpack_bits(_t(q)), db_t, 256)
    with pytest.raises(ValueError):
        jmatch.knn2_blockwise(jmatch.unpack_bits(q), jnp.asarray(db_t.numpy()),
                              256)


@pytest.mark.parametrize("kernel,layout", [("auto", False), ("auto", True),
                                           ("fused", False), ("scan", False)])
def test_knn_match_big_db_matches_jax_scan(data, kernel, layout):
    """knn_match's big-DB branch (M > block) against JAX
    knn_match(kernel="scan"), every field bit-exact; `q_valid` masks d0
    only there, so a masked query has distance 3.0e38 and no match."""
    q, db, qv, dv = data
    ref = jmatch.knn_match(jnp.asarray(q), jnp.asarray(db), ratio=0.8,
                           q_valid=jnp.asarray(qv), db_valid=jnp.asarray(dv),
                           block=512, kernel="scan")
    db_layout = (tmk.layout_db_blocks(tmk.pack_words(_t(db)), _t(dv))
                 if layout else None)
    got = tmatch.knn_match(_t(q), _t(db), ratio=0.8, q_valid=_t(qv),
                           db_valid=_t(dv), block=512, kernel=kernel,
                           db_layout=db_layout)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert (got.distance.numpy()[~qv] == INVALID).all()
    assert not got.valid.numpy()[~qv].any() and got.valid.any()


def test_knn_match_refuses_unknown_kernel(data):
    q, db, _, _ = data
    with pytest.raises(ValueError):
        tmatch.knn_match(_t(q), _t(db), block=512, kernel="pallas")


@pytest.mark.parametrize("k", [1, 2, 5])
def test_knn_matches_k_matches_jax(data, k):
    q, db, qv, dv = data
    ref = jmatch.knn_matches_k(q, db, k, q_valid=jnp.asarray(qv),
                               db_valid=jnp.asarray(dv))
    got = tmatch.knn_matches_k(_t(q), _t(db), k, q_valid=_t(qv),
                               db_valid=_t(dv))
    _eq(got, ref, ("distances", "indices"))


@pytest.mark.parametrize("masks", [False, True])
def test_crosscheck_match_matches_jax(data, masks):
    q, db, qv, dv = data
    kw_j = dict(q_valid=jnp.asarray(qv), db_valid=jnp.asarray(dv)) \
        if masks else {}
    kw_t = dict(q_valid=_t(qv), db_valid=_t(dv)) if masks else {}
    ref = jmatch.crosscheck_match(q, db, **kw_j)
    got = tmatch.crosscheck_match(_t(q), _t(db), **kw_t)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.valid.any()


@pytest.mark.parametrize("q_block", [None, 32])
def test_knn_match_bits_matches_jax(data, q_block):
    q, db, qv, dv = data
    ref = jmatch.knn_match_bits(jmatch.unpack_bits(q), jmatch.unpack_bits(db),
                                0.8, jnp.asarray(qv), jnp.asarray(dv),
                                q_block=q_block)
    got = tmatch.knn_match_bits(tmatch.unpack_bits(_t(q)),
                                tmatch.unpack_bits(_t(db)), 0.8, _t(qv),
                                _t(dv), q_block=q_block)
    for f in ("query_idx", "train_idx", "distance", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_localizer_big_db_on_cpu_equals_scan(data):
    """A DB past db_block through localize_from_features on the CPU: the
    kernel route (twin on the CPU) and kernel="scan" give the same
    matches, and no kernel layout is made off the card."""
    q, db, qv, dv = data
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 500, (M, 2)).astype(np.float32)
    tdb = DeviceDb(descriptors=_t(db), xy=_t(xy), valid=_t(dv),
                   obj_points=torch.zeros(M, 3), has_world=False)
    qxy = rng.uniform(0, 500, (Q, 2)).astype(np.float32)
    kp = Keypoints(xy=_t(qxy), size=torch.ones(Q), angle=torch.zeros(Q),
                   response=torch.ones(Q), octave=torch.zeros(Q, dtype=torch.int32),
                   class_id=torch.zeros(Q, dtype=torch.int32), valid=_t(qv))
    feats = Features(keypoints=kp, descriptors=_t(q))
    cam = CameraModel.ideal(300.0, 300.0, 250.0, 250.0)
    out = {}
    for kernel in ("auto", "scan"):
        cfg = PipelineConfig(match=MatchConfig(ratio=0.8, db_block=512,
                                               kernel=kernel))
        loc = Localizer(tdb, cam, cfg, device="cpu")
        assert loc.db.match_layout is None
        out[kernel] = localize_from_features(feats, loc.db, loc.camera, cfg,
                                             solve_pose=False).matches
    for f in ("train_idx", "distance", "valid"):
        assert torch.equal(getattr(out["auto"], f), getattr(out["scan"], f)), f
