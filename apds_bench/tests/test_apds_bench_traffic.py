"""The inputs and the arrival loops: the frame pool and the DB are the
same bits for one seed and differ for another; the open loop is periodic
at its file's rate; the closed loop stops on a batch boundary."""

import time

import numpy as np
import pytest
import torch

from apds_bench import inputs, spec
from apds_bench.tests import toy


@pytest.mark.parametrize("name", ["dunk-10k.backlog-b8", "dunk-1m.pruned-b8"])
def test_inputs_follow_the_seed(name):
    c = toy.cell(name)
    a = inputs.frame_pool(c.config, c.traffic, toy.SEED)
    b = inputs.frame_pool(c.config, c.traffic, toy.SEED)
    other = inputs.frame_pool(c.config, c.traffic, toy.SEED + 1)
    assert a.dtype == np.uint8 and a.shape == (8, 128, 128)
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    assert len({f.tobytes() for f in a}) == len(a)
    dbs = [inputs.make_db(c.config, s, "cpu")
           for s in (toy.SEED, toy.SEED, toy.SEED + 1)]
    for f in ("descriptors", "xy", "valid", "obj"):
        assert torch.equal(getattr(dbs[0], f), getattr(dbs[1], f))
    assert not torch.equal(dbs[0].descriptors, dbs[2].descriptors)
    assert dbs[0].descriptors.shape == (c.config["db_rows"], 61)


def test_noise_and_shift_bounds():
    c = toy.cell("dunk-10k.backlog-b8")
    base = inputs.base_frame_u8(c.config).astype(int)
    pool = inputs.frame_pool(c.config, c.traffic, toy.SEED).astype(int)
    s = c.traffic["max_shift"]
    for f in pool:
        best = min(np.abs(np.roll(base, (dy, dx), (0, 1)) - f).max()
                   for dy in range(-s, s + 1) for dx in range(-s, s + 1))
        assert best <= c.traffic["noise"]


def test_periodic_schedule():
    traffic = spec.load_json("traffic", "cadence-b1")
    pool = np.zeros((4, 2, 2), np.uint8)
    loop = spec.loop_module("periodic").Loop(dict(traffic, rate_fps=50.0),
                                             pool, 0.2)
    t0 = time.perf_counter()
    loop.start(t0)
    frames = list(loop.frames())
    assert len(frames) == loop.n_due == 10
    for i in range(10):
        assert loop.due(i) == pytest.approx(t0 + i / 50.0)
        assert loop.handed[i] >= loop.due(i)
    assert traffic["rate_fps"] > 0


def test_closed_loop_stops_on_a_batch_boundary():
    traffic = dict(spec.load_json("traffic", "backlog-b8"), batch=3)
    pool = np.zeros((4, 2, 2), np.uint8)
    loop = spec.loop_module("closed").Loop(traffic, pool, 0.01)
    loop.start(time.perf_counter())
    n = sum(1 for _ in loop.frames())
    assert n % 3 == 0 and n >= 3 and loop.due(0) is None
