"""A rehearsal of the full-resolution cell (`dunk-2048.backlog-b8-p64`)
on the CPU at toy size: it runs through `run.execute` and is `correct`,
with every compared number 0 (the program equals the reference). A traced
run reads its per-layer metrics without failing; the front half's in-step
metrics, timed by CUDA events, read nothing off the card. Their readers are held to hand-made records besides, and to a
recorder that keeps no `front` span or `front_pixels` count (a program
without them)."""

import time

import pytest
import torch

from apds_bench import run, spec
from apds_bench.tests import toy
from cubesat_apds_tpu_torch.utils.profiling import StageTimes

CPU = torch.device("cpu")
FULLRES = "dunk-2048.backlog-b8-p64"
FRONT_METRICS = ("features.front_step_ms.fullres",
                 "features.front_ns_per_px.fullres")


def _execute(name, traced=False, seconds=1.0):
    return run.execute(toy.cell(name), toy.SEED, seconds, traced, CPU,
                       t_process=time.perf_counter())


def test_fullres_rehearsal():
    out, table = _execute(FULLRES)
    assert out["correct"], table
    assert all(v["value"] == 0 for v in table.values()), table
    assert set(out["metrics"]) == {m["name"] for m in toy.cell(FULLRES)
                                   .end_to_end}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"


def test_fullres_traced_rehearsal_reads_nothing_of_the_front_off_the_card():
    out, table = _execute(FULLRES, traced=True)
    assert out["correct"], table
    reported = {m["name"] for m in toy.cell(FULLRES).per_layer}
    assert set(FRONT_METRICS) <= reported
    assert set(out["metrics"]) <= reported
    assert "stream.dispatch_ms.backlog" in out["metrics"]
    for name in FRONT_METRICS:
        assert name not in out["metrics"]


class _Ctx:
    def __init__(self, times):
        self.times = times


def test_front_readers_on_hand_made_records():
    """Two `front` spans of 0.25 s and 0.5 s over 2**20 pixels: a mean of
    375 ms and 0.75 s / 2**20 a pixel; None without the span or the count,
    and None from a recorder that has neither method."""
    step_ms = spec.metric_reader(FRONT_METRICS[0])
    per_px = spec.metric_reader(FRONT_METRICS[1])
    t = StageTimes()
    assert step_ms(_Ctx(t)) is None and per_px(_Ctx(t)) is None
    t.span("front", 1.0, 1.25, id=0)
    t.span("front", 2.0, 2.5, id=1)
    assert step_ms(_Ctx(t)) == 375.0
    assert per_px(_Ctx(t)) is None                # no front_pixels count
    t.count("front_pixels", 2**19)
    t.count("front_pixels", 2**19)
    assert per_px(_Ctx(t)) == pytest.approx(0.75e9 / 2**20, rel=1e-12)

    class Bare:                                    # neither spans nor counts
        def values(self, name):
            return []

    assert step_ms(_Ctx(Bare())) is None and per_px(_Ctx(Bare())) is None


@pytest.mark.cuda
def test_fullres_control_on_the_card(card):
    """On the card, at the cell's own size: the bfloat16 control fails
    the cell's limits on three seeds."""
    from apds_bench import check, control
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        numbers = control.readings(spec.cell(FULLRES), seed, card)
        numbers.pop("frames_checked")
        assert not check.judge(numbers, check.limits(FULLRES))[0], numbers
