"""A rehearsal of whole runs on the CPU at toy sizes: the stream, the
traced stretch and its readers, and the reference check, once a cell
kind. Then the check against the faults a cell can have, and against the
lower-precision control: each has to come out as not correct.

The run itself refuses the CPU (run.main); these tests call its pieces
(run.execute) with the CPU as the device."""

import time

import pytest
import torch

from apds_bench import control, run
from apds_bench.tests import toy

CPU = torch.device("cpu")
CELLS = ["dunk-10k.backlog-b8", "dunk-1m.backlog-b8", "dunk-10k.cadence-b1",
         "dunk-1m.pruned-b8"]


def _execute(name, traced=False, seconds=1.0):
    out, table = run.execute(toy.cell(name), toy.SEED, seconds, traced, CPU,
                             t_process=time.perf_counter())
    return out, table


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name):
    traced = name.endswith("cadence-b1")
    out, table = _execute(name, traced=traced)
    assert out["correct"], table
    c = toy.cell(name)
    assert set(out["metrics"]) <= {m["name"] for m in
                                   (c.per_layer if traced else c.end_to_end)}
    if not traced:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    assert all(v["value"] == 0 for v in table.values()), table


def test_traced_rehearsal_reads_the_stage_times():
    out, _ = _execute("dunk-10k.backlog-b8", traced=True)
    assert "stream.dispatch_ms.backlog" in out["metrics"]
    assert "frames_per_s" not in out["metrics"]
    assert "window_s" in out["device"] and "breakdown" in out


def _fault(monkeypatch, fn):
    from cubesat_apds_tpu_torch.pipelines import stream
    monkeypatch.setattr(stream.StreamingLocalizer, "_step",
                        fn(stream.StreamingLocalizer._step))


def test_fault_answer_altered(monkeypatch):
    """A frame's homography altered where the step produces it."""
    def wrap(step):
        def bad(self, frames):
            out = step(self, frames).clone()
            out[0, 2] += 3.0            # H[0, 2] of the batch's first frame
            return out
        return bad
    _fault(monkeypatch, wrap)
    out, table = _execute("dunk-10k.backlog-b8")
    assert not out["correct"] and table["homography_px"]["value"] > 2.0


def test_fault_half_batch_left_out(monkeypatch):
    """Half of each batch left out: its rows copy the other half's."""
    def wrap(step):
        def bad(self, frames):
            half = frames.shape[0] // 2
            out = step(self, frames[:half])
            return torch.cat([out, out])[:frames.shape[0]]
        return bad
    _fault(monkeypatch, wrap)
    out, table = _execute("dunk-10k.backlog-b8")
    assert not out["correct"]


@pytest.mark.parametrize("name", ["dunk-10k.backlog-b8", "dunk-1m.pruned-b8"])
def test_control_is_not_correct(name):
    """The reference with its scale space in bfloat16, in the program's
    place, fails the cell's limits."""
    from apds_bench import check
    c = toy.cell(name)
    numbers = control.readings(c, toy.SEED, CPU)
    numbers.pop("frames_checked")
    correct, table = check.judge(numbers, check.limits(name))
    assert not correct, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    """On the card, at the cell's own size: the control fails the cell's
    limits on three seeds (`python -m apds_bench.control` prints the same
    readings)."""
    from apds_bench import check, spec
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        numbers = control.readings(spec.cell(name), seed, card)
        numbers.pop("frames_checked")
        assert not check.judge(numbers, check.limits(name))[0], numbers
