"""Serving path `pruned`: the DB sorted by spatial cell
(`make_pruned_db`), a coarse fix against the coarse DB (the full DB's
first `coarse_rows` rows), then a fine match against the rows of the
frame's window (`window_capacity` slots). A frame whose coarse fix fails
or whose window overflows reruns through the full-DB fallback."""

from __future__ import annotations

import dataclasses

import torch

from apds_bench.serve import common

MARGIN = 0.25     # the stream's window margin (pipelines/stream.py)


def _coarse(raw, n: int):
    return dataclasses.replace(raw, **{
        f.name: getattr(raw, f.name)[:n]
        for f in dataclasses.fields(raw)})


def program_db(raw, config: dict, pcfg, device):
    from cubesat_apds_tpu_torch.pipelines.localize import (
        make_pruned_db, resident_db)
    raw = raw.clone()
    full = resident_db(common.program_full_db(raw), pcfg, device)
    coarse = resident_db(common.program_full_db(
        _coarse(raw, config["coarse_rows"]).clone()), pcfg, device)
    return make_pruned_db(full, coarse, config["window_capacity"])


def warm_extra(stream, frame) -> None:
    """The fallback's own keys (a lone frame's front half and the
    full-DB back half over the row table), so that a coarse miss in the
    window captures no graph."""
    from cubesat_apds_tpu_torch.pipelines.localize import (
        localize_frame_pruned_fallback_jit)
    f = torch.as_tensor(frame).to(stream.device).to(torch.float32) / 255.0
    localize_frame_pruned_fallback_jit(f, stream.db, stream.camera,
                                       stream.config, stream.solve_pose)


def back_half(stream, feats, frame_hw):
    from cubesat_apds_tpu_torch.pipelines.localize import pruned_back_half
    return pruned_back_half(feats, frame_hw, stream.db, stream.camera,
                            stream.config, stream.solve_pose, MARGIN)


def reference_db(raw, config: dict, rcfg, device):
    from apds_bench.reference.localize import make_pruned_db
    full = common.reference_full_db(raw, device)
    coarse = common.reference_full_db(_coarse(raw, config["coarse_rows"]),
                                      device)
    return make_pruned_db(full, coarse, config["window_capacity"])


def reference_rows(feats, rdb, camera, rcfg, frame_hw, solve_pose) -> list:
    """The pruned step's rows; a frame whose coarse fix failed or whose
    window overflowed takes the fallback over the row table."""
    from apds_bench.reference.localize import (
        _pruned_back_half, fallback_db, localize_from_features)
    from apds_bench.reference.types_ import select
    pr = _pruned_back_half(feats, frame_hw, rdb, camera, rcfg, solve_pose,
                           MARGIN)
    out = common.rows(pr.result, solve_pose)
    miss = (~pr.coarse_ok.reshape(-1) | pr.overflow.reshape(-1)).cpu()
    for b in torch.nonzero(miss).reshape(-1).tolist():
        r = localize_from_features(select(feats, b), fallback_db(rdb),
                                   camera, rcfg, solve_pose)
        out[b] = common.rows(r, solve_pose)[0]
    return out
