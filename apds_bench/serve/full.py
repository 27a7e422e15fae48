"""Serving path `full`: every frame matched against the whole resident
DB (the dense product up to `db_block` rows, kernel 4 past it)."""

from __future__ import annotations

from apds_bench.serve import common


def program_db(raw, config: dict, pcfg, device):
    """What the stream is given: a DeviceDb of the raw rows (the stream
    makes it resident, with kernel 4's layout past db_block)."""
    return common.program_full_db(raw.clone())


def warm_extra(stream, frame) -> None:
    """Nothing beyond the stream's own batch shape."""


def back_half(stream, feats, frame_hw):
    """The program's back half of a batch, as the stream calls it."""
    from cubesat_apds_tpu_torch.pipelines.localize import back_half as bh
    return bh(feats, stream.db, stream.camera, stream.config,
              stream.solve_pose)


def reference_db(raw, config: dict, rcfg, device):
    return common.reference_full_db(raw, device)


def reference_rows(feats, rdb, camera, rcfg, frame_hw, solve_pose) -> list:
    from apds_bench.reference.localize import localize_from_features
    r = localize_from_features(feats, rdb, camera, rcfg, solve_pose)
    return common.rows(r, solve_pose)
