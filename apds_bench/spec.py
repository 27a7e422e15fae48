"""The benchmark's manifest and the files it names.

`BENCHMARK.json`, at the root of the checkout, lists the cells
(`workloads`), their configurations, and the end-to-end and per-layer
metrics. Everything that belongs to one configuration, traffic mix,
serving path, arrival loop or per-layer metric sits in a file of its
own in this folder, found by name:

- configuration  `configs/<config>.json`
- traffic mix    `traffic/<traffic>.json`, which names its `loop` and `serve`
- arrival loop   `loops/<loop>.py`
- serving path   `serve/<serve>.py`
- metric reader  `metrics/<metric>.py`
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with its configuration and traffic mix
    loaded, and the metrics it reports."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell `name` of the manifest, its files loaded."""
    manifest = manifest if manifest is not None else load_manifest()
    for w in manifest["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=load_json("configs", w["config"]),
        traffic=load_json("traffic", w["traffic"]),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def loop_module(kind: str):
    """`loops/<kind>.py`: the arrival loop."""
    if not NAME_RE.match(kind) or "." in kind:
        raise ValueError(f"bad loop name {kind!r}")
    return importlib.import_module(f"apds_bench.loops.{kind}")


def serve_module(mode: str):
    """`serve/<mode>.py`: the serving path."""
    if not NAME_RE.match(mode) or "." in mode:
        raise ValueError(f"bad serving path {mode!r}")
    return importlib.import_module(f"apds_bench.serve.{mode}")


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read(ctx)`: the metric's value, or None
    where the run holds nothing to read it from."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "apds_bench.metrics._m_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
