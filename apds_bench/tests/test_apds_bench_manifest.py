"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, arrival loop, serving path, metric reader and limit file
resolves, and every name and unit keeps to the allowed characters."""

import json

import pytest

from apds_bench import check, spec

M = spec.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["apds_bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert c.config_name in {x["name"] for x in M["configs"]}
    spec.loop_module(c.traffic["loop"]).Loop
    serve = spec.serve_module(c.traffic["serve"])
    for fn in ("program_db", "warm_extra", "back_half", "reference_db",
               "reference_rows"):
        assert callable(getattr(serve, fn))
    assert set(check.limits(name)) == set(check.NUMBERS)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"] == f"apds_bench/configs/{cfg['name']}.json"
    data = spec.load_json("configs", cfg["name"])
    assert data["source"] and data["reduced"] == cfg["reduced"]
    assert cfg["source"].startswith("https://")
    assert any(w["config"] == cfg["name"] for w in M["workloads"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert spec.NAME_RE.match(m["name"]) and spec.UNIT_RE.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", []):
        assert w in CELLS
    if m in M["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        moved = [e for e in M["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_names():
    names = CELLS + [c["name"] for c in M["configs"]] + \
        [w["traffic"] for w in M["workloads"]]
    for n in names:
        assert spec.NAME_RE.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(CELLS)
    for w in M["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
