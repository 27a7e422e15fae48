"""Nothing the benchmark runs loads JAX or the JAX package (compared by
top-level name, whole: `cubesat_apds_tpu_torch` is not the JAX package),
and the reference loads nothing of the program."""

import json
import subprocess
import sys

from apds_bench.spec import ROOT

BANNED = ("jax", "jaxlib", "flax", "cubesat_apds_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    tops = _loaded(
        "import apds_bench.run, apds_bench.control, apds_bench.sweep\n"
        "from apds_bench import spec\n"
        "for m in spec.load_manifest()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "for mode in ('full', 'pruned'):\n"
        "    spec.serve_module(mode)\n"
        "for loop in ('closed', 'periodic'):\n"
        "    spec.loop_module(loop)\n"
        "import apds_bench.reference.akaze, apds_bench.reference.localize\n"
        "import cubesat_apds_tpu_torch.pipelines.stream")
    assert "apds_bench" in tops and "cubesat_apds_tpu_torch" in tops
    assert not tops & set(BANNED), tops & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import apds_bench.reference.akaze\n"
                   "import apds_bench.reference.localize\n"
                   "import apds_bench.reference.twins")
    assert "cubesat_apds_tpu_torch" not in tops
    assert not tops & set(BANNED)


def test_run_refuses_without_a_card():
    """On a machine without a card the command prints no result and
    exits with another code than 0."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "apds_bench.run", "--workload",
         "dunk-10k.backlog-b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_reference_sources_import_nothing_of_the_program():
    """The same, read from the reference's sources: every import there
    has a top-level name other than the program's and JAX's."""
    import ast
    tops = set()
    for path in (ROOT / "apds_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "apds_bench", "dataclasses", "functools",
                    "math", "numpy", "torch", "typing"}, tops
