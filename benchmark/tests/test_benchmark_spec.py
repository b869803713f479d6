"""``BENCHMARK.json`` against the benchmark's contract, every cell's
files found by name, and a new cell made of new files and entries
alone."""

import json
import os
import re
import shutil
import sys

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def spec():
    return harness.load_spec(ROOT)


def test_keys_names_and_units(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each listed cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_resolves_by_name(spec):
    for w in spec["workloads"]:
        cell, config, mix, driver, limits = harness.resolve(spec, w["name"])
        assert w["chips"] == 1
        assert hasattr(driver, "Driver")
        assert config["name"] == w["config"]
        reported = harness.cell_metrics(spec, cell, False)
        assert {"setup_s"} < {m["name"] for m in reported}
        per_layer = harness.cell_metrics(spec, cell, True)
        assert per_layer
        for m in reported + per_layer:
            if m["name"] != "setup_s":
                assert callable(harness.load_module("metrics",
                                                    m["name"]).read)
        numbers = {k: v for k, v in limits.items() if k != "control"}
        assert numbers and all(v >= 0 for v in numbers.values())
        assert limits.get("len_mismatch", 0) == 0


def test_a_new_cell_is_new_files_and_entries(tmp_path, spec):
    """Copy the benchmark, add a mix, a limits file, a metric reader and
    a cell by new files and new entries only, and resolve the new cell
    from the copy's own harness."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(json.load(open(root / "benchmark/traffic/tts_b1.json")),
               sample=4)
    (root / "benchmark/traffic/tts_b1_small.json").write_text(
        json.dumps(new))
    (root / "benchmark/limits/student-tts-small.json").write_text(
        (root / "benchmark/limits/student-tts-b1.json").read_text())
    (root / "benchmark/metrics/tts_max_ms.py").write_text(
        "def read(run):\n    return 1e3 * max(run.latencies)"
        " if run.latencies else None\n")
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "student-tts-small",
                              "config": "fcl-taco2-S",
                              "traffic": "tts_b1_small", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "tts_max_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "serving entry",
                              "moves": "tts_p95_ms",
                              "workloads": ["student-tts-small"]})
    for m in spec["end_to_end"]:
        if m["name"] == "tts_p95_ms":
            m["workloads"].append("student-tts-small")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    sys.path.insert(0, str(root))
    saved = {k: v for k, v in sys.modules.items()
             if k == "benchmark" or k.startswith("benchmark.")}
    for k in saved:
        del sys.modules[k]
    try:
        import benchmark.harness as copy
        assert copy.HERE == str(root / "benchmark")
        s = copy.load_spec(str(root))
        cell, _, mix, driver, _ = copy.resolve(s, "student-tts-small")
        assert mix["sample"] == 4
        names = [m["name"] for m in copy.cell_metrics(s, cell, True)]
        assert "tts_max_ms" in names and "tts_p50_ms" not in names
        assert copy.load_module("metrics", "tts_max_ms").read(
            copy.Run({}, {})) is None
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules
                  if k == "benchmark" or k.startswith("benchmark.")]:
            del sys.modules[k]
        sys.modules.update(saved)
