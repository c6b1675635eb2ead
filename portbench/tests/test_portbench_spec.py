"""BENCHMARK.json against the benchmark's contract, and the harness's look-up
by name: every configuration, mix, job kind, generator, metric and limits
file named is found, and one added as files alone is found too."""
from __future__ import annotations

import importlib.util
import json
import re
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _harness(root: Path):
    spec = importlib.util.spec_from_file_location(f"harness_{abs(hash(str(root)))}", root / "portbench" / "harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys(section):
    need, may = KEYS[section]
    for entry in SPEC[section]:
        assert need <= set(entry) <= need | may, (section, entry.get("name"))


def test_names_and_units():
    names = []
    for section in KEYS:
        for entry in SPEC[section]:
            names.append((section, entry["name"]))
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for section in KEYS:
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got)), section
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metric_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"| {layer} |" in perf for layer in layers), layers


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_everything_named_is_found(workload):
    h = _harness(ROOT)
    cell = h.Cell(SPEC, workload)
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    job = h.load_named("jobs", cell.traffic["job"])
    assert all(hasattr(job, f) for f in ("setup", "job", "setup_control", "job_control", "compare"))
    h.load_named("data", cell.config["data"]["generator"])
    for m in cell.end_to_end + cell.per_layer:
        assert callable(h.load_named("metrics", m["name"]).read)
    assert all({"limit", "lower", "upper", "set_from"} <= set(v) for v in cell.limits.values())


def test_added_as_files_alone_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    bench = root / "portbench"
    (bench / "configs" / "tiny_susy.json").write_text(json.dumps(
        {"name": "tiny_susy", "data": {"generator": "susy_like", "events": 1200, "features": 4, "test_events": 200,
                                       "separation": 1.4, "signal_share": 0.5, "scale_range": [1, 2],
                                       "offset_scale": 1.0}}))
    (bench / "traffic" / "tiny_test_set.json").write_text(json.dumps(
        {"job": "knn_predict", "n_neighbors": 3, "warmup_jobs": 1, "compare_queries": 50}))
    (bench / "limits" / "tiny_predict.json").write_text(json.dumps(
        {"vote_margin": {"limit": 1e-4, "lower": 0, "upper": 1, "set_from": "a test"}}))
    (bench / "metrics" / "jobs_done.py").write_text("def read(run):\n    return run.jobs\n")
    spec["configs"].append({"name": "tiny_susy", "source": "a test", "file": "portbench/configs/tiny_susy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_predict", "config": "tiny_susy", "traffic": "tiny_test_set", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher", "source": "host_clock",
                              "layer": "estimators", "moves": "job_ms", "workloads": ["tiny_predict"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    h = _harness(root)
    cell = h.Cell(json.loads((root / "BENCHMARK.json").read_text()), "tiny_predict")
    assert cell.config["data"]["events"] == 1200 and cell.traffic["n_neighbors"] == 3
    assert {"jobs_done", "launches_per_job", "device_idle"} <= {m["name"] for m in cell.per_layer}
    assert "roofline.knn" not in {m["name"] for m in cell.per_layer}
    assert h.load_named("metrics", "jobs_done").read(type("R", (), {"jobs": 7})()) == 7
    with pytest.raises(LookupError):
        h.load_named("metrics", "no_such_metric")
