"""BENCHMARK.json and the files it names keep to the benchmark's contract:
names, units, keys, bounds, the cells' files, and the result line."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
BENCH = harness.benchmark()


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.endswith("_torch") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == harness.load_json(harness.ROOT / c["file"])["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:        # the metric it moves is reported there
            assert m["moves"] in names


def test_every_file_loads_by_name():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        assert harness.load_driver(cell.params["driver"]).run
        for key in ("frame_height", "frame_width", "working_height", "past_frames",
                    "future_frames", "mode", "source", "assumed", "reduced"):
            assert key in cell.config
        assert cell.traffic["footage_frames"] >= 2
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_file_names_are_made_of_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.match(str(path.relative_to(harness.ROOT))), path


def test_result_line_keys_order_and_length():
    cell = harness.find_cell("cfg5.chunk")
    outcome = harness.Outcome(
        frames=100, window_s=2.0, setup_s=3.0, attempted=100, failed=0,
        checks={"out_bytes_off": {"value": 0.0, "limit": 0.0}}, memory_peak_bytes=7)
    line = harness.result_line(cell, outcome, False, {"platform": "gpu", "kind": "x",
                                                      "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["frames_per_s"] == {"value": 50.0, "unit": "frames/s"}
    assert line["metrics"]["setup_s"]["value"] == 3.0
    assert "frame_latency_p95_ms" not in line["metrics"]
    assert line["device"]["memory_peak_bytes"] == 7
    assert len(json.dumps(line)) < 4096
    outcome.checks["out_bytes_off"]["value"] = 1e-6
    assert harness.result_line(cell, outcome, False, {})["correct"] is False
