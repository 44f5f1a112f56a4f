"""Each cell's run, end to end on the CPU at a small size: ``correct``
comes out true on the program as it is and false with its timed path
broken underneath; a cell is added by files and entries alone."""

import json
import shutil

import pytest

from portbench import harness
from portbench.tests.conftest import cpu_context
from video_stabilization_tpu_torch import parallel
from video_stabilization_tpu_torch.engine import stabilizer

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run_cell(cell, **kw):
    outcome = harness.load_driver(cell.params["driver"]).run(cpu_context(cell, **kw))
    return outcome, harness.result_line(cell, outcome, kw.get("trace", False),
                                        {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    cell = harness.find_cell(name)
    outcome, line = run_cell(cell)
    assert line["correct"] is True, line["checks"]
    assert outcome.frames > 0 and line["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())


def test_traced_run_reports_host_layer_metrics():
    cell = harness.find_cell("cfg1.live")
    outcome, line = run_cell(cell, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["engine.enqueue_ms.live"]["value"] > 0
    assert "frames_per_s" not in line["metrics"]
    assert outcome.trace.calls == cell.params["trace_calls"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.HERE / d, base / d)
    bench = harness.benchmark()
    bench["workloads"].append({"name": "cfg5.chunk_long_footage", "config": "cfg5_8x1080p_gs",
                               "traffic": "resident_long", "chips": 1, "why": "a test"})
    traffic = json.loads((base / "traffic" / "resident.json").read_text())
    traffic["footage_frames"] = 5
    (base / "traffic" / "resident_long.json").write_text(json.dumps(traffic))
    shutil.copy(base / "workloads" / "cfg5.chunk.json",
                base / "workloads" / "cfg5.chunk_long_footage.json")
    cell = harness.find_cell("cfg5.chunk_long_footage", bench, base)
    assert cell.traffic["footage_frames"] == 5
    _, line = run_cell(cell)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


def _state_unchanged_step(step):
    def broken(carry, frame, config, mode, ext_motion=None):
        _, result = step(carry, frame, config, mode, ext_motion)
        return carry, result
    return broken


def _altered_step(step):
    def broken(carry, frame, config, mode, ext_motion=None):
        carry, (out, valid) = step(carry, frame, config, mode, ext_motion)
        out = out.clone()
        out[:8, :8] = 255 - out[:8, :8]
        return carry, (out, valid)
    return broken


def _broken_chunk(fault):
    make = parallel.make_sharded_offline_fn

    def make_broken(config, mesh):
        fn = make(config, mesh)

        def call(carry, frames):
            new, (out, valid) = fn(carry, frames)
            out = out.clone()
            if fault == "state_unchanged":
                new = carry
            elif fault == "half_the_batch_left_out":
                half = out.shape[0] // 2
                out[half:] = out[:half]
            elif fault == "answer_altered":
                out[..., :8, :8, :] = 255 - out[..., :8, :8, :]
            return new, (out, valid)
        return call
    return make_broken


FAULTS = [("cfg1.live", "state_unchanged"), ("cfg1.live", "answer_altered")] + [
    (cell, fault) for cell in ("cfg5.chunk", "cfg5.serve")
    for fault in ("state_unchanged", "half_the_batch_left_out", "answer_altered")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(name, fault, monkeypatch):
    # the cells run on one card: no exchange between cards to leave out
    if name == "cfg1.live":
        wrap = _state_unchanged_step if fault == "state_unchanged" else _altered_step
        monkeypatch.setattr(stabilizer, "stabilize_step", wrap(stabilizer.stabilize_step))
    else:
        monkeypatch.setattr(parallel, "make_sharded_offline_fn", _broken_chunk(fault))
    outcome, line = run_cell(harness.find_cell(name))
    assert line["correct"] is False
    assert outcome.checks["out_bytes_off"]["value"] > outcome.checks["out_bytes_off"]["limit"]
