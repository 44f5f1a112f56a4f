"""``engine.step_graph_share.live``: replays over calls of the program's
``engine.stabilizer.step_counters``, and nothing to read without them."""

import pytest

from portbench import harness
from video_stabilization_tpu_torch.engine import stabilizer

METRIC = "engine.step_graph_share.live"


def read():
    return harness.load_metric(METRIC).read(None, harness.find_cell("cfg1.live"))


def test_reads_the_share_of_replayed_calls(monkeypatch):
    monkeypatch.setattr(stabilizer, "step_counters",
                        {"calls": 40, "replays": 38, "captures": 1})
    assert read() == pytest.approx(0.95)


def test_no_calls_read_nothing(monkeypatch):
    monkeypatch.setattr(stabilizer, "step_counters", {"calls": 0, "replays": 0, "captures": 0})
    assert read() is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(stabilizer, "step_counters")
    assert read() is None


def test_a_cpu_run_reads_zero():
    """The live cell on the CPU calls the step eagerly: the share is 0."""
    from portbench.tests.conftest import cpu_context

    stabilizer.reset_step_counters()
    cell = harness.find_cell("cfg1.live")
    outcome = harness.load_driver(cell.params["driver"]).run(cpu_context(cell, trace=True))
    line = harness.result_line(cell, outcome, True, {"platform": "cpu"})
    assert line["correct"] is True
    assert line["metrics"][METRIC]["value"] == 0.0
