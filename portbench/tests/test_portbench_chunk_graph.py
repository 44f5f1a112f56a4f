"""``engine.chunk_graph_share``: replays over calls of the program's
``engine.offline.chunk_counters``, and nothing to read without them."""

import pytest

from portbench import harness
from video_stabilization_tpu_torch.engine import offline

METRIC = "engine.chunk_graph_share"


def read(cell="cfg5.chunk"):
    return harness.load_metric(METRIC).read(None, harness.find_cell(cell))


@pytest.mark.parametrize("cell", ["cfg5.chunk", "cfg5.serve", "cfg5x4.chunk"])
def test_reads_the_share_of_replayed_calls(monkeypatch, cell):
    monkeypatch.setattr(offline, "chunk_counters", {"calls": 400, "replays": 396, "captures": 4})
    assert read(cell) == pytest.approx(0.99)


def test_no_calls_read_nothing(monkeypatch):
    monkeypatch.setattr(offline, "chunk_counters", {"calls": 0, "replays": 0, "captures": 0})
    assert read() is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(offline, "chunk_counters")
    assert read() is None


def test_a_cpu_run_reads_zero():
    """The chunk cell on the CPU calls the chunk eagerly: the share is 0."""
    from portbench.tests.conftest import cpu_context

    offline.reset_chunk_counters()
    cell = harness.find_cell("cfg5.chunk")
    outcome = harness.load_driver(cell.params["driver"]).run(cpu_context(cell, trace=True))
    line = harness.result_line(cell, outcome, True, {"platform": "cpu"})
    assert line["correct"] is True
    assert line["metrics"][METRIC]["value"] == 0.0
