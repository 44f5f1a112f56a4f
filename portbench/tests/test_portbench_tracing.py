"""The readers of the program's idle and device ranges, on traced slices
built by hand: each sums exactly its labels (whole names, never a prefix),
divides by the right count, and reads nothing where its labels are absent."""

import pytest

from portbench import harness, trace

LK = ("stage:lk_track", "stage:lk", "stage:lk_sweep", "stage:lk_levels", "stage:lk_level0",
      "stage:lk_gate")
# labels that share a prefix with a reader's set, or are the harness's own
OTHERS = {"stage:lk_extra": 0.5, "stage:lk_track_host": 0.25, "stage:fit_extra": 0.125,
          "stage:y4m_encode": 2.0, "stage:y4m_read": 4.0, "portbench:serve_write": 8.0,
          "portbench:serve_read": 16.0, "stage:step": 32.0}


def outcome(t):
    return harness.Outcome(frames=1, window_s=1.0, setup_s=1.0, attempted=1, failed=0,
                           checks={}, memory_peak_bytes=0, trace=t)


def slice_of(idle=None, stage_device=None, window_s=4.0, stream_frames=8):
    return trace.Slice(busy_s=0.5, window_s=window_s, launches=10, calls=2,
                       stream_frames=stream_frames, kernel_s={},
                       stage_device_s=dict(stage_device or {}),
                       idle_s={**OTHERS, **(idle or {})})


def read(name, t, cell="cfg1.live"):
    return harness.load_metric(name).read(outcome(t), harness.find_cell(cell))


def test_lk_idle_sums_every_lk_label_per_stream_frame():
    idle = {k: 2.0 ** -i for i, k in enumerate(LK)}         # 1 + 1/2 + ... + 1/32
    assert read("lk.idle_ms", slice_of(idle)) == pytest.approx(1e3 * (2 - 2 ** -5) / 8)
    # the chunk's label alone, over its stream-frames
    got = read("lk.idle_ms", slice_of({"stage:lk": 0.032}, stream_frames=128), "cfg5.chunk")
    assert got == pytest.approx(0.25)


def test_fit_idle_sums_its_two_labels_per_stream_frame():
    t = slice_of({"stage:inter_frame_fit": 0.04, "stage:fit": 0.006})
    assert read("fit.idle_ms", t) == pytest.approx(1e3 * 0.046 / 8)


def test_input_h2d_reads_device_time_per_frame():
    t = slice_of(stage_device={"stage:input_h2d": 0.0028, "stage:input_h2d_extra": 1.0},
                 stream_frames=4)
    assert read("engine.input_h2d_ms.live", t) == pytest.approx(0.7)


@pytest.mark.parametrize("name, label", [
    ("lk.idle_ms", "stage:lk_gate"), ("lk.idle_ms", "stage:lk"),
    ("fit.idle_ms", "stage:fit"), ("fit.idle_ms", "stage:inter_frame_fit")])
def test_a_range_without_idle_reads_zero(name, label):
    """A range that opened in the slice, with no idle gap begun under it,
    reads 0, not nothing."""
    assert read(name, slice_of(stage_device={label: 0.001})) == 0.0


@pytest.mark.parametrize("name", ["lk.idle_ms", "fit.idle_ms", "engine.input_h2d_ms.live"])
def test_nothing_to_read_without_the_labels(name):
    """Only prefix-sharing and harness labels, as on a program without the
    ranges: nothing; nor without a trace, a window or frames."""
    near = {"stage:input_h2d_extra": 1.0, "stage:lk_extra": 1.0, "stage:fit_extra": 1.0}
    assert read(name, slice_of(stage_device=near)) is None
    assert read(name, None) is None
    full = slice_of({k: 1.0 for k in LK + ("stage:inter_frame_fit",)},
                    {"stage:input_h2d": 1.0}, window_s=0.0, stream_frames=0)
    assert read(name, full) is None
