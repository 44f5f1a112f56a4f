"""The arithmetic of the metrics: rate, percentile, roofline bytes, the
trace's busy union and idle labels."""

import pytest

from portbench import harness, roofline, trace


def outcome(**kw):
    base = dict(frames=90, window_s=3.0, setup_s=1.5, attempted=90, failed=0, checks={},
                memory_peak_bytes=0)
    base.update(kw)
    return harness.Outcome(**base)


def test_rate_and_setup():
    cell = harness.find_cell("cfg1.live")
    assert harness.load_metric("frames_per_s").read(outcome(), cell) == 30.0
    assert harness.load_metric("setup_s").read(outcome(), cell) == 1.5


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 95, 5.0),
    (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19),
    ([3, 1, 2], 50, 2),
])
def test_nearest_rank_percentile(values, q, want):
    assert harness.percentile(values, q) == want


def test_p95_reader_and_its_absence():
    cell = harness.find_cell("cfg1.live")
    read = harness.load_metric("frame_latency_p95_ms").read
    assert read(outcome(latencies_ms=[float(i) for i in range(1, 201)]), cell) == 190.0
    assert read(outcome(), cell) is None


def test_warp_bytes_of_a_1080p_frame():
    cfg = harness.find_cell("cfg1.live").config
    # LK at 360x640 twice, 180x320, 90x160; the 3x1080x1920 output; 8 B a value
    want = 8 * (2 * 360 * 640 + 180 * 320 + 90 * 160 + 3 * 1080 * 1920)
    assert roofline.warp_bytes_per_frame(cfg) == want == 54028800
    assert roofline.peak("hbm_bytes_per_s") == 3.35e12


def fake_slice(**kw):
    base = dict(busy_s=0.3, window_s=1.0, launches=330, calls=10, stream_frames=80,
                kernel_s={"affine_warp_kernel(float)": 0.004, "other": 0.2},
                stage_device_s={"stage:lk": 0.024}, idle_s={"stage:gftt": 0.7})
    base.update(kw)
    return trace.Slice(**base)


def test_trace_readers():
    cell = harness.find_cell("cfg5.chunk")
    o = outcome(trace=fake_slice())
    assert harness.load_metric("device.idle_share").read(o, cell) == pytest.approx(0.7)
    assert harness.load_metric("lk.device_ms").read(o, cell) == pytest.approx(0.3)
    assert harness.load_metric("device.launches_per_frame.live").read(o, cell) == 330 / 80
    bound = 80 * 54028800 / 3.35e12
    assert harness.load_metric("affine_warp_roofline").read(o, cell) == \
        pytest.approx(100 * bound / 0.004)


def test_readers_return_nothing_without_a_trace_or_a_kernel():
    cell = harness.find_cell("cfg5.chunk")
    for name in ("device.idle_share", "lk.device_ms", "affine_warp_roofline",
                 "device.launches_per_frame.live"):
        assert harness.load_metric(name).read(outcome(), cell) is None
    empty = outcome(trace=fake_slice(kernel_s={}, stage_device_s={}, busy_s=0.0, launches=0))
    for name in ("device.idle_share", "lk.device_ms", "affine_warp_roofline",
                 "device.launches_per_frame.live"):
        assert harness.load_metric(name).read(empty, cell) is None


def test_busy_union_and_breakdown():
    assert trace._merged([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]
    s = fake_slice(kernel_s={f"k{i}": float(i) for i in range(12)})
    b = s.breakdown()
    assert [k for k, _ in b["device_ops"]] == [f"k{i}" for i in range(11, 1, -1)]
    assert b["idle_gaps"] == [["stage:gftt", 0.7]]
    assert trace._short("void " + "x" * 200).endswith("...")
    assert len(trace._short("void " + "x" * 200)) == 96
