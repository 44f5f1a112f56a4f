"""Device milliseconds under the program's ``stage:input_h2d`` ranges (the
live frame's upload in ``Stabilizer.stabilize_frame``), per frame of the
traced slice."""


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.stage_device_s.get("stage:input_h2d") or not t.stream_frames:
        return None
    return 1e3 * t.stage_device_s["stage:input_h2d"] / t.stream_frames
