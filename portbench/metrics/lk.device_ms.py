"""Device milliseconds of the kernels under the program's ``stage:lk``
ranges, per stream-frame of the traced slice."""


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.stage_device_s.get("stage:lk") or not t.stream_frames:
        return None
    return 1e3 * t.stage_device_s["stage:lk"] / t.stream_frames
