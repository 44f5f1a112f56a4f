"""Idle device milliseconds under the program's inter-frame fit ranges
(the streaming step's ``stage:inter_frame_fit``, the chunk's
``stage:fit``: RANSAC and the de-scale), per stream-frame of the traced
slice."""

LABELS = ("stage:inter_frame_fit", "stage:fit")


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.stream_frames:
        return None
    if not any(k in t.idle_s or k in t.stage_device_s for k in LABELS):
        return None
    return 1e3 * sum(t.idle_s.get(k, 0.0) for k in LABELS) / t.stream_frames
