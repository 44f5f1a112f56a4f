"""Idle device milliseconds under the program's dense-LK ranges (the
streaming step's ``stage:lk_track``, the chunk's ``stage:lk`` and LK's
phases inside them), per stream-frame of the traced slice: the host's
dispatch of LK that the card waits on."""

LABELS = ("stage:lk_track", "stage:lk", "stage:lk_sweep", "stage:lk_levels",
          "stage:lk_level0", "stage:lk_gate")


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.stream_frames:
        return None
    if not any(k in t.idle_s or k in t.stage_device_s for k in LABELS):
        return None
    return 1e3 * sum(t.idle_s.get(k, 0.0) for k in LABELS) / t.stream_frames
