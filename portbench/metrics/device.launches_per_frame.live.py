"""Device events (kernels, copies, fills) per frame of the traced slice."""


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.launches or not t.stream_frames:
        return None
    return t.launches / t.stream_frames
