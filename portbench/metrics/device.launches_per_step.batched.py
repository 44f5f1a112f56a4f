"""Device events (kernels, copies, fills) per batched step of the traced
slice: every feed's frame of a step, its upload and read included."""


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.launches or not t.calls:
        return None
    return t.launches / t.calls
