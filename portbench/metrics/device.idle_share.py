"""One minus the union of device operations' intervals over the wall
time of the traced slice."""


def read(outcome, cell):
    t = outcome.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
