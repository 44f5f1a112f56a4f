"""Stabilized frames completed in the window, over all streams, per second
of the window (host clock)."""


def read(outcome, cell):
    return outcome.frames / outcome.window_s if outcome.window_s > 0 else None
