"""Mean host milliseconds from a ``stabilize_frame`` call to its return,
before its output is read: the step's dispatch, over the window's frames."""


def read(outcome, cell):
    return outcome.layer.get("enqueue_ms")
