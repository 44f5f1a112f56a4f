"""The share of ``Stabilizer.stabilize_frame``'s calls in the run that
replayed a CUDA graph of the streaming step (the program's
``engine.stabilizer.step_counters``: replays over calls).  None where the
program keeps no such counter, or made no call."""


def read(outcome, cell):
    from video_stabilization_tpu_torch.engine import stabilizer

    counters = getattr(stabilizer, "step_counters", None)
    if not counters or not counters.get("calls"):
        return None
    return counters["replays"] / counters["calls"]
