"""The share of the stream-batched chunk's calls in the run that replayed
a CUDA graph of the chunk (the program's ``engine.offline.chunk_counters``:
replays over calls, each slot's call counted).  None where the program
keeps no such counter, or made no call."""


def read(outcome, cell):
    from video_stabilization_tpu_torch.engine import offline

    counters = getattr(offline, "chunk_counters", None)
    if not counters or not counters.get("calls"):
        return None
    return counters["replays"] / counters["calls"]
