"""Host milliseconds per call of the batched step, from the call to its
return before its outputs are read (the program's
``parallel.streams.batched_counters``: the eager step's dispatch, its mode
read included), the mean over the untraced window's calls.  None where
the program keeps no such counter."""


def read(outcome, cell):
    d = outcome.layer.get("batched")
    if not d or not d.get("calls"):
        return None
    return 1e3 * d["host_s"] / d["calls"]
