"""The 95th percentile (nearest rank) of every frame's latency in the
window, from the call to its output in host memory (host clock)."""

from portbench import harness


def read(outcome, cell):
    if not outcome.latencies_ms:
        return None
    return harness.percentile(outcome.latencies_ms, 95)
