"""Host milliseconds per call of the sharded chunk's dispatch over the mesh
(``parallel.streams.mesh_counters``: each call's wall from its start to its
return, all slots enqueued), the mean over the untraced window's calls."""


def read(outcome, cell):
    d = outcome.layer.get("mesh_dispatch")
    if not d or not d["calls"]:
        return None
    return 1e3 * d["dispatch_s"] / d["calls"]
