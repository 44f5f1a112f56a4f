"""The share of ``serve_files``' wall time spent in its drain's writes
(``serve.last_run["write_s"] / ["wall_s"]``)."""


def read(outcome, cell):
    return outcome.layer.get("write_share")
