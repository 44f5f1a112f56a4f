"""What every cell's run shares: finding a cell's files by name, the run's
context, the per-layer and end-to-end metric readers, the check that no
JAX module was loaded, and the result line.

A run is ``drivers/<driver>.py::run(ctx) -> Outcome``: the driver sets up
the program, times the window, traces a slice of calls when asked, keeps
the answers to check and hands them to the plain reference.  Each metric
is ``metrics/<name>.py::read(outcome, cell) -> float | None``: ``None``
(nothing to read in this run) leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no run may load; the port's own name
# starts with the second, so names are compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "video_stabilization_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with its files."""

    name: str
    entry: dict                 # the BENCHMARK.json entry
    params: dict                # workloads/<name>.json
    config: dict                # configs/<config>.json
    traffic: dict               # traffic/<traffic>.json
    end_to_end: list            # the metrics of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json``) and the
    files it names under ``base`` (default this directory)."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    return Cell(
        name=name, entry=entry,
        params=load_json(base / "workloads" / f"{name}.json"),
        config=load_json(base / "configs" / f"{entry['config']}.json"),
        traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_metric(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the time the process started (``time.monotonic()``)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float
    # the tests shrink a configuration with these (never a run)
    overrides: dict = dataclasses.field(default_factory=dict)

    def setting(self, key: str):
        return self.overrides.get(key, self.cell.config.get(key))


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the window's counts and times, the answers'
    check, the traced slice and whatever its layers' readers need."""

    frames: int                             # stabilized frames completed in the window
    window_s: float
    setup_s: float
    attempted: int
    failed: int
    checks: dict                            # name -> {"value": x, "limit": y}
    memory_peak_bytes: int
    latencies_ms: Optional[list] = None     # one per frame of the window
    trace: Any = None                       # trace.Slice of the traced run
    layer: dict = dataclasses.field(default_factory=dict)   # per-layer readings

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c["value"] <= c["limit"] for c in self.checks.values())


def stabilizer_config(ctx: Context, module, static: bool = False):
    """The configuration file's ``StabilizerConfig`` built from ``module``
    (the program's ``config`` or the reference's copy of it): the sizes,
    then the fields under ``stabilizer`` (a group such as ``gftt`` as its
    own config class); with ``static`` its mode pinned, as the offline
    forms require."""
    defaults = module.StabilizerConfig()
    kw = {k: type(getattr(defaults, k))(**v) if isinstance(v, dict) else v
          for k, v in (ctx.setting("stabilizer") or {}).items()}
    if static:
        kw["static_mode"] = int(module.StabilizationMode[ctx.setting("mode")])
    return module.StabilizerConfig(
        frame_height=ctx.setting("frame_height"), frame_width=ctx.setting("frame_width"),
        working_height=ctx.setting("working_height"), past_frames=ctx.setting("past_frames"),
        future_frames=ctx.setting("future_frames"), **kw)


def key_seed(seed: int) -> int:
    """The RANSAC key's seed of a run: its seed's low 32 bits."""
    return seed & 0xFFFFFFFF


def percentile(values, q: float) -> float:
    """Nearest-rank ``q`` percentile (0 < q <= 100) of ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def forbidden_loaded() -> list:
    """The forbidden top-level modules that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def metric_values(cell: Cell, outcome: Outcome, trace: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (untraced)
    or per-layer metrics (traced), each read by its reader."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"]).read(outcome, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, device_info: dict) -> dict:
    """The result's JSON object; ``checks``, the numbers compared with their
    limits, comes last."""
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metric_values(cell, outcome, trace),
            "device": dict(device_info, memory_peak_bytes=outcome.memory_peak_bytes)}
    if trace and outcome.trace is not None:
        line["device"]["busy_s"] = outcome.trace.busy_s
        line["device"]["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = outcome.checks
    return line


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in checks.items())


def now() -> float:
    return time.monotonic()
