"""The control of ``correct``: the plain reference in a precision below the
configurations' float32 (TF32 off), put in the program's place, against the
reference in float32, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--precisions tf32 bf16]

For each seed it prints each control precision's ``out_bytes_off`` over as
many answers as a run checks (``check_last_*``), from the cell's
``control_first_step``, a step a run's window reaches: a limit that the
control does not exceed would pass a program computed in that precision.
Needs a CUDA card; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, reference  # noqa: E402


def readings(cell: harness.Cell, seed: int, precisions, first: int, device) -> dict:
    """{precision: out_bytes_off} of one seed."""
    driver = harness.load_driver(cell.params["driver"])
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                          t_process=time.monotonic())
    count = int(cell.params.get("check_last_frames")
                or int(cell.params["check_last_calls"]) * int(ctx.setting("chunk") or 1))
    foot = driver.footage(ctx)
    base = driver.reference_outputs(ctx, foot, first, count)
    return {p: reference.bytes_off(driver.reference_outputs(ctx, foot, first, count, p), base,
                                    driver.FRAME_DIMS) for p in precisions}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precisions", nargs="+", default=["tf32", "bf16"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    first = int(cell.params["control_first_step"])
    for seed in args.seeds:
        t0 = time.monotonic()
        got = readings(cell, seed, args.precisions, first, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "first": first,
                          "out_bytes_off": got, "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
