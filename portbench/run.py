"""Run one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared with its limit, which
also close standard error.  Exits non-zero, printing no result, without
the CUDA cards the cell asks for, or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# a library of the port must not load JAX through transformers
os.environ.setdefault("USE_FLAX", "0")

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t_process=T_PROCESS)
    outcome = harness.load_driver(cell.params["driver"]).run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips}
    line = harness.result_line(cell, outcome, bool(args.trace), info)
    sys.stdout.flush()
    print(harness.checks_text(outcome.checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
