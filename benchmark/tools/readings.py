"""The readings a cell's correctness limits are set from, in one process:

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 11,12,... [--control-seeds 11,12,13] [--faults] \
        [--out chiprun_out/readings.jsonl]

For each seed: the program's numbers against the plain reference (the
sound runs' lower readings), without a measured window; on each control
seed the control's (the reference in the program's place in the
precision below the configuration's: float8 e4m3 for the towers'
bfloat16, bfloat16 for the ranking's float32) and, with ``--faults``,
each fault planted under the timed path (the driver's ``FAULTS``).  The
cell's driver (``drivers/<kind>.py``) takes the readings.  One JSON line
a reading, with the worst leaves or rows beside the numbers.  The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import guard
    from benchmark.harness.registry import Registry
    from benchmark.harness.runner import Run

    guard.check("start")
    registry = Registry()
    cell = registry.cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(record):
        record["workload"] = args.workload
        record["card"] = torch.cuda.get_device_name()
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = Run(registry, cell, seed, 0.0, False)
        registry.driver(run.kind).readings(
            run, seed, seed in control, args.faults and seed in control,
            emit)
        run.release()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    guard.check("end")
    if out:
        out.close()


if __name__ == "__main__":
    main()
