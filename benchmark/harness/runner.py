"""One run of one cell: parse the command line, find the cell's files,
check for the cards, hand the run to the driver of the cell's kind of
traffic (``drivers/<kind>.py``, found by name), read the metrics, judge
the outputs and print the result as the last line of standard output,
the numbers compared beside their limits as the last lines of standard
error."""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Optional

import torch

from ..reference import model as reference
from . import guard, inputs, judge
from .registry import Registry, reference_cfg


class Run:
    """A run's inputs and what it measured; the per-layer metric readers
    take it (``benchmark/metrics/*.py``)."""

    def __init__(self, registry: Registry, cell: dict, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 hooks: Optional[dict] = None, t0: float = 0.0):
        self.cell = cell
        self.config = registry.config(cell["config"])
        self.traffic = registry.traffic(cell["traffic"])
        limits = registry.limits(cell["name"])
        self.limits = limits["limits"]
        # {number: [leaf names]} a number does not take (judge.py)
        self.left_out = limits.get("left_out", {})
        self.kind = self.traffic["kind"]
        self.ref_cfg = reference_cfg(self.config)
        self.spec = reference.param_spec(self.ref_cfg)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.on_card else "cpu")
        solver = self.config["cfg"]["SOLVER"]
        # the schedule's rate in the first epoch: linear warmup from
        # WARMUP_FACTOR of the base rate
        self.lr = solver["BASE_LR"] * solver["WARMUP_FACTOR"]
        self.hooks = hooks or {}
        self.t0 = t0
        self.setup_s = math.nan
        self.window, self.launches, self.spans = {}, {}, {}
        # the traced calls without and with the host's calls
        self.trace_summary, self.call_summary = {}, {}
        self.traced_calls, self.traced_lengths = 0, []
        self.numbers, self.memory_peak, self.notes = {}, 0, []
        self.failed = 0  # calls of the window whose answer was no number

    def weights(self):
        """The run's weights; where the mix asks for it, BatchNorm's
        running statistics settled on ``settle_images`` images."""
        weights = inputs.make_weights(self.spec, self.seed, self.device)
        n = self.traffic.get("settle_images", 0)
        if n and any(kind == "running_var" for _, _, kind in self.spec):
            inp = self.ref_cfg["INPUT"]
            gen = torch.Generator(device=self.device).manual_seed(
                (self.seed ^ inputs.SETTLE_SALT) % 2 ** 63)
            pixels = inputs.make_pixels(self.traffic, n, inp["HEIGHT"],
                                        inp["WIDTH"], gen, self.device)
            inputs.settle_batchnorm(weights, self.ref_cfg, pixels)
        return weights

    def synchronize(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated() if self.on_card else 0

    def release(self) -> None:
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def parse(argv):
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run: Run, registry: Registry, e2e: dict) -> dict:
    name = run.cell["name"]
    metrics = {}
    if run.trace:
        for m in registry.metrics("per_layer", name):
            value = registry.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        readings = {**e2e, "setup_s": run.setup_s}
        for m in registry.metrics("end_to_end", name):
            metrics[m["name"]] = {"value": readings[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.on_card else "cpu",
              "kind": run.device_name,
              "count": run.cell["chips"], "memory_peak_bytes": run.memory_peak}
    out = {"correct": None, "attempted": run.window["calls"],
           "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.trace_summary:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        out["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                            "idle_gaps": run.trace_summary["idle_gaps"]}
    out["launches_per_call"] = run.launches
    return out


def main(argv=None, t0: Optional[float] = None, device: str = "cuda",
         registry: Optional[Registry] = None, hooks: Optional[dict] = None):
    """Returns the exit code; prints the result line on success."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    guard.check("start")
    registry = registry or Registry()
    cell = registry.cell(args.workload)
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count()
                                 >= cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    run = Run(registry, cell, args.seed, args.seconds, bool(args.trace),
              device, hooks, t0)
    e2e = registry.driver(run.kind).execute(run)
    verdict = judge.hold(run.numbers, run.limits)
    out = result_line(run, registry, e2e)
    out["correct"] = verdict["correct"]
    out["checks"] = verdict["checks"]
    guard.check("end")
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
