"""The harness: finds a cell's files by name, runs its traffic driver, reads its metrics and prints the result.

Everything that belongs to one configuration, traffic mix or metric sits in files of its own:

- ``BENCHMARK.json`` (the checkout's root) names the cell's configuration and traffic and lists the metrics;
- ``asrbench/workloads/<cell>.json``: the traffic kind, its parameters and the limits of the cell's checks;
- ``asrbench/configs/<config>.json`` (the file ``BENCHMARK.json`` gives): the model's sizes and its
  ``family``, whose code is ``asrbench/families/<family>.py``;
- ``asrbench/traffic/<kind>.py``: the driver of a traffic kind, ``run(ctx)``;
- ``asrbench/metrics/<metric>.json``: a metric's reader (``asrbench/readers/<reader>.py``) and its settings.

A driver fills ``ctx.record`` (the window's counts, the traced slice) and ``ctx.checks`` (each compared
number with its limit); the readers turn the record into metrics. A metric whose reader finds nothing to read
is left off the line, and the reason goes to standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "thunder_tpu")


class Ctx:
    """One run: the cell's files, the run's arguments, and what the driver records."""

    def __init__(self, args, t0: float, root: Path = ROOT):
        self.t0 = t0
        self.cell = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.benchmark = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in self.benchmark["workloads"] if w["name"] == args.workload), None)
        if entry is None:
            raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
        self.entry = entry
        self.workload = json.loads((BENCH / "workloads" / f"{self.cell}.json").read_text())
        cfg = next(c for c in self.benchmark["configs"] if c["name"] == entry["config"])
        self.config = json.loads((root / cfg["file"]).read_text())
        self.family = importlib.import_module(f"asrbench.families.{self.config['family']}")
        self.params = self.workload["params"]
        self.device = "cuda"
        self.setup_s = None
        self.record: dict = {}
        self.checks: dict = {}

    def window_starts(self) -> None:
        """Set-up ends here: imports, kernel loads (or builds), weights, data and warm-up."""
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value, limit, ok: bool) -> None:
        self.checks[name] = {"value": value, "limit": limit, "ok": bool(ok)}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metrics(ctx: Ctx, kind: str) -> dict:
    out = {}
    for metric in ctx.benchmark[kind]:
        if not applies(metric, ctx.cell):
            continue
        spec = json.loads((BENCH / "metrics" / f"{metric['name']}.json").read_text())
        reader = importlib.import_module(f"asrbench.readers.{spec['reader']}")
        value = reader.read(spec, ctx)
        if value is None:
            print(f"asrbench: {metric['name']}: nothing to read in this run ({spec.get('why_none', spec['reader'])})",
                  file=sys.stderr)
            continue
        if metric["unit"] == "%":  # readers give shares as fractions
            value *= 100.0
        out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark of thunder_tpu_torch on this machine.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(ctx: Ctx) -> dict | None:
    """Drive the cell on ``ctx.device`` and return its result line as a dict; None where the run loaded a module
    it must not."""
    import torch

    driver = importlib.import_module(f"asrbench.traffic.{ctx.workload['traffic']}")
    driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"asrbench: the run loaded {found}; the benchmark measures thunder_tpu_torch alone", file=sys.stderr)
        return None
    metrics = read_metrics(ctx, "per_layer" if ctx.trace else "end_to_end")
    on_card = torch.device(ctx.device).type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": ctx.entry["chips"], "memory_peak_bytes": int(ctx.record["memory_peak_bytes"])}
    if ctx.trace:
        from asrbench import trace

        lo, hi = ctx.record["trace"]["bounds"]
        device["busy_s"] = trace.union([(d[1], d[2]) for d in ctx.record["trace"]["device"]], lo, hi) * 1e-6
        device["window_s"] = (hi - lo) * 1e-6
    correct = bool(ctx.checks) and all(c["ok"] for c in ctx.checks.values())
    result = {"correct": correct, "attempted": ctx.record["attempted"], "failed": ctx.record["failed"],
              "metrics": metrics, "device": device}
    if ctx.trace:
        result["breakdown"] = trace.breakdown(ctx.record["trace"])
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in ctx.checks.items()}
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    ctx = Ctx(args, t0)
    chips = ctx.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"asrbench: {ctx.cell} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(ctx)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"asrbench check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def entry(t0: float) -> int:
    """``run.py``'s body: the repository root on the path, then :func:`main`."""
    os.environ.setdefault("USE_FLAX", "0")
    return main(sys.argv[1:], t0)
