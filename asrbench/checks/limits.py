"""The readings a cell's limits are set from, on the card: the program's compared numbers over many seeds, the
control's and the planted faults' over several, in one process (the kernels load once).

    python asrbench/checks/limits.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 \
        --seconds 5

``--control-seeds``: the fp8 reference in the program's place (:mod:`asrbench.checks.control`);
``--int8-seeds``: the program's own int8 serving path; ``--fault-seeds``: a served token altered, or half of a
training batch left out of the loss. Prints one JSON line a run: the seed, what ran, every compared number and
whether each of the cell's checks passed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from asrbench import core  # noqa: E402

KINDS = ("program", "control", "int8", "fault")


def readings(cell: str, seed: int, seconds: int, kind: str = "program") -> dict:
    from asrbench.checks import control as controls

    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=0)
    ctx = core.Ctx(args, time.perf_counter())
    serving = ctx.workload["traffic"] == "serve_batch"
    out = {"cell": cell, "seed": seed, "kind": kind}
    if kind == "control":
        gaps = controls.serve_control(ctx) if serving else controls.train_control(ctx)
    elif kind == "fault":
        gaps = controls.serve_fault_token(ctx) if serving else controls.train_fault_half(ctx)
    else:
        if kind == "int8":
            ctx.params = dict(ctx.params, control=True)
        importlib.import_module(f"asrbench.traffic.{ctx.workload['traffic']}").run(ctx)
        gaps = ctx.record["gaps"]
        out.update(setup_s=ctx.setup_s, attempted=ctx.record["attempted"])
    if kind in ("control", "fault"):
        controls.judged(ctx, gaps)
    out.update(gaps=gaps, passed={k: c["ok"] for k, c in ctx.checks.items()})
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    for kind in KINDS:
        p.add_argument(f"--{'seeds' if kind == 'program' else kind + '-seeds'}", dest=kind, default="")
    p.add_argument("--seconds", type=int, default=5)
    a = p.parse_args()
    for kind in KINDS:
        for s in filter(None, getattr(a, kind).split(",")):
            print(json.dumps(readings(a.workload, int(s), a.seconds, kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
