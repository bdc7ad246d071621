"""The control of the comparison that decides ``correct``: the plain
reference computed in TF32 (the nearest precision below the float32 the
configurations state, the step a later change would be tempted to take)
put in the program's place, judged by the same numbers and limits.  It
has to come out not correct.  ``--fault half_batch`` puts in the
program's place the reference with half of the batch left out of the loss
(the mean over the rest), a fault of a training step.

    python3 -m hgnnbench.control --workload rgat-mag.train --seeds 11 12 13

prints one JSON line a seed with the numbers and whether they pass.  The
benchmark's own runs do not run it; a CPU test runs it at a small size
(TF32 emulated by rounding the products' operands).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, harness
from .reference.common import precision


def readings(workload: str, seeds, *, device: str = "cuda", overrides: dict | None = None,
             fault: str = "tf32"):
    """[(seed, numbers, passes)] of the control (or ``fault``) at the
    cell's size."""
    bench = harness.benchmark()
    out = []
    for seed in seeds:
        run = harness.Run(bench, workload, seed, device, overrides)
        inputs = harness.make_inputs(run)
        graph = run.ref.prepare(run.cfg, inputs, run.device)
        ref = run.mode.reference(run, graph)
        if fault == "tf32":
            with precision("tf32"):
                low = run.mode.reference(run, graph)
        elif fault == "half_batch" and run.mode_name == "train":
            low = run.ref.train_steps(run.cfg, run.params, graph, run.traffic["checked_steps"],
                                      rows=int(graph["labels"].shape[0]) // 2)
        else:
            raise ValueError(f"no fault {fault!r} for a {run.mode_name} cell")
        if run.mode_name == "infer":
            low = [low]
        numbers = run.mode.numbers(run, low, ref)
        passes, _, _ = check.judge(numbers, run.cfg["limits"][run.mode_name])
        out.append((seed, numbers, passes))
        del run, inputs, graph, ref, low
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="tf32", choices=("tf32", "half_batch"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed, numbers, passes in readings(args.workload, args.seeds, fault=args.fault):
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "numbers": numbers, "passes": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
