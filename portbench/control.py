#!/usr/bin/env python3
"""Readings of a cell's correctness numbers for the limits: the program's
sound runs and the control, the reference computed in the precision below
the configuration's and put in the program's place.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 --seconds 5

runs the cell once per seed (a short window at the cell's own load) and
prints, per seed, one JSON line with the run's own checks and each
control's.  The benchmark's own runs never run a control.  Controls by
driver: the embedding job's image and text towers in fp8 (configuration:
bfloat16)."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import run
from bench import device as dev
from bench import spec

CONTROLS = {
    "embed_job": ({"image_precision": "fp8", "text_precision": "fp8"},),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    run.program_in_checkout()
    cell = spec.resolve(args.workload)
    dev.require_cuda(1)
    controls = CONTROLS[cell.traffic["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        run.T_START = __import__("time").perf_counter()
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            result, checks = run.execute(cell, seed, args.seconds, False, torch.device("cuda", 0), workdir,
                                         controls=controls)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"seed": seed, "correct": result["correct"], "checks": checks,
                          "controls": result["notes"]["controls"], "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
