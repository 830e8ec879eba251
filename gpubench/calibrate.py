"""Readings that set a cell's limits, on the card, in one process:

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3
                                  [--control] [--fault <name>]
                                  [--seconds 1]

For each seed one run of the cell through the harness's own `run_cell`
(set-up, a short window at the cell's own sizes, the check), with
--control the control in the program's place (the reference in the
precision below the configuration's), with --fault one of the cell
driver's faults planted in the timed path (stage drivers: `answer`,
`half`; the train driver: `unchanged`, `half`). One JSON line a seed:
`correct`, every number the check compared (`readings`) and each beside
its limit (`checks`). The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import harness

    harness.set_cache_dirs()
    sys.path.insert(0, harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               fault=args.fault, control=args.control,
                               log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "control": args.control, "correct": res["correct"],
            "setup_s": res["metrics"]["setup_s"]["value"],
            "window": res["window"], "readings": res["readings"],
            "checks": res["checks"],
            "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
