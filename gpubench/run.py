"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Set-up (world and weights from the seed, warm-up of the cell's shapes),
then the measured window, then the check against the plain reference.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, read from a profiled window of at most
10 s), `device`, with --trace 1 `breakdown`,
and last `checks`, each number compared beside its limit. Without a CUDA
card, or with fewer cards than the cell asks for, it exits with code 3
and prints no result.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import harness

    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    sys.path.insert(0, harness.ROOT)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[gpubench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0,
                           log=lambda m: print(m, file=sys.stderr))
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
