"""The control of `correct` on the card, at a cell's own size: for each
seed and each fault of `faults.py`, one run of the cell (`run.run`, as the
benchmark's own runs go, with the window cut to one prove) with the fault
planted in the timed path after set-up; the run's own `correct` and checks
are read.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--faults msm_altered,sumcheck_altered]

One JSON line per seed and fault.  Exits 1 if a faulted run comes out
correct.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import run

    run.hygiene()
    import torch

    import faults

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    names = [f for f in args.faults.split(",") if f] or sorted(faults.FAULTS)
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in names:
            t = time.time()
            try:
                res = run.run(args.workload, seed, 0.0, False, t_start=t,
                              fault=name)
            except Exception as exc:          # a crash is a failed control
                res = {"correct": False, "failed": 1,
                       "checks": {"raised": f"{type(exc).__name__}: {exc}"
                                  [:200]}}
            bad += bool(res["correct"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": name, "correct": res["correct"],
                              "failed": res["failed"],
                              "checks": res["checks"],
                              "run_s": time.time() - t}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
