"""Kernel E's shifted basis and triangle doublings, and kernel M, split into
their steps on the card.

    python quill_tpu_torch/probe_shifted.py [--root CHECKOUT] [--ptxas]
        [--steps STEP,...] [--prove REPS]

`--root` imports `quill_tpu_torch` from another checkout of the same API
(default: this one), so that one command can measure two trees in turn.

1. with `--ptxas`, builds `csrc/msm5.cu` and `csrc/quotient.cu` with `nvcc
   -Xptxas -v` and prints ptxas's registers, stack frame and spills;
2. the shifted basis of one 2^16-point chunk of a tau CRS (the small
   route's 20 windows of 13 bits): its one launch (CUDA events) and
   `msm5.shifted` on a fresh basis whole (the host clock, synchronised);
3. the same for the v6 route's whole shifted basis over 2^18 points (16
   windows of 16 bits), `msm6.shifted` on a fresh basis each time;
4. v8's triangle on one chunk's bucket accumulators
   (`probe_seg_scan.shapes`): the whole `msm8.triangle` and its eight
   doublings of 20 points alone;
5. kernel M's wrapper `quotient.scan` at chip_smoke.py's two batches (4 x
   ~2^22 and 8 x ~2^18 coefficients) and at 8 x ~2^16 (the 2^16-row
   prove's batch of one-chunk openings), split into `quotient.launch`
   (its three launches with their output allocations, from PyTorch's
   cache; CUDA events, also at each run length of RUNS) and the y readback
   (the host clock after a synchronise);
6. with `--prove REPS`, the 2^16-row prove with a cold and a warm
   shifted-basis cache (`prove`).  It needs only the engine's API, so
   `--steps '' --prove REPS` also runs on a checkout of another API.
Times are means of 3 after a warm-up.  The last line is one JSON object
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V6_POINTS = 1 << 18
QUOT_BATCHES = {
    "4 x ~2^22": [1 << 22] * 2 + [(1 << 22) - 1] * 2,
    "8 x ~2^18": ([1 << 18] * 2 + [(1 << 18) - 1] * 2) * 2,
    "8 x ~2^16": ([1 << 16] * 2 + [(1 << 16) - 1] * 2) * 2,
}
RUNS = (16, 32, 64, 128)


def _events(fn, reps: int = 3) -> float:
    """CUDA-event mean of fn() over reps after one warm-up call, ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall(fn, reps: int = 3) -> float:
    """Host-clock mean of fn() followed by a synchronise, after a warm-up,
    ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return 1e3 * total / reps


def crs(n: int, dev):
    """A fresh basis over the first n points of the seed-0 tau CRS."""
    from quill_tpu_torch.ec.fixed_base import device_tau_powers
    from quill_tpu_torch.ec.msm import TorchBasis
    from quill_tpu_torch.pcs.kzg import _tau_from_seed
    import torch

    xy = device_tau_powers(_tau_from_seed(0), n, dev)
    return TorchBasis(xy=xy, inf=torch.zeros(n, dtype=torch.bool,
                                             device=dev), length=n)


def shifted_chunk(dev) -> dict:
    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.ec.msm import TorchBasis

    root = crs(msm5.CHUNK, dev)
    return dict(
        shifted_wall_ms=_wall(lambda: msm5.shifted(TorchBasis(
            xy=root.xy, inf=root.inf, length=root.length), 0)),
        launch_ms=_events(lambda: msm5.shifted_basis(root.xy, root.inf)))


def shifted_v6(dev) -> dict:
    from quill_tpu_torch.ec import msm5, msm6
    from quill_tpu_torch.ec.msm import TorchBasis

    root = crs(V6_POINTS, dev)
    return dict(
        points=V6_POINTS,
        shifted_wall_ms=_wall(lambda: msm6.shifted(TorchBasis(
            xy=root.xy, inf=root.inf, length=root.length), V6_POINTS)),
        launch_ms=_events(lambda: msm5.shifted_basis(
            root.xy, root.inf, msm6.NWIN, msm6.WBITS)))


def triangle(dev) -> dict:
    from quill_tpu_torch.ec import msm5, msm8
    from quill_tpu_torch.probe_seg_scan import shapes

    rev, _ = shapes(dev)["triangle"]
    acc = rev.reshape(msm8.NWIN, msm8.NBUCK, 3, -1).flip(1).reshape(
        msm8.NWIN * msm8.NBUCK, 3, -1).contiguous()
    t = msm8.triangle(acc)
    k = msm8.BS.bit_length() - 1
    return dict(triangle_ms=_events(lambda: msm8.triangle(acc)),
                doublings_ms=_events(lambda: msm5.pt_dbl(t, k)), doublings=k)


def quotient(dev) -> dict:
    import torch

    from quill_tpu_torch.engine import quotient as Q
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.probe_msm import scalars

    out = {}
    for tag, lengths in QUOT_BATCHES.items():
        cs = [scalars(n, dev, 4000 + j) for j, n in enumerate(lengths)]
        xs = [(7919 * (j + 3)) ** 5 % R for j in range(len(lengths))]
        ys, _ = Q.launch(cs, xs)
        out[tag] = dict(
            scan_ms=_events(lambda: Q.scan(cs, xs)),
            scan_wall_ms=_wall(lambda: Q.scan(cs, xs)),
            launches_ms=_events(lambda: Q.launch(cs, xs)),
            ys_readback_wall_ms=_wall(lambda: fd.tensor_to_ints(ys)),
            launches_ms_by_run={r: _events(lambda r=r: Q.launch(cs, xs, r))
                                for r in RUNS})
        del cs
        torch.cuda.empty_cache()
    return out


def prove(dev, reps: int) -> dict:
    """The 2^16-row Fibonacci prove of chip_smoke.py, reps times with the
    shifted-basis cache emptied before it (cold) and reps times with it
    kept (warm), alternating, after one warm-up prove: the difference is
    the shifted basis's share of the prove.  Host clock, synchronised."""
    import torch

    from chip_smoke import COLS, LOG2_ROWS, fibonacci
    from quill_tpu_torch.engine.device import TorchEngine
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
    from quill_tpu_torch.pcs.setup import setup
    from quill_tpu_torch.proof.hyperplonk import HyperPlonk, TraceWitness

    rows = 1 << LOG2_ROWS
    circuit, witness = fibonacci(rows)
    engine = TorchEngine("cuda")
    kzg = setup(engine, COLS * rows)
    hp = HyperPlonk.preprocess([circuit], MultilinearPCS(kzg))
    out = dict(cold_s=[], warm_s=[], cold_launches={})

    def once():
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hp.prove([TraceWitness(columns=witness)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return secs, {k: v - before[k] for k, v in build.LAUNCHES.items()
                      if k.startswith("msm5_") and v != before[k]}

    once()
    for _ in range(reps):
        kzg._basis.shifted.clear()
        secs, out["cold_launches"] = once()
        out["cold_s"].append(secs)
        secs, out["warm_launches"] = once()
        out["warm_s"].append(secs)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--steps", default="shifted_chunk,shifted_v6,triangle,"
                    "quotient", help="the steps 2-5 to run, comma-separated")
    ap.add_argument("--prove", type=int, default=0, metavar="REPS",
                    help="also time the 2^16-row prove REPS times with a "
                         "cold and a warm shifted-basis cache")
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.root)
    import torch

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root))
    if args.ptxas:
        from quill_tpu_torch.probe_msm import ptxas

        res["ptxas"] = {lib: ptxas(lib) for lib in ("msm5", "quotient")}
        print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    steps = dict(shifted_chunk=shifted_chunk, shifted_v6=shifted_v6,
                 triangle=triangle, quotient=quotient)
    for name in filter(None, args.steps.split(",")):
        res[name] = steps[name](dev)
        print(f"{name}: {json.dumps(res[name])}", flush=True)
        torch.cuda.empty_cache()
    if args.prove:
        res["prove"] = prove(dev, args.prove)
        print(f"prove: {json.dumps(res['prove'])}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
