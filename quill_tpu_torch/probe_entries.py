"""v8's entries step (`ec/msm8.py: chunk_entries`, `csrc/msm8.cu: v8e_*`)
and the v8 MSM around it, on the card.

    python quill_tpu_torch/probe_entries.py [--root CHECKOUT] [--ptxas]
                                            [--msm-reps N] [--sweep]

1. with --ptxas, builds `csrc/msm8.cu` with `nvcc -Xptxas -v` and prints
   ptxas's registers, stack frame and spills for the four entries kernels;
2. one v8 chunk of 2^16 uniform Montgomery scalars against 2^16 points
   drawn from 256 multiples of G: the entries step as the route runs it
   (`entries_ms`; on a checkout whose `chunk_entries` takes canonical
   scalars, `fd.from_mont` of the chunk's scalars and that call), and on
   this checkout's API also the plain twin (`plain_ms`, required equal with
   `torch.equal`) and each launch's device time (`by_kernel_ms`, from
   torch.profiler), all by CUDA events or the profiler's device clock;
   with --sweep the same at segments of 512 to 4096 scalars (`msm8.SEG`);
3. a v8 MSM of 2^22 points over the same pool and uniform scalars, warm,
   N times on the host clock with a synchronise (`msm_s`), its result
   required equal on every run.

`--root` imports `quill_tpu_torch` from another checkout (default: this
one), so a parent and its change run in one call, one process each.  The
last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("v8e_digits_kernel", "v8e_prefix_kernel", "v8e_place_kernel",
           "v8e_emit_kernel")


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _ptxas() -> dict:
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.probe_seg_scan import _nvcc, ptxas_usage

    out = build.build_dir() / "libmsm8_ptxas.so"
    log = _nvcc(build.CSRC / "msm8.cu", build.CSRC, out)
    return {k: ptxas_usage(log, k) for k in KERNELS}


def _events_ms(fn, reps: int = 10) -> float:
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


def _by_kernel_ms(fn, reps: int = 10) -> dict:
    """Mean device time a call of each entries kernel under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = ev.key.split("(")[0].split(" ")[-1]
        if name in KERNELS:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[name] = total / 1e3 / reps
    return out


def _pool(n: int, dev, seed: int):
    import torch

    from quill_tpu_torch.ec import curve
    from quill_tpu_torch.ec import device as ed

    g = curve.g1_generator()
    pool, _ = ed.affines_to_tensor(
        [g.scalar_mul(k + 2).to_affine() for k in range(256)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xy = pool[torch.randint(0, 256, (n,), generator=gen, device=dev)]
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF                    # below 2^252 < r
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    return xy.contiguous(), inf, words


def run(root: str, ptxas: bool, msm_reps: int, sweep: bool) -> dict:
    import torch

    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.ec import msm8
    from quill_tpu_torch.fields import device as fd

    dev = torch.device("cuda")
    res = dict(card=_card(), root=root)
    new_api = hasattr(msm8, "chunk_entries_plain")
    if ptxas and new_api:
        res["ptxas"] = _ptxas()
        print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)

    xy, inf, scs = _pool(msm8.CHUNK, dev, 5)
    if new_api:
        step = lambda: msm8.chunk_entries(scs, xy, inf)  # noqa: E731
    else:
        step = lambda: msm8.chunk_entries(  # noqa: E731
            fd.from_mont(scs, fd.FR), xy, inf)
    res["entries_ms"] = _events_ms(step)
    if new_api:
        got = step()
        want = msm8.chunk_entries_plain(scs, xy, inf)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("probe_entries: the kernels differ from the "
                             "plain twin")
        del got, want
        res["plain_ms"] = _events_ms(
            lambda: msm8.chunk_entries_plain(scs, xy, inf), reps=3)
        res["by_kernel_ms"] = _by_kernel_ms(step)
        if sweep:
            res["by_seg"] = {}
            seg = msm8.SEG
            for msm8.SEG in (512, 1024, 2048, 4096):
                res["by_seg"][msm8.SEG] = dict(
                    ms=_events_ms(step), by_kernel_ms=_by_kernel_ms(step))
            msm8.SEG = seg
    print(f"entries, one chunk: {json.dumps(res)}", flush=True)
    del xy, inf, scs

    if msm_reps:
        n = 1 << 22
        xy, inf, words = _pool(n, dev, 6)
        basis = M.TorchBasis(xy=xy, inf=inf, length=n)
        first = msm8.msm(basis, words)                       # warm
        times = []
        for _ in range(msm_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = msm8.msm(basis, words)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if got != first:
                raise SystemExit("probe_entries: the v8 MSM changed")
        res["msm_points"] = n
        res["msm_s"] = times
        print(f"v8 MSM of {n} points: {times}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--msm-reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[0] = root
    print(json.dumps(run(root, args.ptxas, args.msm_reps, args.sweep)))


if __name__ == "__main__":
    main()
