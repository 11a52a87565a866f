"""Kernel J's CRS build and kernel E's v6 walk and add, split into their
steps on the card.

    python quill_tpu_torch/probe_crs.py [--root CHECKOUT] [--ptxas]
        [--sweep] [--steps STEP,...]

`--root` imports `quill_tpu_torch` from another checkout (default: this
one); each step takes the API it finds there, kernel J's signed windows
(`fixed_base.make_table`) and v6's walk (`msm6.query_walk`), or the
earlier ones (the 4-bit host table, 2^16-point launches and `to_affine`;
the chain of flagged kernel E launches), so that one command measures two
trees in turn.

1. with `--ptxas`, builds `csrc/fixed_base.cu` and `csrc/msm5.cu` with
   `nvcc -Xptxas -v` and prints ptxas's registers, stack frame and spills;
2. `crs`: `device_tau_powers` at 2^18 + 1 and 2^22 + 1 points, the first
   call of the process (cold) and the mean of 3 more on the host clock,
   synchronised; then its parts: the tau powers, the table, kernel J's
   launches (CUDA events) and, on the earlier API, `torch.cat` and
   `to_affine`; kernel J's launches a CRS;
3. `chunk`: kernel J on one 2^16-point chunk of tau powers, over the
   table of the 2^22 + 1-point CRS (on the earlier API: its launch, and
   `to_affine` of its output);
4. `walk`: a v6 MSM of 2^18 uniform scalars (the 2^16-row prove's
   largest): the top's prefix sums and the bucket queries, by the walk
   or the chain, and the whole MSM, with its launches
   by kernel;
5. `add`: kernel E's add at 2^16 to 2^8 points and at 20 (v8's
   triangle), flagged and not, by threads and by lanes where the API has
   them;
6. with `--sweep` (this API only), kernel J's table at every w of
   `fixed_base.W_RANGE` and the CRS launch over it at 2^18 + 1 and 2^22 +
   1 points.
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
CRS_SIZES = ((1 << 18) + 1, (1 << 22) + 1)
CHUNK = 1 << 16
V6_POINTS = 1 << 18


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
    """Host-clock mean of fn() followed by a synchronise, ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _launches(fn) -> dict:
    from quill_tpu_torch.kernels import build

    before = dict(build.LAUNCHES)
    fn()
    return {k: v - before[k] for k, v in build.LAUNCHES.items()
            if v != before[k]}


def _new_api() -> bool:
    from quill_tpu_torch.ec import fixed_base as fb

    return hasattr(fb, "make_table")


def _powers(n, dev):
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.pcs.kzg import _tau_from_seed

    return fd.from_mont(fd.powers(_tau_from_seed(0), n, fd.FR, dev), fd.FR)


def crs(dev) -> dict:
    from quill_tpu_torch.ec import curve, msm5
    from quill_tpu_torch.ec import fixed_base as fb
    from quill_tpu_torch.pcs.kzg import _tau_from_seed
    import torch

    tau, out = _tau_from_seed(0), {}
    for n in CRS_SIZES:
        res = dict(cold_ms=_wall(lambda: fb.device_tau_powers(tau, n, dev),
                                 1))
        res["ms"] = _wall(lambda: fb.device_tau_powers(tau, n, dev))
        res["launches"] = _launches(
            lambda: fb.device_tau_powers(tau, n, dev))
        res["powers_ms"] = _events(lambda: _powers(n, dev))
        s = _powers(n, dev)
        if _new_api():
            w = fb.window_for(n)
            table = fb.make_table(w, dev)
            res.update(w=w, table_ms=_wall(lambda: fb.make_table(w, dev)),
                       table_events_ms=_events(lambda: fb.make_table(w, dev)),
                       j_ms=_events(lambda: fb.fixed_base(s, table, w)))
        else:
            g = curve.g1_generator()
            res["table_ms"] = _wall(lambda: fb.build_table(g, dev), 1)
            table = fb.build_table(g, dev)

            def launches():
                return [fb.fixed_base(s[lo:lo + fb.CHUNK], table)
                        for lo in range(0, n, fb.CHUNK)]

            res["j_ms"] = _events(launches)
            parts = launches()
            res["cat_ms"] = _events(lambda: torch.cat(parts, 0))
            pts = torch.cat(parts, 0)
            del parts
            res["to_affine_ms"] = _wall(lambda: msm5.to_affine(pts))
            del pts
        del s
        out[str(n)] = res
        torch.cuda.empty_cache()
    return out


def chunk(dev) -> dict:
    from quill_tpu_torch.ec import curve, msm5
    from quill_tpu_torch.ec import fixed_base as fb

    s = _powers(CHUNK, dev)
    if _new_api():
        w = fb.window_for(CRS_SIZES[-1])
        table = fb.make_table(w, dev)
        return dict(w=w, points=CHUNK,
                    ms=_events(lambda: fb.fixed_base(s, table, w), 10))
    table = fb.build_table(curve.g1_generator(), dev)
    pts = fb.fixed_base(s, table)
    return dict(points=CHUNK, ms=_events(lambda: fb.fixed_base(s, table), 10),
                to_affine_ms=_wall(lambda: msm5.to_affine(pts)))


def walk(dev) -> dict:
    from quill_tpu_torch.ec import msm5, msm6
    from quill_tpu_torch.ec.msm import TorchBasis
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.ec.fixed_base import device_tau_powers
    from quill_tpu_torch.pcs.kzg import _tau_from_seed
    import torch

    n = V6_POINTS
    xy = device_tau_powers(_tau_from_seed(0), n, dev)
    basis = TorchBasis(xy=xy, inf=torch.zeros(n, dtype=torch.bool,
                                              device=dev), length=n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF
    s = fd.to_mont(words, fd.FR)
    sh = msm6.shifted(basis, n)
    keys, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), basis.inf,
                               sh.shape[1])
    cnt = torch.searchsorted(keys, torch.arange(
        msm6.NQ, dtype=torch.int32, device=dev), right=True)
    flat = sh.reshape(-1, 2, fd.NLIMB)
    levels = msm6.tree(flat, idx)
    res = dict(points=n, top_width=levels[-1].shape[0],
               levels=len(levels), buckets=msm6.NQ,
               chain_top_ms=_events(lambda: msm6.prefix(levels[-1])))
    top = msm6.prefix(levels[-1])
    res["chain_queries_ms"] = _events(
        lambda: msm6.queries(cnt, flat, idx, levels, top))
    res["chain_launches"] = _launches(
        lambda: msm6.queries(cnt, flat, idx, levels, top))
    if hasattr(msm6, "query_walk"):
        res["top_ms"] = _events(lambda: msm5.tree_top(levels[-1]))
        if not torch.equal(msm6.query_walk(cnt, flat, idx, levels, top),
                           msm6.queries(cnt, flat, idx, levels, top)):
            raise SystemExit("probe_crs: the walk differs from the chain")
        res["walk_ms"] = _events(lambda: msm6.query_walk(
            cnt, flat, idx, levels, top), 10)
    res["msm_ms"] = _wall(lambda: msm6.msm(basis, s))
    res["msm_launches"] = _launches(lambda: msm6.msm(basis, s))
    return res


def add(dev) -> dict:
    from quill_tpu_torch.ec import curve, msm5
    from quill_tpu_torch.ec import device as ed
    import torch

    g = curve.g1_generator()
    pool = ed.jacobians_to_proj([g.scalar_mul(k + 3) for k in range(64)],
                                dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    res = {}
    for n in (1 << 16, 1 << 14, 1 << 12, 1 << 10, 1 << 8, 20):
        a = pool[torch.randint(0, 64, (n,), device=dev, generator=gen)]
        b = pool[torch.randint(0, 64, (n,), device=dev, generator=gen)]
        f = torch.rand(n, device=dev, generator=gen) < 0.5
        a, b = a.contiguous(), b.contiguous()
        if "lanes" in msm5.pt_add.__code__.co_varnames:
            for lanes in (False, True):
                tag = f"{n}_{'lanes' if lanes else 'threads'}"
                for flags, fx in ((None, ""), (f, "_flagged")):
                    if not torch.equal(msm5.pt_add(a, b, flags, lanes=lanes),
                                       msm5.pt_add_plain(a, b, flags)):
                        raise SystemExit("probe_crs: kernel E's add differs "
                                         "from its twin")
                    res[tag + fx + "_ms"] = _events(
                        lambda: msm5.pt_add(a, b, flags, lanes=lanes), 10)
        else:
            res[f"{n}_ms"] = _events(lambda: msm5.pt_add(a, b), 10)
            res[f"{n}_flagged_ms"] = _events(lambda: msm5.pt_add(a, b, f), 10)
    return res


def sweep(dev) -> dict:
    from quill_tpu_torch.ec import fixed_base as fb
    import torch

    res = {}
    scal = {n: _powers(n, dev) for n in CRS_SIZES}
    for w in fb.W_RANGE:
        table = fb.make_table(w, dev)
        row = dict(table_points=fb.table_points(w),
                   table_mb=fb.table_points(w) * 64 / 1e6,
                   table_ms=_events(lambda: fb.make_table(w, dev)))
        for n, s in scal.items():
            row[f"crs_{n}_ms"] = _events(lambda: fb.fixed_base(s, table, w))
        res[w] = row
        print(f"sweep w={w}: {json.dumps(row)}", flush=True)
        del table
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--steps", default="crs,chunk,walk,add",
                    help="the steps 2-5 to run, comma-separated")
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

        res["ptxas"] = {lib: ptxas(lib) for lib in ("fixed_base", "msm5")}
        print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    steps = dict(crs=crs, chunk=chunk, walk=walk, add=add)
    for name in filter(None, args.steps.split(",")):
        res[name] = steps[name](dev)
        print(f"{name}: {json.dumps(res[name])}", flush=True)
        torch.cuda.empty_cache()
    if args.sweep:
        res["sweep"] = sweep(dev)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
