"""The prefix tree of the small route (kernels F, G and H, `csrc/msm5.cu` +
`csrc/tree.cuh`) and v6's leaf level (kernel K, the same kernel as F)
split into their launches on the card.

    python quill_tpu_torch/probe_tree.py [--root CHECKOUT] [--ptxas]
        [--reps N] [--prove REPS]

`--root` imports `quill_tpu_torch` from another checkout (default: this
one), so that one command can measure two trees in turn.  A checkout whose
`sort_leaves` still gathers the leaves (three outputs: keys, perm, leaves)
is run by that API: its gather is timed apart, and F, the tree and the
collect take the leaves.

1. with `--ptxas`, builds `csrc/msm5.cu` (and `csrc/msm6.cu` where the
   checkout has it) with `nvcc -Xptxas -v` and prints ptxas's registers,
   stack frame and spills for their kernels;
2. makes one batch of the small route as `chip_smoke.py` does: 4 MSMs of
   uniform scalars over the first 2^16 points of a tau CRS, 4 x 20 x 2^16
   sorted leaves;
3. times, by CUDA events (mean of N after a warm-up): `sort_leaves` (and
   on a gathering API its leaf gather alone); kernel F on the batch (on
   the sort's index, or on the gathered leaves); one-level G on F's
   output (1,310,720 adds); one-level H at the finest level; the whole
   `prefix_tree` (with the gather where the API has one) and its parts:
   F, the up launches, the fused top and the down launches, and each
   two-level launch alone; `collect` whole and its pairwise reduction
   alone (4 runs of 2^14 points); v6's `reduce_sum` on 2^16 points; one
   `msm_batch` call, its peak device memory and its launches by kernel;
4. v6 at the 2^16-row prove's largest MSM, 2^18 points of the CRS: kernel
   K on its 2^21 leaf pairs (CUDA events) and one whole v6 MSM (the host
   clock, synchronised);
5. with `--prove REPS`, chip_smoke.py's 2^16-row prove on the default
   engine and on `msm_impl="6"`, each REPS times after one warm-up prove
   (the host clock, synchronised).  It needs only the engine's API, so it
   runs the same on any checkout.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 4                     # MSMs in the batch, as a 2^16-row prove's
TERMS = 1 << 14            # collect's terms a MSM: 8191 + 8191 + 2
V6_REDUCE = 1 << 16        # v6's reduce_sum: 2^16 - 1 queries + 1
V6_POINTS = 1 << 18        # the 2^16-row prove's largest v6 MSM


def _events(fn, reps: int) -> float:
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


def _wall(fn, reps: int) -> float:
    """Host-clock mean of fn() and a synchronise, after a warm-up, ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def gathers() -> bool:
    """True where the checkout's `sort_leaves` gathers the leaves."""
    from quill_tpu_torch.ec import msm5

    return len(inspect.signature(msm5.sort_leaves).parameters) == 3


class Batch:
    """One small-route batch of NB MSMs over 2^16 CRS points, by the
    checkout's API: `sorted` is the sort's second output (perm or idx),
    `leaf_args` what F and `prefix_tree` take ((leaves,) or (sh, idx))."""

    def __init__(self, dev):
        import torch

        from quill_tpu_torch.ec import msm5
        from quill_tpu_torch.fields import device as fd
        from quill_tpu_torch.probe_msm import scalars
        from quill_tpu_torch.probe_shifted import crs

        self.basis = crs(msm5.CHUNK, dev)
        self.sh = msm5.shifted(self.basis, 0)
        self.s_list = [scalars(msm5.CHUNK, dev, 70 + b) for b in range(NB)]
        self.scs = torch.stack([fd.from_mont(s, fd.FR) for s in self.s_list])
        self.old = gathers()
        if self.old:
            self.keys, self.sorted, leaves = self.sort()
            self.leaf_args = (leaves,)
        else:
            self.keys, self.sorted = self.sort()
            self.leaf_args = (self.sh, self.sorted)

    def sort(self):
        from quill_tpu_torch.ec import msm5

        if self.old:
            return msm5.sort_leaves(self.scs, self.basis.inf, self.sh)
        return msm5.sort_leaves(self.scs, self.basis.inf)

    def gather(self):
        """The gathering API's leaf gather alone (`sort_leaves`' last
        line)."""
        from quill_tpu_torch.ec import msm5

        return self.sh[self.sorted % (msm5.NWIN * msm5.CHUNK)].contiguous()

    def tree_from_sort(self):
        """The sort's output to the tree's: the gather and `prefix_tree`
        on a gathering API, `prefix_tree` alone on this one."""
        from quill_tpu_torch.ec import msm5

        if self.old:
            return msm5.prefix_tree(self.gather())
        return msm5.prefix_tree(*self.leaf_args)


def leaf_times(b: Batch, reps: int) -> dict:
    from quill_tpu_torch.ec import msm5

    out = dict(pairs=b.keys.shape[0] // 2, gathers=b.old,
               sort_ms=_events(b.sort, reps),
               f_ms=_events(lambda: msm5.tree_up0(*b.leaf_args), reps),
               tree_from_sort_ms=_events(b.tree_from_sort, reps))
    if b.old:
        out["gather_ms"] = _events(b.gather, reps)
    return out


def tree_parts(args, reps: int) -> dict:
    """`prefix_tree` whole and launch group by launch group."""
    from quill_tpu_torch.ec import msm5

    x1 = msm5.tree_up0(*args)
    levels = [x1]
    while levels[-1].shape[0] > msm5.TOP:
        levels += msm5.tree_up2(levels[-1])
    p = msm5.tree_top(levels[-1])
    downs = range(len(levels) - 3, -1, -2)
    ps = [p]
    for k in downs:
        ps.append(msm5.tree_down2(ps[-1], levels[k + 1], levels[k]))

    def up():
        ls = [x1]
        while ls[-1].shape[0] > msm5.TOP:
            ls += msm5.tree_up2(ls[-1])

    def down():
        q = p
        for k in downs:
            q = msm5.tree_down2(q, levels[k + 1], levels[k])

    return dict(
        whole_ms=_events(lambda: msm5.prefix_tree(*args), reps),
        f_ms=_events(lambda: msm5.tree_up0(*args), reps),
        up_ms=_events(up, reps),
        top_ms=_events(lambda: msm5.tree_top(levels[-1]), reps),
        top_width=levels[-1].shape[0], down_ms=_events(down, reps),
        widths=[lv.shape[0] for lv in levels],
        up_launch_ms=[_events(lambda k=k: msm5.tree_up2(levels[k]), reps)
                      for k in range(0, len(levels) - 1, 2)],
        down_launch_ms=[_events(lambda k=k, q=q: msm5.tree_down2(
            q, levels[k + 1], levels[k]), reps)
            for k, q in zip(downs, ps)])


def reductions(x1, reps: int) -> dict:
    """collect's pairwise reduction (NB runs of TERMS points) and v6's
    reduce_sum (V6_REDUCE points)."""
    from quill_tpu_torch.ec import msm5, msm6

    terms = x1[:NB * TERMS].contiguous()
    v6 = x1[:V6_REDUCE].contiguous()
    return dict(collect_reduce_ms=_events(
                    lambda: msm5.tree_reduce(terms, TERMS), reps),
                v6_reduce_sum_ms=_events(lambda: msm6.reduce_sum(v6), reps))


def msm_batch_call(b: Batch, reps: int) -> dict:
    """One `msm_batch` call: its time, its peak device memory above what
    was allocated before it, and its launches by kernel."""
    import torch

    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.kernels import build

    call = lambda: msm5.msm_batch(b.basis, b.s_list)   # noqa: E731
    ms = _events(call, reps)        # the shifted basis is cached
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(build.LAUNCHES)
    call()
    torch.cuda.synchronize()
    return dict(msm_batch_ms=ms,
                msm_batch_peak_mb=(torch.cuda.max_memory_allocated() - base)
                / 2**20,
                launches_per_call={k: v - before[k]
                                   for k, v in build.LAUNCHES.items()
                                   if v != before[k]})


def v6(dev, reps: int) -> dict:
    """Kernel K and a whole v6 MSM at V6_POINTS points."""
    from quill_tpu_torch.ec import msm6
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.probe_msm import scalars
    from quill_tpu_torch.probe_shifted import crs

    bs = crs(V6_POINTS, dev)
    s = scalars(V6_POINTS, dev, 90)
    sh = msm6.shifted(bs, V6_POINTS)
    flat = sh.reshape(-1, 2, fd.NLIMB)
    _, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), bs.inf, sh.shape[1])
    return dict(pairs=idx.shape[0] // 2,
                k_ms=_events(lambda: msm6.level0(flat, idx), reps),
                msm_ms=_wall(lambda: msm6.msm(bs, s), reps))


def prove(reps: int) -> dict:
    """chip_smoke.py's 2^16-row prove, warm, on the default engine and on
    v6: {impl: [seconds, ...]}."""
    import torch

    from chip_smoke import COLS, LOG2_ROWS, fibonacci
    from quill_tpu_torch.engine.device import TorchEngine
    from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
    from quill_tpu_torch.pcs.setup import setup
    from quill_tpu_torch.proof.hyperplonk import HyperPlonk, TraceWitness

    rows = 1 << LOG2_ROWS
    circuit, witness = fibonacci(rows)
    out = {}
    for impl in ("7", "6"):
        engine = TorchEngine("cuda", msm_impl=impl)
        hp = HyperPlonk.preprocess(
            [circuit], MultilinearPCS(setup(engine, COLS * rows)))
        out[impl] = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hp.prove([TraceWitness(columns=witness)])
            torch.cuda.synchronize()
            if i:
                out[impl].append(time.perf_counter() - t0)
        del hp, engine
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--prove", type=int, default=0)
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.root)
    import torch

    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root))
    if args.ptxas:
        from quill_tpu_torch.probe_msm import ptxas

        res["ptxas"] = {lib: ptxas(lib) for lib in ("msm5", "msm6")
                        if lib in build.LIBS}
        print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    reps = args.reps
    b = Batch(dev)
    res["leaf"] = leaf_times(b, reps)
    print(f"leaf: {json.dumps(res['leaf'])}", flush=True)
    x1 = msm5.tree_up0(*b.leaf_args)
    x2 = msm5.tree_up(x1)
    res["one_level"] = dict(
        adds=x2.shape[0], g_ms=_events(lambda: msm5.tree_up(x1), reps),
        h_ms=_events(lambda: msm5.tree_down(x2, x1), reps))
    print(f"one_level: {json.dumps(res['one_level'])}", flush=True)
    del x2
    res["tree"] = tree_parts(b.leaf_args, reps)
    print(f"tree: {json.dumps(res['tree'])}", flush=True)
    i1 = msm5.prefix_tree(*b.leaf_args)
    res["collect_ms"] = _events(lambda: msm5.collect(
        b.keys, b.sorted, i1, b.sh, NB), reps)
    res.update(reductions(x1, reps))
    del x1, i1
    res.update(msm_batch_call(b, reps))
    keys_ = ("collect_ms", "collect_reduce_ms", "v6_reduce_sum_ms",
             "msm_batch_ms", "msm_batch_peak_mb", "launches_per_call")
    print(f"collect: {json.dumps({k: res[k] for k in keys_})}", flush=True)
    del b
    res["v6"] = v6(dev, reps)
    print(f"v6: {json.dumps(res['v6'])}", flush=True)
    if args.prove:
        res["prove_s"] = prove(args.prove)
        print(f"prove_s: {json.dumps(res['prove_s'])}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
