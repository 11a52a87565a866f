"""The small route's prefix tree (kernels F, G and H, `csrc/msm5.cu` +
`csrc/tree.cuh`) split into its launches on the card.

    python quill_tpu_torch/probe_tree.py [--root CHECKOUT] [--ptxas]
        [--reps N]

`--root` imports `quill_tpu_torch` from another checkout with the same
tree API (default: this one), so that one command can measure two trees
in turn.

1. with `--ptxas`, builds `csrc/msm5.cu` with `nvcc -Xptxas -v` and prints
   ptxas's registers, stack frame and spills for its kernels;
2. makes one batch of the small route as `chip_smoke.py` does: 4 MSMs of
   uniform scalars over the first 2^16 points of a tau CRS, 4 x 20 x 2^16
   sorted affine leaves;
3. times, by CUDA events (mean of N after a warm-up): kernel F on the
   leaves; one-level G on its output (1,310,720 adds); one-level H at the
   finest level; the whole `prefix_tree`, and its parts: F, the up
   launches, the fused top (where there is one) and the down launches,
   and each two-level launch alone;
   `collect` whole and its pairwise reduction alone (4 runs of 2^14
   points); v6's `reduce_sum` on 2^16 points; one `msm_batch` call and its
   launches by kernel.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 4                     # MSMs in the batch, as a 2^16-row prove's
TERMS = 1 << 14            # collect's terms a MSM: 8191 + 8191 + 2
V6_REDUCE = 1 << 16        # v6's reduce_sum: 2^16 - 1 queries + 1


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


def batch(dev):
    """-> (basis, Montgomery scalars, keys, perm, leaves, shifted basis)
    of one small-route batch of NB MSMs over 2^16 CRS points."""
    import torch

    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.probe_msm import scalars
    from quill_tpu_torch.probe_shifted import crs

    basis = crs(msm5.CHUNK, dev)
    sh = msm5.shifted(basis, 0)
    s_list = [scalars(msm5.CHUNK, dev, 70 + b) for b in range(NB)]
    scs = torch.stack([fd.from_mont(s, fd.FR) for s in s_list])
    keys, perm, leaves = msm5.sort_leaves(scs, basis.inf, sh)
    return basis, s_list, keys, perm, leaves, sh


def tree_parts(leaves, reps: int) -> dict:
    """`prefix_tree` whole and launch group by launch group."""
    from quill_tpu_torch.ec import msm5

    x1 = msm5.tree_up0(leaves)
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
        whole_ms=_events(lambda: msm5.prefix_tree(leaves), reps),
        f_ms=_events(lambda: msm5.tree_up0(leaves), reps),
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


def launches_per_call(basis, s_list) -> dict:
    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.kernels import build

    msm5.msm_batch(basis, s_list)         # the shifted basis is cached
    before = dict(build.LAUNCHES)
    msm5.msm_batch(basis, s_list)
    return {k: v - before[k] for k, v in build.LAUNCHES.items()
            if v != before[k]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.root)
    import torch

    from quill_tpu_torch.ec import msm5

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, root=os.path.abspath(args.root))
    if args.ptxas:
        from quill_tpu_torch.probe_msm import ptxas

        res["ptxas"] = ptxas("msm5")
        print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    basis, s_list, keys, perm, leaves, sh = batch(dev)
    x1 = msm5.tree_up0(leaves)
    x2 = msm5.tree_up(x1)
    reps = args.reps
    res["one_level"] = dict(
        adds=x2.shape[0], g_ms=_events(lambda: msm5.tree_up(x1), reps),
        h_ms=_events(lambda: msm5.tree_down(x2, x1), reps))
    print(f"one_level: {json.dumps(res['one_level'])}", flush=True)
    res["tree"] = tree_parts(leaves, reps)
    print(f"tree: {json.dumps(res['tree'])}", flush=True)
    i1 = msm5.prefix_tree(leaves)
    res["collect_ms"] = _events(lambda: msm5.collect(keys, perm, i1, sh, NB),
                                reps)
    res.update(reductions(x1, reps))
    res["msm_batch_ms"] = _events(lambda: msm5.msm_batch(basis, s_list),
                                  reps)
    res["launches_per_call"] = launches_per_call(basis, s_list)
    keys_ = ("collect_ms", "collect_reduce_ms", "v6_reduce_sum_ms",
             "msm_batch_ms", "launches_per_call")
    print(f"collect: {json.dumps({k: res[k] for k in keys_})}", flush=True)
    del x2, i1
    print(json.dumps(res))


if __name__ == "__main__":
    main()
