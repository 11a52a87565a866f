"""Kernel E's v8 collect mode (`csrc/msm8.cu: v8_collect_kernel`) against the
collect it replaced, on the card.

    python -m quill_tpu_torch.probe_collect

1. builds `csrc/msm8.cu` and `csrc/quotient.cu` with `nvcc -Xptxas -v` and
   prints ptxas's registers and spills for the collect kernel and for
   kernel M's three phases;
2. makes one v8 chunk as the route does (`probe_seg_scan.chunk`: 2^16
   uniform scalars against points drawn from 256 multiples of G), its
   scans, and an accumulator that already holds one chunk's buckets;
3. runs the earlier collect (`collect_sparse`: `collect_terms` --
   `searchsorted`, `torch.nonzero`, four gathers --, then kernel E's
   flagged and plain modes, then the `acc[sel]` gather and scatter), the
   fused kernel and its plain twin on copies of that accumulator: all three
   must give the same triples; then times the earlier collect part by part
   and whole and the fused kernel by CUDA events (mean of 10 after a
   warm-up), and the twin once;
4. a v8 MSM of 2^22 points (the same pool) with each collect, in the order
   fused, earlier, fused, earlier, equal points, by the host clock.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .ec import device as ed
from .ec import msm5, msm8
from .ec.msm import TorchBasis
from .fields import device as fd
from .kernels import build
from .probe_seg_scan import _nvcc, chunk, ptxas_usage

MSM_POINTS = 1 << 22


def collect_terms(sorted_d, ys, wf, offs):
    """The earlier collect's compaction: -> (accumulator rows w * NBUCK +
    digit, block offsets, scan values, within-block flag prefixes) of the
    digits that occur in the chunk.  Its `torch.nonzero` waits for the
    card."""
    dev = sorted_d.device
    npad = sorted_d.shape[1]
    q = torch.arange(msm8.NBUCK, dtype=sorted_d.dtype, device=dev).expand(
        msm8.NWIN, msm8.NBUCK).contiguous()
    pos = torch.searchsorted(sorted_d, q, right=True) - 1
    pc = pos.clamp(min=0)
    occurs = (pos >= 0) & (sorted_d.gather(1, pc) == q) & (q > 0)
    sel = torch.nonzero(occurs.reshape(-1)).flatten()
    win = sel // msm8.NBUCK
    last = pc.reshape(-1)[sel]
    idx = win * npad + last
    lane = win * (npad // msm8.BS) + last // msm8.BS
    return (sel, offs[lane], ys.reshape(-1, 3, fd.NLIMB)[idx],
            wf.reshape(-1)[idx])


def collect_sparse(sorted_d, ys, wf, offs, acc):
    """The earlier collect: kernel E's flagged mode into a fresh tensor, E
    again on a gather of acc[sel], scattered back."""
    sel, a, b, f = collect_terms(sorted_d, ys, wf, offs)
    acc[sel] = msm5.pt_add(acc[sel], msm5.pt_add(a, b, f))
    return acc


def _time_ms(fn, reps: int = 10) -> float:
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


def ptxas() -> dict:
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for src, kernels in (("msm8.cu", ("v8_collect_kernel",)),
                         ("quotient.cu", ("quot_scan_kernel",
                                          "quot_tiles_kernel",
                                          "quot_finish_kernel"))):
        log = _nvcc(build.CSRC / src, build.CSRC,
                    out_dir / f"libptxas_{src.split('.')[0]}.so")
        for k in kernels:
            res[k] = ptxas_usage(log, k)
    return res


def split(dev) -> dict:
    sorted_d, xs, flags = chunk(dev)
    ys, wf, offs = msm8.chunk_scan(xs, flags)
    del xs, flags
    acc0 = msm8.collect(sorted_d, ys, wf, offs,
                        ed.identity(msm8.NWIN * msm8.NBUCK, dev))
    old = collect_sparse(sorted_d, ys, wf, offs, acc0.clone())
    new = msm8.collect(sorted_d, ys, wf, offs, acc0.clone())
    plain = msm8.collect_plain(sorted_d, ys, wf, offs, acc0.clone())
    if not (torch.equal(old, new) and torch.equal(new, plain)):
        raise RuntimeError("the collects give different triples")
    sel, a, b, f = collect_terms(sorted_d, ys, wf, offs)
    g = acc0[sel]
    v = msm5.pt_add(g, msm5.pt_add(a, b, f))
    acc = acc0.clone()

    def gather_scatter():
        acc.index_select(0, sel)                 # the gather of acc[sel]
        acc[sel] = v

    rec = dict(
        active_buckets=int(sel.shape[0]),
        unflagged=int((~f).sum()),
        before_terms_ms=_time_ms(
            lambda: collect_terms(sorted_d, ys, wf, offs)),
        before_two_e_ms=_time_ms(
            lambda: msm5.pt_add(g, msm5.pt_add(a, b, f))),
        before_gather_scatter_ms=_time_ms(gather_scatter),
        before_ms=_time_ms(
            lambda: collect_sparse(sorted_d, ys, wf, offs, acc)),
        fused_ms=_time_ms(lambda: msm8.collect(sorted_d, ys, wf, offs, acc)),
        plain_ms=_time_ms(
            lambda: msm8.collect_plain(sorted_d, ys, wf, offs, acc), reps=1))
    return rec


def msm_times(dev) -> dict:
    from .ec import curve

    g = curve.g1_generator()
    pool, _ = ed.affines_to_tensor(
        [g.scalar_mul(k + 2).to_affine() for k in range(256)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    n = MSM_POINTS
    basis = TorchBasis(
        xy=pool[torch.randint(0, 256, (n,), generator=gen, device=dev)],
        inf=torch.zeros(n, dtype=torch.bool, device=dev), length=n)
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF
    s = fd.to_mont(words, fd.FR)
    fused = msm8.collect
    out = {"fused_s": [], "before_s": []}
    points = []
    try:
        for name, fn in (("fused_s", fused),
                         ("before_s", collect_sparse)) * 2:
            msm8.collect = fn
            torch.cuda.synchronize()
            t0 = time.time()
            points.append(msm8.msm(basis, s))
            torch.cuda.synchronize()
            out[name].append(time.time() - t0)
    finally:
        msm8.collect = fused
    if any(p != points[0] for p in points):
        raise RuntimeError("the v8 MSMs with the two collects differ")
    return out


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, ptxas=ptxas())
    print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    res["chunk"] = split(dev)
    print(f"collect on one chunk: {json.dumps(res['chunk'])}", flush=True)
    res["msm_2^22"] = msm_times(dev)
    print(f"v8 MSM of {MSM_POINTS} points: {json.dumps(res['msm_2^22'])}",
          flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
