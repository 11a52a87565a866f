"""The C + D MSM route (`ec/msm.py`, kernels C and D of `csrc/msm.cu`)
split into its steps on the card.

    python -m quill_tpu_torch.probe_msm [--sweep] [--points LOG2 ...]

1. builds `csrc/msm.cu` with `nvcc -Xptxas -v` and prints ptxas's
   registers, stack frame and spills for every kernel in it;
2. makes the device CRS of the largest size asked for (`fixed_base`,
   kernel J) and uniform scalars from a seed;
3. for each size (default 2^18 and 2^20 points), times every step of one
   MSM by CUDA events (mean of 3 after a warm-up) and by the host clock
   around a synchronised call: the digits, `sorted_entries`, kernel C's
   phase, kernel D, `combine_windows` on the host, and the whole `msm`;
   the MSM must equal the host `curve.msm_host` at the smallest size;
4. with --sweep, kernel C at every entries-a-thread K of SWEEP_K (on the
   uniform scalars and on the identity column's 0..n-1), each held to the
   default K's output as points.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import subprocess
import time

import torch

from quill_tpu_torch.ec import curve
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.ec.fixed_base import device_tau_powers
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.kernels import build

SWEEP_K = (16, 32, 64, 128, 256)
HOST_CHECK_POINTS = 1 << 12   # the host MSM at this size: seconds


def ptxas(lib: str = "msm") -> dict:
    """The CUDA library `lib` (build.LIBS) built with nvcc -Xptxas -v ->
    {kernel: {registers, stack frame and spill bytes}}."""
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libprobe_{lib}.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(build.CSRC), "-o", str(so), str(build.CSRC / build.LIBS[lib])],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    return ptxas_usage(res.stdout + res.stderr)


def ptxas_usage(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel: {registers, stack frame and spill
    bytes}}, a template kernel named with its argument (int or bool)."""
    lines = log.splitlines()
    usage = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m is None:
            continue
        text = " ".join(lines[i:i + 4])
        regs = re.search(r"Used (\d+) registers", text)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", text)
        name = m.group(1)
        mangled = re.match(r"_Z(\d+)", name)
        if mangled:
            end = mangled.end() + int(mangled.group(1))
            # template arguments, each an int or a bool
            args = re.match(r"I((?:L[ib]\d+E)+)E", name[end:])
            name = name[mangled.end():end] + (
                "<" + ", ".join(re.findall(r"L[ib](\d+)E", args.group(1)))
                + ">" if args else "")
        usage[name] = dict(registers=int(regs.group(1)),
                           stack_frame_bytes=int(frame.group(1)),
                           spill_store_bytes=int(frame.group(2)),
                           spill_load_bytes=int(frame.group(3)))
    return usage


def _time(fn, reps: int = 3) -> dict:
    """CUDA-event mean over reps after a warm-up, and the host clock of one
    synchronised call; -> {"ms", "wall_ms"}."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / reps, wall_ms=wall)


def scalars(n: int, dev, seed: int) -> torch.Tensor:
    """n uniform canonical Fr scalars below 2^252, Montgomery form."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF
    return fd.to_mont(words, fd.FR)


def split(bs, s) -> dict:
    xy, inf = bs.xy.contiguous(), bs.inf
    mont = lambda: fd.from_mont(s, fd.FR)    # noqa: E731
    digits = M.signed_digits(mont())
    keys, entries = M.sorted_entries(digits, inf)
    steps = dict(
        digits=_time(lambda: M.signed_digits(mont())),
        sorted_entries=_time(lambda: M.sorted_entries(digits, inf)),
        c=_time(lambda: M.bucket_sums(xy, keys, entries)))
    dense = M.bucket_sums(xy, keys, entries)
    steps["d"] = _time(lambda: M.bucket_reduce(dense))
    wsums = M.bucket_reduce(dense)
    steps["combine_windows"] = _time(lambda: M.combine_windows(wsums))
    steps["msm"] = _time(lambda: M.msm(bs, s))
    steps["entries"] = int(keys.numel())
    return steps


def sweep(bs, s) -> dict:
    """Kernel C at every K of SWEEP_K (uniform scalars and the identity
    column's 0..n-1), held to the default K's output as points."""
    xy = bs.xy.contiguous()
    keys, entries = M.sorted_entries(
        M.signed_digits(fd.from_mont(s, fd.FR)), bs.inf)
    want = M.bucket_sums(xy, keys, entries)
    n = xy.shape[0]
    ids = torch.zeros((n, fd.NLIMB), dtype=torch.int32, device=xy.device)
    ids[:, 0] = torch.arange(n, dtype=torch.int32, device=xy.device)
    id_keys, id_entries = M.sorted_entries(M.signed_digits(ids), bs.inf)
    id_want = M.bucket_sums(xy, id_keys, id_entries)
    out = dict(c={}, c_id_column={}, id_column_entries=int(id_keys.numel()))
    for k in SWEEP_K:
        for tag, ks, es, w in (("c", keys, entries, want),
                               ("c_id_column", id_keys, id_entries,
                                id_want)):
            got = M.bucket_sums(xy, ks, es, test_k=k)
            if not bool(ed.points_equal(got, w).all()):
                raise RuntimeError(f"kernel C at K = {k} differs ({tag})")
            out[tag][k] = _time(lambda k=k, ks=ks, es=es: M.bucket_sums(
                xy, ks, es, test_k=k))["ms"]
    return out


def run(log2s, do_sweep: bool) -> dict:
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = dict(card=card, ptxas=ptxas(), sizes={})
    print(f"ptxas: {json.dumps(res['ptxas'])}", flush=True)
    rng = random.Random(3)
    n_max = 1 << max(log2s)
    root = M.TorchBasis(xy=device_tau_powers(rng.randrange(2, 1 << 250),
                                             n_max, dev).contiguous(),
                        inf=torch.zeros(n_max, dtype=torch.bool, device=dev),
                        length=n_max)
    # the route against the host MSM on a small slice
    n = HOST_CHECK_POINTS
    ints = [rng.randrange(fd.FR.modulus) for _ in range(n)]
    bs = M.slice_basis(root, n)
    pts = ed.proj_to_jacobians(fd.from_w16(ed.affine_to_proj_w(
        fd.to_w16(bs.xy))))
    if M.msm(bs, fd.from_ints(ints, fd.FR, dev)) != curve.msm_host(
            [p.to_affine() for p in pts], ints):
        raise RuntimeError("the C + D MSM differs from curve.msm_host")
    for lg in log2s:
        bs = M.slice_basis(root, 1 << lg)
        s = scalars(1 << lg, dev, 100 + lg)
        rec = split(bs, s)
        if do_sweep:
            rec["sweep"] = sweep(bs, s)
        res["sizes"][f"2^{lg}"] = rec
        print(f"2^{lg} points: {json.dumps(rec)}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[18, 20],
                    help="log2 of the MSM sizes to split")
    ap.add_argument("--sweep", action="store_true",
                    help="time kernel C at every K of SWEEP_K")
    args = ap.parse_args()
    print(json.dumps(run(args.points, args.sweep)))


if __name__ == "__main__":
    main()
