"""Kernel I (`csrc/msm8.cu`) at the v8 route's shapes, for every number of
threads a lane, on the card.

    python -m quill_tpu_torch.probe_seg_scan [--against DIR]

1. builds a probe library that includes `csrc/msm8.cu` and launches its
   kernel with a given T (threads a lane), with `nvcc -Xptxas -v`, and
   prints ptxas's registers and spills for the kernel;
2. makes one v8 chunk as the route does (`msm8.chunk_entries`, 2^16
   uniform scalars against 2^16 points drawn from 256 multiples of G),
   then its block totals (`chunk_scan`) and the triangle's reversed
   buckets after `collect`: the chunk (5,120 x 256, flagged), block-scan
   (20 x 256, flagged) and triangle (640 x 256) lanes;
3. for each shape: kernel I through its wrapper (the T its rule picks,
   `msm8.scan_threads`) against the plain twin, equal points; then the
   probe kernel at every power of two T up to its block size, each held
   against the wrapper's output and timed by CUDA events (mean of 5
   launches after a warm-up);
4. with --against DIR, the `msm8.cu` of another checkout's csrc directory
   DIR, built the same way, timed and held against the wrapper at the same
   shapes in the same process.

The probe's T is never a knob of the route.  The last line is one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from .ec import curve
from .ec import device as ed
from .ec import msm8
from .fields import device as fd
from .kernels import build

PROBE_SOURCE = """#include "msm8.cu"

extern "C" int probe_seg_scan(const void* xs, const void* flags, long long m,
                              long long s, int T, void* ys, void* stream) {
  const long long lanes = SCAN_THREADS / T;
  seg_scan_kernel<<<(unsigned)((m + lanes - 1) / lanes), SCAN_THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)xs, (const uint8_t*)flags, m, s, T, (s + T - 1) / T,
      (uint32_t*)ys);
  return (int)cudaGetLastError();
}

extern "C" int probe_block_threads() { return SCAN_THREADS; }
"""


def _nvcc(source: Path, include: Path, out: Path) -> str:
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(include), "-o", str(out), str(source)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    return res.stdout + res.stderr


def ptxas_usage(log: str, kernel: str = "seg_scan_kernel") -> dict:
    """Registers and spill bytes of `kernel` from nvcc -Xptxas -v."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", text)
            return dict(registers=int(regs.group(1)),
                        spill_store_bytes=int(spill.group(1)),
                        spill_load_bytes=int(spill.group(2)))
    raise RuntimeError(f"ptxas printed nothing for {kernel}:\n{log}")


def _probe_lib():
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe_seg_scan.cu"
    src.write_text(PROBE_SOURCE)
    so = out_dir / "libprobe_seg_scan.so"
    usage = ptxas_usage(_nvcc(src, build.CSRC, so))
    lib = ctypes.CDLL(str(so))
    fn = build.bind(lib, "probe_seg_scan",
                    [build.VP, build.VP, build.I64, build.I64, build.I32,
                     build.VP, build.VP])
    return fn, usage, build.bind(lib, "probe_block_threads", [])()


def _against_lib(csrc: Path):
    out = build.build_dir() / "libmsm8_against.so"
    usage = ptxas_usage(_nvcc(csrc / "msm8.cu", csrc, out))
    fn = build.bind(ctypes.CDLL(str(out)), "quill_seg_scan",
                    [build.VP, build.VP, build.I64, build.I64, build.VP,
                     build.VP])
    return fn, usage


def chunk(dev, seed: int = 5):
    """One v8 chunk as the route makes it: 2^16 uniform scalars against 2^16
    points drawn from 256 multiples of G -> `msm8.chunk_entries`' (sorted
    digits, scan input, flags)."""
    g = curve.g1_generator()
    pool, _ = ed.affines_to_tensor(
        [g.scalar_mul(k + 2).to_affine() for k in range(256)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = msm8.CHUNK
    xy = pool[torch.randint(0, 256, (n,), generator=gen, device=dev)]
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF                    # canonical, below 2^252
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    return msm8.chunk_entries(words, xy, inf)


def shapes(dev, seed: int = 5):
    """-> {name: (xs, flags or None)}: one v8 chunk's three scans."""
    sorted_d, xs, flags = chunk(dev, seed)
    ys, wf, offs = msm8.chunk_scan(xs, flags)
    nb = xs.shape[0] // msm8.NWIN
    tot = ys[:, -1].reshape(msm8.NWIN, nb, 3, fd.NLIMB).contiguous()
    tot_f = wf[:, -1].reshape(msm8.NWIN, nb).contiguous()
    acc = msm8.collect(sorted_d, ys, wf, offs,
                       ed.identity(msm8.NWIN * msm8.NBUCK, dev))
    rev = acc.reshape(msm8.NWIN, msm8.NBUCK, 3, fd.NLIMB).flip(1).reshape(
        -1, msm8.BS, 3, fd.NLIMB).contiguous()
    return dict(chunk=(xs, flags), block_scan=(tot, tot_f),
                triangle=(rev, None))


def _time_ms(fn, reps: int = 5) -> float:
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


def _same(a, b) -> bool:
    a, b = a.reshape(-1, 3, fd.NLIMB), b.reshape(-1, 3, fd.NLIMB)
    return bool((a != 0).any(-1).any(-1).all()
                and ed.points_equal(a, b).all())


def run(against: Path | None = None) -> dict:
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    probe, usage, block = _probe_lib()
    other = _against_lib(against) if against is not None else None
    out = dict(card=card, ptxas=usage, shapes={})
    if other is not None:
        out["against_ptxas"] = other[1]
    stream = build.stream_ptr()
    for name, (xs, flags) in shapes(dev).items():
        m, s = xs.shape[:2]
        fp = None if flags is None else flags.data_ptr()
        want = msm8.seg_scan(xs, flags)
        if not _same(want, msm8.seg_scan_plain(xs, flags)):
            raise RuntimeError(f"kernel I differs from its twin at {name}")
        rec = dict(lanes=m, steps=s, rule_threads=msm8.scan_threads(m, s),
                   rule_ms=_time_ms(lambda: msm8.seg_scan(xs, flags)),
                   by_threads={})
        t = 1
        while t <= block:
            ys = torch.empty_like(xs)

            def launch(t=t, ys=ys):
                build.check(probe(xs.data_ptr(), fp, m, s, t, ys.data_ptr(),
                                  stream), "probe_seg_scan")

            ms = _time_ms(launch)
            if not _same(ys, want):
                raise RuntimeError(f"the probe at T = {t} differs at {name}")
            rec["by_threads"][t] = ms
            t *= 2
        if other is not None:
            ys = torch.empty_like(xs)

            def launch_other(ys=ys):
                build.check(other[0](xs.data_ptr(), fp, m, s, ys.data_ptr(),
                                     stream), "against seg_scan")

            rec["against_ms"] = _time_ms(launch_other)
            if not _same(ys, want):
                raise RuntimeError(f"the other kernel differs at {name}")
        out["shapes"][name] = rec
        print(f"{name} {m} x {s}: rule T = {rec['rule_threads']} "
              f"{rec['rule_ms']:.3f} ms; by T: "
              + ", ".join(f"{k}: {v:.3f}" for k, v in
                          rec["by_threads"].items())
              + (f"; against {rec['against_ms']:.3f} ms"
                 if other is not None else ""), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="csrc directory of another checkout to time")
    args = ap.parse_args()
    res = run(args.against)
    print(f"ptxas: {json.dumps(res['ptxas'])}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
