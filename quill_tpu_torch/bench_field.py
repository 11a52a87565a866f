"""Exactness check and throughput bench of the elementwise field and point
kernels: the port of `scripts/bench_field8.py`.

    python -m quill_tpu_torch.bench_field

1. exactness (`bench_field8.py:64-99`): 2048 random Fr products (and 2048
   Fq products) by `mont_mul_vec`, kernel L, against x y mod the modulus;
   64 point adds by `pt_add_vec` of random multiples of the generator
   against the host curve (`ec/curve.py`); then `pt_add_vec`, `pt_add_b16`
   and `seg_combine` (kernel E, plain and flagged) against their plain
   twins on 2^16 points;
2. rates (`:102-137`): `mont_mul_vec` over 2^18 elements and `pt_add_vec`
   over 2^16 points, each a chain of launches timed with CUDA events, the
   short chain's time taken off the long chain's as the JAX bench does.
   The host enqueues every chain behind a spin kernel (`torch.cuda._sleep`),
   so the events time the card and not the Python launch rate;
3. `fd.mul`, the engine's plain-torch product, on the same 2^18 elements;
4. each rate as a share of the bound model below: a CIOS product is 264
   32-bit multiply-adds, an SM issues 64 a clock.

It runs on "cuda" unless the caller passes another device; it times only
on a CUDA device.  The last line it prints is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess

import torch

from .ec import curve
from .ec import device as ed
from .ec import msm5
from .fields import device as fd
from .fields import vec
from .fields.bn254 import P, R
from .fields.device import FQ, FR

# the bound model (also `chip_smoke.py: bound`): a CIOS Montgomery product
# of bn254.cuh is 8 x (8 + 8) 32x32->64-bit multiply-adds, each a low and a
# high 32-bit IMAD, plus 8 low products for m: 264 IMADs; Hopper issues 64
# 32-bit IMADs per SM per clock
IMADS_PER_PRODUCT = 264
IMADS_PER_SM_CLOCK = 64
PRODUCTS_PER_ADD = 12      # bn254.cuh: g1_add, RCB15 algorithm 7
SPIN_CYCLES = 100_000_000  # ~50 ms at 2 GHz: longer than any chain's enqueue


def _fail(what: str):
    raise RuntimeError(f"bench_field: {what}")


def _points(rng, m: int, device):
    """m random multiples of the generator: host points and (m, 3, 8)
    projective tensors with Z = 1."""
    g = curve.g1_generator()
    pts = [g.scalar_mul(rng.randrange(1, R)) for _ in range(m)]
    xy, _ = ed.affines_to_tensor([p.to_affine() for p in pts], device)
    one = fd.const(1, FQ, device).expand(m, 1, fd.NLIMB)
    return pts, torch.cat((xy, one), 1).contiguous()


def check_exact(device, seed: int = 7, twin_n: int = 1 << 16) -> dict:
    """Raises on any mismatch; returns what was checked."""
    rng = random.Random(seed)
    n = 2048
    for field, mod in ((FR, R), (FQ, P)):
        xs = [rng.randrange(mod) for _ in range(n)]
        ys = [rng.randrange(mod) for _ in range(n)]
        out = vec.mont_mul_vec(fd.from_ints(xs, field, device),
                               fd.from_ints(ys, field, device), field)
        if fd.to_ints(out, field) != [x * y % mod for x, y in zip(xs, ys)]:
            _fail(f"mont_mul_vec ({field.name}) differs from x y mod p")
    m = 64
    p_host, p = _points(rng, m, device)
    q_host, q = _points(rng, m, device)
    got = ed.proj_to_jacobians(vec.pt_add_vec(p, q))
    if got != [a.add(b) for a, b in zip(p_host, q_host)]:
        _fail("pt_add_vec differs from the host curve")
    # the kernels against their plain twins, on random points tiled out
    reps = twin_n // m
    p, q = p.repeat(reps, 1, 1), q.roll(1, 0).repeat(reps, 1, 1)
    gen = torch.Generator().manual_seed(seed)
    f1 = (torch.rand(twin_n, generator=gen) < 0.5).to(device)
    f2 = (torch.rand(twin_n, generator=gen) < 0.5).to(device)
    plain = msm5.pt_add_plain(p, q)
    if not torch.equal(vec.pt_add_vec(p, q), plain):
        _fail("pt_add_vec differs from its plain twin")
    if not torch.equal(vec.pt_add_b16(p, q), plain):
        _fail("pt_add_b16 differs from its plain twin")
    v, f = vec.seg_combine((p, f1), (q, f2))
    if not (torch.equal(v, torch.where(f2[:, None, None], q, plain))
            and torch.equal(f, f1 | f2)):
        _fail("seg_combine differs from its plain twin")
    return dict(mont_mul_products=2 * n, pt_adds_vs_host=m,
                twin_points=twin_n)


def chain_ms(step, x, short: int, long: int, reps: int = 4) -> float:
    """Device ms of one x = step(x) launch: (the best of `reps` chains of
    `long` launches - the best of `reps` of `short`) / (long - short)."""
    def run(k):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = x
        for _ in range(k):
            y = step(y)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    run(short)
    run(long)
    ts, tl = [], []
    for _ in range(reps):
        ts.append(run(short))
        tl.append(run(long))
    return (min(tl) - min(ts)) / (long - short)


def clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def rates(device, seed: int = 7, clock: float | None = None,
          n: int = 1 << 18, k: int = 1 << 16) -> dict:
    """The rates of steps 2 to 4 on a CUDA device: n products, k adds."""
    rng = random.Random(seed)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = clock_mhz() if clock is None else clock
    model_products_s = sms * IMADS_PER_SM_CLOCK * clock * 1e6 \
        / IMADS_PER_PRODUCT

    base = fd.from_ints([rng.randrange(R) for _ in range(256)], FR, device)
    a = base.repeat(n // 256, 1)
    b = a.roll(1, 0).contiguous()
    mul_ms = chain_ms(lambda v: vec.mont_mul_vec(v, b, FR), a, 2, 66)
    plain_ms = chain_ms(lambda v: fd.mul(v, b, FR), a, 1, 4, reps=2)

    _, pts = _points(rng, 64, device)
    p = pts.repeat(k // 64, 1, 1)
    add_ms = chain_ms(lambda x: vec.pt_add_vec(x, p), p, 2, 34)

    mul_rate = n / (mul_ms / 1e3)
    add_rate = k / (add_ms / 1e3)
    return dict(
        mont_mul_n=n, mont_mul_ms=mul_ms, mont_mul_products_s=mul_rate,
        mont_mul_bytes_s=96 * mul_rate,
        mont_mul_share_of_model=mul_rate / model_products_s,
        fd_mul_ms=plain_ms, fd_mul_over_kernel=plain_ms / mul_ms,
        pt_add_n=k, pt_add_ms=add_ms, pt_adds_s=add_rate,
        pt_add_products_s=PRODUCTS_PER_ADD * add_rate,
        pt_add_share_of_model=PRODUCTS_PER_ADD * add_rate / model_products_s,
        model_products_s=model_products_s, sms=sms, clock_mhz=clock)


def run(device="cuda", seed: int = 7, clock: float | None = None) -> dict:
    device = torch.device(device)
    out = dict(device=str(device), exact=check_exact(device, seed))
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
        out.update(rates(device, seed, clock))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.device)
    if "mont_mul_ms" in res:
        print(f"mont_mul_vec: {res['mont_mul_products_s'] / 1e9:.2f} G "
              f"products/s ({res['mont_mul_ms'] * 1e3:.2f} us / "
              f"{res['mont_mul_n']} elements; "
              f"{100 * res['mont_mul_share_of_model']:.1f}% of the model); "
              f"fd.mul {res['fd_mul_ms']:.3f} ms")
        print(f"pt_add_vec: {res['pt_adds_s'] / 1e6:.1f} M adds/s "
              f"({res['pt_add_products_s'] / 1e9:.2f} G products/s, "
              f"{100 * res['pt_add_share_of_model']:.1f}% of the model; "
              f"{res['pt_add_ms'] * 1e3:.2f} us / {res['pt_add_n']} points)")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
