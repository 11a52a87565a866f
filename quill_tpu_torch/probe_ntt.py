"""Kernel B's NTT product and kernel A's fused round split into their
steps on the card.

    python -m quill_tpu_torch.probe_ntt

1. builds `csrc/ntt.cu` and `csrc/sumcheck_round.cu` with `nvcc -Xptxas
   -v` and prints ptxas's registers, stack frame and spills for every
   kernel in them;
2. kernel A at the chip_smoke.py shapes (round 0 over 7 tables of 2^16,
   fold + round over 5 tables of 2^18, degree 3) and the same two scaled
   to tables of 2^22 (the 2^20-row prove's largest): the launches alone
   (CUDA events around the C call, its arguments made once), the wrapper
   `sumcheck.round_messages` (CUDA events over back-to-back calls, and the
   host clock of one call) and the messages' readback alone, each round
   held to the plain twin at 2^16 and 2^18;
3. the NTT product of two 2^18- and two 2^22-coefficient inputs (the
   2^16- and 2^20-row proves' largest, transforms of 2^19 and 2^23
   points): each launch of `ntt.poly_mul` (a's forward passes, b's forward
   passes, the product pass, the inverse passes), the twiddle table, the
   whole product, the S fold and the whole `TorchEngine.s_polynomial`.
Times are CUDA-event means after a warm-up.  The last line is one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import random
import subprocess
import time

import torch

from quill_tpu_torch.engine import sumcheck as sc
from quill_tpu_torch.engine.device import TorchEngine, TVec
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.kernels import build
from quill_tpu_torch.piops.virtual_poly import Const, Input
from quill_tpu_torch.poly import ntt
from quill_tpu_torch.probe_msm import _time, ptxas, scalars


def _a_cases():
    rng = random.Random(5)
    x = [Input(i) for i in range(7)]
    zero = (x[0] * x[1] - x[2]) * x[3] + (x[4] - x[5]) * x[6] + Const(R - 3)
    fold = (x[0] * x[1] - x[2]) * x[3] + x[4] * Const(5)
    return [("round 0, 7 tables of 2^16", 1 << 16, None, zero),
            ("fold + round, 5 tables of 2^18", 1 << 18, rng.randrange(R),
             fold),
            ("round 0, 7 tables of 2^22", 1 << 22, None, zero),
            ("fold + round, 5 tables of 2^22", 1 << 22, rng.randrange(R),
             fold)]


def kernel_a(dev) -> dict:
    out = {}
    for i, (what, n, r, expr) in enumerate(_a_cases()):
        tables = [scalars(n, dev, 40 + 7 * i + j)
                  for j in range(len(expr.used_inputs()))]
        got, _ = sc.round_messages(tables, expr, 3, r)
        if n <= 1 << 18:
            want, _ = sc.round_messages(tables, expr, 3, r, plain=True)
            if got != want:
                raise RuntimeError(f"kernel A differs from its twin: {what}")
        rec = dict(wrapper=_time(lambda: sc.round_messages(tables, expr, 3,
                                                           r)))
        # the launches alone: the wrapper's arguments, made once
        prep = sc.prepare(expr)
        p = prep.params()
        nt = 4
        partials = torch.empty((sc.MAX_GRID, nt, fd.NLIMB),
                               dtype=torch.int32, device=dev)
        res = torch.empty((nt, fd.NLIMB), dtype=torch.int32, device=dev)
        fn = sc._fn()

        def launch():
            build.check(fn(ctypes.addressof(p), nt, prep.slots,
                           partials.data_ptr(), res.data_ptr(),
                           build.stream_ptr()), "sumcheck_round")
        sc.round_messages(tables, expr, 3, r)    # fills p for this round
        rec["launches"] = _time(launch, reps=5)
        rec["readback"] = _time(lambda: fd.tensor_to_ints(res))
        rec["host_ms"] = (rec["wrapper"]["wall_ms"]
                          - rec["launches"]["ms"]
                          - rec["readback"]["wall_ms"])
        rec.update(ops=len(prep.prog.ops), depth=prep.prog.depth,
                   slots=prep.slots)
        out[what] = rec
        print(f"kernel A {what}: {json.dumps(rec)}", flush=True)
        del tables
    return out


def product_split(lg: int, dev) -> dict:
    """ntt.poly_mul of two 2^lg-coefficient inputs launch by launch, and
    s_polynomial of the same two."""
    m = 1 << lg
    logn = lg + 1
    n = 1 << logn
    a, b = scalars(m, dev, 10 + lg), scalars(m, dev, 20 + lg)
    passes = ntt.plan(logn)
    ntt.TABLES.clear()
    steps = dict(twiddles=_time(
        lambda: ntt.twiddle_table_cuda(logn, dev)))
    tw = ntt.twiddle_table(logn, dev)
    x = torch.empty((n, fd.NLIMB), dtype=torch.int32, device=dev)
    fa = ntt.poly_mul(a, b)           # a product: every buffer is warm
    for i, st in enumerate(ntt.forward_steps(passes)):
        src, valid = (a, m) if i == 0 else (x, n)
        steps[f"forward {st['b0']}-{st['b0'] + st['s'] - 1}"] = _time(
            lambda: ntt.pass_cuda(src, x, valid, logn, tw=tw, **st))
    for st in ntt.product_steps(passes, fa, logn)[len(passes) - 1:]:
        what = ("product pass" if st.get("y") is not None
                else f"inverse {st['b0']}-{st['b0'] + st['s'] - 1}")
        steps[what] = _time(
            lambda: ntt.pass_cuda(x, x, n, logn, tw=tw, **st))
    steps["forward transform"] = _time(lambda: ntt.ntt(x))
    steps["poly_mul"] = _time(lambda: ntt.poly_mul(a, b))
    h = ntt.poly_mul(a, torch.flip(b, [0]))
    steps["s_fold"] = _time(lambda: ntt.s_fold(h, m))
    eng = TorchEngine("cuda")
    fv, gv = TVec(a), TVec(b)
    steps["s_polynomial"] = _time(lambda: eng.s_polynomial(fv, gv))
    torch.cuda.synchronize()
    build.reset_counts()
    ntt.poly_mul(a, b)
    steps["launches_a_product"] = sum(
        v for k, v in build.LAUNCHES.items() if k.startswith("ntt_"))
    return steps


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    res = dict(card=card, ptxas={lib: ptxas(lib)
                                 for lib in ("ntt", "sumcheck")})
    print(f"ptxas ({time.time() - t0:.1f}s): {json.dumps(res['ptxas'])}",
          flush=True)
    res["kernel_a"] = kernel_a(dev)
    res["product"] = {}
    for lg in (18, 22):
        rec = product_split(lg, dev)
        res["product"][f"2^{lg} x 2^{lg}"] = rec
        print(f"product 2^{lg} x 2^{lg}: {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
