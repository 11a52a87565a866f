"""Prove and verify HyperPlonk proofs with quill_tpu_torch on one NVIDIA GPU:
the 2^16-row Fibonacci proof (every MSM on the small route or kernels C +
D), the same proof with the v6 MSM route (`msm_impl="6"`) and the 2^20-row
one (its largest MSMs on the v8 route), after checking the device CRS
against the host CRS, every hand-written kernel against its plain PyTorch
twin on the card, and running the field bench.

Usage (from the root of a checkout):
    python3 chip_smoke.py [--profile] [--cross-check]
--profile proves the 2^16 rows a second time under torch.profiler and
prints the device busy share and the kernels that take most of its time.
--cross-check proves the 2^20 rows a second time with every MSM off the
v8 route (`msm_shift_max` above the CRS: kernels C + D) and requires the
same bytes; the 2^20 pin below was fixed from such a run.

Phases, any failure exits non-zero:
1. device: a CUDA card is required; prints its name and power limit;
2. build: kernels A to L from quill_tpu_torch/csrc with nvcc (one process
   per source, all at once) and the host C libraries of native/ (G1
   arithmetic, BLAKE3) with gcc;
3. CRS: the host CRS of 2^18 + 1 points (native host EC, the reference),
   then the device CRS of 2^22 + 1 points (`setup`: kernel J and one
   batch inversion); its first 2^18 + 1 points must equal the host CRS and
   a random sample of later ones the native scalar products tau^i G;
4. kernels: each kernel against its plain twin on the card, exactly, at
   the shapes the proves give it, with the times of the kernel wrappers
   and of the plain twins and the least time the card could take for the
   same work; the 2^18-point MSMs also against the native host MSM; the
   small-route MSM of 4 x 2^16 points, v6 MSMs of 2^18 and 2^20 points and
   a v8 MSM of 2^22 points against kernels C and D on the same scalars;
5. field bench (`python -m quill_tpu_torch.bench_field`): kernel L's
   products and kernel E's elementwise adds against x y mod p, the host
   curve and their plain twins, and their rates on the card;
6. main path, 2^16 rows: setup (a CRS of 2^18 + 1 points) ->
   HyperPlonk.preprocess -> prove -> serialize_proof -> verify; the proof
   must be 17,936 bytes with the pinned sha256, and no MSM takes v8;
7. the same with `TorchEngine(msm_impl="6")` on a CRS of its own: the same
   bytes, some MSMs on v6 and none on C + D or v8;
8. main path, 2^20 rows, on the CRS of phase 3: preprocess -> prove ->
   serialize_proof -> verify; the proof must have the pinned length and
   sha256, and some MSMs must take v8.
Each path prints its phases, its kernel launches and its MSMs by route;
every kernel must have launched in the CRS build, the field bench or one
of the paths.  The line before the last is the per-kernel JSON record, the
last line the device record.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG2_ROWS = 16
PINNED_LEN = 17936
PINNED_SHA256 = ("d596d8df073be57fa253899e342fecc900fbb68931588b82"
                 "dacf8c9cf84060c6")
BIG_LOG2_ROWS = 20
BIG_PINNED_LEN = 20432
BIG_PINNED_SHA256 = ("b40f3c3a407bc7352e67c4bb5ec3779d2050f4d7bd2a15863c"
                     "6fa47a59c8ec91")
COLS = 4                   # the Fibonacci circuit's columns
HOST_CRS_DEGREE = 1 << 18  # the 2^16-row path's CRS, checked on the host
CRS_SAMPLES = 64           # later CRS points checked by native EC
# v6 MSMs of the kernel phase: the 2^16-row prove's largest, and the
# route's largest (a flat space of 2^24 leaves)
V6_POINTS = (1 << 18, 1 << 20)
FIELD_N = 1 << 18          # kernel L's products in the kernel phase


# bound model (`bound`): the field products' 32-bit IMADs at the card's
# peak int32 multiply-add rate (`quill_tpu_torch/bench_field.py`), or
# the bytes at HBM3's 3.35 TB/s on the H100 SXM
HBM_BYTES_PER_S = 3.35e12
PT = 96                    # bytes of one (3, 8) int32 projective point
AFF = 64                   # bytes of one (2, 8) int32 affine point
FE = 32                    # bytes of one field element


def log(*a):
    print(*a, flush=True)


def check(ok, what: str):
    """A failed check ends the run with a non-zero exit (not an assert, so
    `python -O` keeps it)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_phase():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    card = dict(kind=torch.cuda.get_device_name(0),
                sms=torch.cuda.get_device_properties(0).multi_processor_count,
                clock_mhz=float(clock.stdout.strip().splitlines()[0]))
    log(f"card: {card['sms']} SMs, max SM clock {card['clock_mhz']:.0f} MHz")
    return card


def bound(card, products: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the field products'
    IMADs over the int32 multiply-add rate and the bytes over HBM's rate."""
    from quill_tpu_torch.bench_field import (IMADS_PER_PRODUCT,
                                             IMADS_PER_SM_CLOCK)

    ops_ms = 1e3 * products * IMADS_PER_PRODUCT / (
        card["sms"] * IMADS_PER_SM_CLOCK * card["clock_mhz"] * 1e6)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    if ops_ms >= bytes_ms:
        return dict(bound_ms=ops_ms, bound_by="operations")
    return dict(bound_ms=bytes_ms, bound_by="bytes")


def build_phase():
    from quill_tpu_torch.ec import native_ec
    from quill_tpu_torch.hashing import blake3
    from quill_tpu_torch.kernels import build

    t0 = time.time()
    paths = build.build()
    t_cuda = time.time() - t0
    t0 = time.time()
    native = [build.native_lib(n) for n in build.NATIVE_LIBS]
    t_native = time.time() - t0
    check(native_ec.available(), "native EC backend failed to load")
    check(bool(blake3._load_native()), "native BLAKE3 failed to load")
    log(f"build: CUDA kernels {t_cuda:.1f}s "
        f"({', '.join(p.name for p in paths.values())}), host C "
        f"{t_native:.1f}s ({', '.join(p.name for p in native)})")


def cuda_ms(fn, reps=3):
    """Mean CUDA-event time of fn() over reps after one warm-up call."""
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


def max_abs_err(xs, ys) -> int:
    check(len(xs) == len(ys), "compared vectors differ in length")
    return max((abs(int(a) - int(b)) for a, b in zip(xs, ys)), default=0)


def tensor_err(a, b) -> int:
    """0 for equal (n, 8) Montgomery tensors, else the largest difference
    of their canonical values."""
    import torch

    from quill_tpu_torch.fields import device as fd

    if torch.equal(a, b):
        return 0
    return max_abs_err(fd.to_ints(a), fd.to_ints(b))


def point_err(p, q) -> int:
    """0 for equal points, else the largest coordinate difference of their
    affine forms."""
    a, b = p.to_affine(), q.to_affine()
    if a.infinity or b.infinity:
        return 0 if a.infinity == b.infinity else 1
    return max(abs(a.x.v - b.x.v), abs(a.y.v - b.y.v))


def points_err(ps, qs) -> int:
    """point_err over two (n, 3, 8) projective tensors."""
    import torch

    from quill_tpu_torch.ec import device as ed

    bad = torch.nonzero(~ed.points_equal(ps, qs)).flatten()
    return max([point_err(p, q) for p, q in zip(
        ed.proj_to_jacobians(ps[bad]), ed.proj_to_jacobians(qs[bad]))],
        default=0)


def uniform_scalars(n: int, dev, seed: int, edges=()):
    """n uniform canonical Fr scalars below 2^252 (< r), made on the card
    from a seed, the first ones replaced by `edges`, in Montgomery form."""
    import torch

    from quill_tpu_torch.fields import device as fd

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    words = torch.randint(0, 256, (n, 32), dtype=torch.uint8, device=dev,
                          generator=gen).view(torch.int32)
    words[:, 7] &= 0x0FFFFFFF
    words[:len(edges)] = fd.ints_to_tensor(list(edges), dev)
    return fd.to_mont(words, fd.FR)


def kernel_phase(engine, kzg, kzg_big, rng, card):
    """Each kernel against its plain twin at the shapes the proves give it.
    A to H at the 2^16-row prove's (4 columns make its merged tables, its
    largest products and its C + D MSMs 2^18 long; its small-route MSMs
    are batches of 4 over 2^16 points), on the host CRS `kzg`; I, J and
    E's flagged mode at the 2^20-row prove's (its CRS of 2^22 + 1 points
    in chunks of 2^16, its v8 MSMs of up to 2^22 points), on `kzg_big`.
    Times are of the kernel wrappers alone."""
    import torch

    from quill_tpu_torch.ec import curve, native_ec
    from quill_tpu_torch.ec import device as ed
    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.engine import sumcheck as sc
    from quill_tpu_torch.engine.expr import OP_MUL, compile_expr
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.piops.virtual_poly import Const, Input
    from quill_tpu_torch.poly import ntt

    dev = engine.device
    rows = 1 << LOG2_ROWS
    big = 4 * rows
    records = []

    def rand_fr(n):
        return fd.from_ints([rng.randrange(R) for _ in range(n)], fd.FR, dev)

    def record(name, source, replaces, products, nbytes, **kw):
        records.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **kw,
                            **bound(card, products, nbytes),
                            library_ms=None))

    # A: the prove's largest rounds, degree 3: round 0 over 7 tables of
    # 2^16, and a fused fold + round over 5 tables of 2^18
    x = [Input(i) for i in range(7)]
    cases = [
        ("round 0, 7 tables of 2^16", rows, None,
         (x[0] * x[1] - x[2]) * x[3] + (x[4] - x[5]) * x[6] + Const(R - 3)),
        ("fold + round, 5 tables of 2^18", big, rng.randrange(R),
         (x[0] * x[1] - x[2]) * x[3] + x[4] * Const(5)),
    ]
    err, times = 0, []
    for what, n, r, expr in cases:
        tables = [rand_fr(n) for _ in expr.used_inputs()]
        got, gf = sc.round_messages(tables, expr, 3, r)
        want, wf = sc.round_messages(tables, expr, 3, r, plain=True)
        err = max(err, max_abs_err(got, want))
        for a, b in zip(gf or [], wf or []):
            err = max(err, tensor_err(a, b))
        times.append((
            what, cuda_ms(lambda: sc.round_messages(tables, expr, 3, r)),
            cuda_ms(lambda: sc.round_messages(tables, expr, 3, r,
                                              plain=True), reps=1)))
        log(f"kernel A, {what}: {times[-1][1]:.3f} ms vs plain "
            f"{times[-1][2]:.3f} ms")
    check(err == 0, "kernel A disagrees with its plain twin")
    # per pair of folded outputs: 2 fold products per table, then the
    # program at t = 0..3; reads 4 rows and writes 2 per table
    k = len(cases[1][3].used_inputs())
    muls = sum(1 for op in compile_expr(cases[1][3]).ops if op == OP_MUL)
    pairs = big // 4
    record("sumcheck_round", "quill_tpu_torch/csrc/sumcheck_round.cu",
           "quill_tpu/engine/sumcheck8.py:292 (_round8_kernel); "
           "quill_tpu/engine/sumcheck8.py:174 (_entry_kernel)",
           pairs * (2 * k + 4 * muls), k * (big + big // 2) * FE,
           shape=times[1][0], max_abs_err=err, ms=times[1][1],
           plain_ms=times[1][2], round0_ms=times[0][1],
           round0_plain_ms=times[0][2])

    # B: the prove's largest product, 2^18 x 2^18 (transforms of 2^19)
    a, b = rand_fr(big), rand_fr(big)
    err = tensor_err(ntt.poly_mul(a, b), ntt.poly_mul(a, b, plain=True))
    small = fd.to_ints(ntt.poly_mul(a[:64], b[:64])[:127])
    host = engine.host
    want = host.poly_mul(host.vec_from_ints(fd.to_ints(a[:64])),
                         host.vec_from_ints(fd.to_ints(b[:64])))
    check(small == [int(v) for v in want],
          "kernel B product differs from the host product")
    n = 2 * big
    padded = torch.zeros((n, fd.NLIMB), dtype=torch.int32, device=dev)
    padded[:big] = a
    tw = ntt.twiddles(n, False, str(dev))
    xk = padded[ntt.bitrev(n, str(dev))].contiguous()
    xp = xk.clone()
    ntt.stages(xk, tw)
    ntt.stages(xp, tw, plain=True)
    err = max(err, tensor_err(xk, xp))
    check(err == 0, "kernel B disagrees with its plain twin")
    stages = n.bit_length() - 1
    record("ntt_stage", "quill_tpu_torch/csrc/ntt.cu",
           "quill_tpu/poly/ntt8.py:135 (_ntt_body)",
           stages * (n // 2), (2 * n + n // 2) * FE,
           shape="19 stages of one 2^19-point NTT (poly_mul 2^18 x 2^18)",
           max_abs_err=err, ms=cuda_ms(lambda: ntt.stages(xk, tw)),
           plain_ms=cuda_ms(lambda: ntt.stages(xp, tw, plain=True), reps=1))
    log(f"kernel B: exact; {records[-1]['ms']:.3f} ms vs plain "
        f"{records[-1]['plain_ms']:.3f} ms")

    # C and D: MSMs of 2^18 points on the tau CRS, with uniform scalars
    # (witness and quotient commitments) and with the identity column's
    # scalars 0..2^18-1, whose window-1 buckets hold 2^16 points each and
    # so take kernel C's projective levels
    pts = kzg.g1_points[:big]
    bs = M.slice_basis(kzg._basis, big)
    xy = bs.xy.contiguous()
    uniform = [rng.randrange(R) for _ in range(big)]
    uniform[:4] = [0, 1, R - 1, R - 2]
    err_c = err_d = 0
    c_times, d_times, c_work = {}, {}, {}
    for what, ints in (("uniform", uniform), ("id column", list(range(big)))):
        s = fd.from_ints(ints, fd.FR, dev)
        got = M.msm(bs, s)
        check(got == native_ec.msm(pts, ints),
              f"MSM of 2^18 points ({what}) disagrees with native EC")
        check(got == curve.msm_host(pts, ints),
              f"MSM of 2^18 points ({what}) disagrees with curve.msm_host")
        digits = M.signed_digits(fd.from_mont(s, fd.FR))
        keys, entries = M.sorted_entries(digits, bs.inf)
        uniq, levels = M.bucket_plan(keys)
        before = build.LAUNCHES["msm_bucket_sum"]
        sums_k = M.sum_levels(xy, entries, levels)
        check(build.LAUNCHES["msm_bucket_sum"] - before == len(levels),
              f"kernel C ({what}) did not launch once per level")
        if what == "id column":
            check(len(levels) > 1,
                  "the id column never reached kernel C's projective level")
        sums_p = M.sum_levels(xy, entries, levels, plain=True)
        err_c = max(err_c, points_err(sums_k, sums_p))
        # this data's work: a level-0 piece of L entries does one affine
        # add (9 products) and L - 2 mixed adds (11); a projective piece
        # L - 1 adds (12); each entry is read as an index and a point
        lens0 = levels[0][1].to(torch.int64)
        products = int(9 * (lens0 >= 2).sum() + 11 * (lens0 - 2).clamp(
            min=0).sum())
        nbytes = int(lens0.sum()) * (4 + AFF) + lens0.numel() * (8 + PT)
        for _, ln in levels[1:]:
            ln = ln.to(torch.int64)
            products += 12 * int((ln - 1).sum())
            nbytes += int(ln.sum()) * PT + ln.numel() * (8 + PT)
        c_work[what] = (products, nbytes)
        c_times[what] = (
            f"{keys.numel()} entries, {len(levels)} levels",
            cuda_ms(lambda: M.sum_levels(xy, entries, levels)),
            cuda_ms(lambda: M.sum_levels(xy, entries, levels, plain=True),
                    reps=1))
        log(f"kernel C, {what} ({c_times[what][0]}): {c_times[what][1]:.3f} "
            f"ms vs plain {c_times[what][2]:.3f} ms")
        dense = ed.identity(M.NWIN * M.NBUCK, dev)
        dense[uniq] = sums_k
        err_d = max(err_d, points_err(M.bucket_reduce(dense),
                                      M.bucket_reduce_plain(dense)))
        d_times[what] = (
            cuda_ms(lambda: M.bucket_reduce(dense)),
            cuda_ms(lambda: M.bucket_reduce_plain(dense), reps=1))
        log(f"kernel D, {what}: {d_times[what][0]:.3f} ms vs plain "
            f"{d_times[what][1]:.3f} ms")
        log(f"MSM 2^18 points, {what} (digits, sort, plan, kernels C+D, "
            f"host combine): {cuda_ms(lambda: M.msm(bs, s)):.3f} ms")
    check(err_c == 0, "kernel C disagrees with its plain twin")
    check(err_d == 0, "kernel D disagrees with its plain twin")
    u, i = c_times["uniform"], c_times["id column"]
    record("msm_bucket_sum", "quill_tpu_torch/csrc/msm.cu",
           "quill_tpu/ec/msm7k.py:81 (_lvl0s_kernel); "
           "quill_tpu/ec/msm6k.py:70 (_lvl_kernel)", *c_work["uniform"],
           shape=f"2^18-point MSM, uniform scalars: {u[0]}",
           max_abs_err=err_c, ms=u[1], plain_ms=u[2],
           id_column_shape=f"2^18-point MSM, scalars 0..2^18-1: {i[0]}",
           id_column_ms=i[1], id_column_plain_ms=i[2],
           id_column_bound_ms=bound(card, *c_work["id column"])["bound_ms"])
    # D: 2 adds per bucket in the segment pass; per segment j a
    # double-and-add by SEG * j and one add, then a 255-add tree
    nseg = M.NBUCK // M.SEG
    final = sum((M.SEG * j | 1).bit_length() + bin(M.SEG * j).count("1") + 1
                for j in range(nseg))
    record("msm_bucket_reduce", "quill_tpu_torch/csrc/msm.cu",
           "quill_tpu/ec/msm7.py:146-160 (v7 Fenwick query phase, XLA "
           "in the TPU build); quill_tpu/ec/msm6k.py:70 (_lvl_kernel)",
           12 * M.NWIN * (2 * M.NBUCK + final + nseg - 1),
           (M.NWIN * M.NBUCK + M.NWIN) * PT,
           shape="16 windows x 2^15 buckets (uniform scalars)",
           max_abs_err=err_d, ms=d_times["uniform"][0],
           plain_ms=d_times["uniform"][1], id_column_ms=d_times["id column"][0],
           id_column_plain_ms=d_times["id column"][1])

    # E to H: the small route, at the shapes of one batch of 4 one-chunk
    # MSMs.  The basis is a fresh one over the CRS points, with a shifted-
    # basis cache of its own, so the prove's cache stays cold and builds
    # its shifted basis, through kernel E, on the main path.
    own = M.TorchBasis(xy=kzg._basis.xy, inf=kzg._basis.inf,
                       length=kzg._basis.length)
    pts0, inf0 = msm5.chunk_points(own, 0)
    n = pts0.shape[0]
    other = msm5.pt_add(pts0, pts0)
    flags = torch.tensor([rng.random() < 0.5 for _ in range(n)],
                         dtype=torch.bool, device=dev)
    err_e = max(points_err(msm5.pt_add(pts0, other),
                           msm5.pt_add_plain(pts0, other)),
                points_err(msm5.pt_add(pts0, other, flags),
                           msm5.pt_add_plain(pts0, other, flags)))
    lad_k = msm5.shift_ladder(pts0)
    lad_p = msm5.shift_ladder(pts0, plain=True)
    err_e = max(err_e, points_err(lad_k.reshape(-1, 3, fd.NLIMB),
                                  lad_p.reshape(-1, 3, fd.NLIMB)))
    check(err_e == 0, "kernel E disagrees with its plain twin")
    e_times = dict(
        ms=cuda_ms(lambda: msm5.pt_add(pts0, other)),
        plain_ms=cuda_ms(lambda: msm5.pt_add_plain(pts0, other), reps=1),
        flagged_ms=cuda_ms(lambda: msm5.pt_add(pts0, other, flags)),
        flagged_plain_ms=cuda_ms(
            lambda: msm5.pt_add_plain(pts0, other, flags), reps=1),
        ladder_ms=cuda_ms(lambda: msm5.shift_ladder(pts0), reps=1),
        ladder_plain_ms=cuda_ms(lambda: msm5.shift_ladder(pts0, plain=True),
                                reps=1))
    del lad_p
    log(f"kernel E, 2^16 adds: {e_times['ms']:.3f} ms vs plain "
        f"{e_times['plain_ms']:.3f} ms; flagged {e_times['flagged_ms']:.3f} "
        f"ms; 247-pass ladder {e_times['ladder_ms']:.3f} ms vs plain "
        f"{e_times['ladder_plain_ms']:.3f} ms")
    record("msm5_pt_add", "quill_tpu_torch/csrc/msm5.cu",
           "quill_tpu/fields/pallas8.py:475 (_stacked_combine_kernel)",
           12 * n, 3 * n * PT, shape="2^16 elementwise adds (one pass of "
           "the shifted basis's 247-pass doubling ladder)", max_abs_err=err_e,
           **e_times)

    sh = msm5.to_affine(lad_k.reshape(-1, 3, fd.NLIMB))
    del lad_k
    vecs = [[rng.randrange(R) for _ in range(n)] for _ in range(4)]
    vecs[0][:4] = [0, 1, R - 1, (1 << 13) - 1]
    s_list = [fd.from_ints(v, fd.FR, dev) for v in vecs]
    scs = torch.stack([fd.from_mont(t, fd.FR) for t in s_list])
    keys, perm, leaves = msm5.sort_leaves(scs, inf0, sh)
    check(leaves.shape[0] == 4 * msm5.NWIN * n,
          "the small route's batch is not 4 x 20 x n leaves")
    x1 = msm5.tree_up0(leaves)
    err_f = points_err(x1, msm5.tree_up0_plain(leaves))
    check(err_f == 0, "kernel F disagrees with its plain twin")
    x2 = msm5.tree_up(x1)
    err_g = points_err(x2, msm5.tree_up_plain(x1))
    check(err_g == 0, "kernel G disagrees with its plain twin")
    err_h = points_err(msm5.tree_down(x2, x1), msm5.tree_down_plain(x2, x1))
    check(err_h == 0, "kernel H disagrees with its plain twin")
    k1, k2 = x1.shape[0], x2.shape[0]
    for name, src, fn, plain, products, nbytes, shape, err in (
            ("msm5_tree_up0", "quill_tpu/ec/msm5.py:245 (_up0_kernel)",
             lambda: msm5.tree_up0(leaves),
             lambda: msm5.tree_up0_plain(leaves), 9 * k1,
             2 * k1 * AFF + k1 * PT,
             f"{k1} affine leaf pairs (4 MSMs x 20 windows x {n} points)",
             err_f),
            ("msm5_tree_up", "quill_tpu/ec/msm3.py:258 (_up_kernel)",
             lambda: msm5.tree_up(x1), lambda: msm5.tree_up_plain(x1),
             12 * k2, 3 * k2 * PT, f"first projective level, {k2} adds",
             err_g),
            ("msm5_tree_down", "quill_tpu/ec/msm3.py:267 (_down_kernel)",
             lambda: msm5.tree_down(x2, x1),
             lambda: msm5.tree_down_plain(x2, x1), 12 * k2, 4 * k2 * PT,
             f"finest down level, {k2} adds, {2 * k2} outputs", err_h)):
        t_k, t_p = cuda_ms(fn), cuda_ms(plain, reps=1)
        log(f"kernel {name}: {shape}: {t_k:.3f} ms vs plain {t_p:.3f} ms")
        record(name, "quill_tpu_torch/csrc/msm5.cu", src, products, nbytes,
               shape=shape, max_abs_err=err, ms=t_k, plain_ms=t_p)
    del leaves, x1, x2

    # the whole small-route MSM against kernels C and D, same 4 vectors
    bs_own = M.slice_basis(own, n)
    bs_cd = M.slice_basis(kzg._basis, n)
    got = msm5.msm_batch(bs_own, s_list)
    want = [M.msm(bs_cd, t) for t in s_list]
    check(all(g == w for g, w in zip(got, want)),
          "the small-route MSM disagrees with kernels C and D")
    small_ms = cuda_ms(lambda: msm5.msm_batch(bs_own, s_list))
    cd_ms = cuda_ms(lambda: [M.msm(bs_cd, t) for t in s_list])
    log(f"4 MSMs of {n} points: small route (one batch) {small_ms:.3f} ms, "
        f"kernels C + D (one at a time) {cd_ms:.3f} ms; equal")
    for rec in records[-4:]:
        rec["small_route_batch_ms"] = small_ms
        rec["cd_same_4_msms_ms"] = cd_ms
    records += v6_kernels(kzg, kzg_big, card)
    records.append(field_kernel(dev, rng, card))
    records += v8_kernels(kzg_big, records, card)
    return records


def v6_kernels(kzg, kzg_big, card):
    """v6 MSMs of 2^18 points (the 2^16-row prove's largest v6 MSM) on the
    host CRS and of 2^20 points (the route's largest: a flat space of 2^24
    leaves) on the big CRS, each against kernels C + D on the same uniform
    scalars, both timed once warm; kernel K against its plain twin on the
    2^18-point MSM's 2^21 leaf pairs.  Each MSM runs on a basis object of
    its own, so its shifted basis is freed after it and the v6 prove
    builds its own on the main path."""
    import torch

    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.ec import msm6
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R

    dev = kzg._basis.xy.device
    times = {}
    for root, n in ((kzg._basis, V6_POINTS[0]), (kzg_big._basis,
                                                  V6_POINTS[1])):
        tag = f"2^{n.bit_length() - 1}"
        own = M.TorchBasis(xy=root.xy, inf=root.inf, length=root.length)
        bs, bs_cd = M.slice_basis(own, n), M.slice_basis(root, n)
        s = uniform_scalars(n, dev, n + 6, [0, 1, R - 1, R - 2] + [
            0xFFFF << (16 * w) for w in range(15)])
        torch.cuda.synchronize()
        t0 = time.time()
        sh = msm6.shifted(bs, n)
        torch.cuda.synchronize()
        times[f"shifted_basis_{tag}_s"] = time.time() - t0
        got = msm6.msm(bs, s)
        check(got == M.msm(bs_cd, s),
              f"the v6 MSM of {tag} points disagrees with kernels C and D")
        for route, fn in (("v6", lambda: msm6.msm(bs, s)),
                          ("cd", lambda: M.msm(bs_cd, s))):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            times[f"{route}_msm_{tag}_s"] = time.time() - t0
        log(f"MSM of {n} points, uniform scalars: v6 route "
            f"{times[f'v6_msm_{tag}_s']:.3f} s, kernels C + D "
            f"{times[f'cd_msm_{tag}_s']:.3f} s; equal (shifted basis "
            f"{sh.shape[0]} x {sh.shape[1]} points built in "
            f"{times[f'shifted_basis_{tag}_s']:.3f} s)")
        if n == V6_POINTS[0]:
            flat = sh.reshape(-1, 2, fd.NLIMB)
            _, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), bs.inf,
                                    sh.shape[1])
            err = points_err(msm6.level0(flat, idx),
                             msm6.level0_plain(flat, idx))
            check(err == 0, "kernel K disagrees with its plain twin")
            k = idx.shape[0] // 2
            rec = dict(
                name="msm6_level0", route="cuda",
                source="quill_tpu_torch/csrc/msm6.cu",
                replaces="quill_tpu/ec/msm6k.py:58 (_lvl0_kernel)",
                shape=f"{k} affine leaf pairs gathered through the sort "
                      f"(a v6 MSM of {n} points: 16 x {n} leaves)",
                max_abs_err=err, ms=cuda_ms(lambda: msm6.level0(flat, idx)),
                plain_ms=cuda_ms(lambda: msm6.level0_plain(flat, idx),
                                 reps=1),
                **bound(card, 9 * k, k * (2 * 4 + 2 * AFF + PT)),
                library_ms=None)
            log(f"kernel K, {k} pairs: {rec['ms']:.3f} ms vs plain "
                f"{rec['plain_ms']:.3f} ms")
            del flat, idx
        del own, bs, sh, s
    rec.update(times)
    return [rec]


def field_kernel(dev, rng, card):
    """Kernel L against `fd.mul` on 2^18 elements of Fr and of Fq."""
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields import vec

    n = FIELD_N
    out = {}
    for f in (fd.FR, fd.FQ):
        a = fd.from_ints([rng.randrange(f.modulus) for _ in range(n)], f, dev)
        b = a.roll(1, 0).contiguous()
        err = tensor_err(vec.mont_mul_vec(a, b, f),
                         vec.mont_mul_vec_plain(a, b, f))
        check(err == 0, f"kernel L ({f.name}) disagrees with its plain twin")
        out[f.name] = (err, cuda_ms(lambda: vec.mont_mul_vec(a, b, f)),
                       cuda_ms(lambda: vec.mont_mul_vec_plain(a, b, f)))
        log(f"kernel L, {n} {f.name} products: {out[f.name][1]:.3f} ms vs "
            f"plain (fd.mul) {out[f.name][2]:.3f} ms")
    return dict(
        name="field_mul", route="cuda", source="quill_tpu_torch/csrc/field.cu",
        replaces="quill_tpu/fields/pallas8.py:113 (_mul_kernel)",
        shape=f"{n} elementwise Fr Montgomery products",
        max_abs_err=max(out["fr"][0], out["fq"][0]), ms=out["fr"][1],
        plain_ms=out["fr"][2], **bound(card, n, 3 * n * FE), library_ms=None,
        fq_ms=out["fq"][1], fq_plain_ms=out["fq"][2])


def field_bench(card, records):
    """The field bench (`quill_tpu_torch/bench_field.py`): exactness, then
    the chained rates of kernels L and E, added to their records.  -> its
    launches."""
    import torch

    from quill_tpu_torch import bench_field
    from quill_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_counts()
    res = bench_field.run("cuda", clock=card["clock_mhz"])   # raises
    launches = dict(build.LAUNCHES)
    log(f"field bench: exact ({json.dumps(res['exact'])}); mont_mul_vec "
        f"{res['mont_mul_products_s'] / 1e9:.2f} G products/s "
        f"({1e3 * res['mont_mul_ms']:.2f} us a launch of "
        f"{res['mont_mul_n']}, {100 * res['mont_mul_share_of_model']:.1f}% "
        f"of the bound model), fd.mul {res['fd_mul_ms']:.3f} ms; pt_add_vec "
        f"{res['pt_adds_s'] / 1e6:.1f} M adds/s ({1e3 * res['pt_add_ms']:.2f}"
        f" us a launch of {res['pt_add_n']}, "
        f"{100 * res['pt_add_share_of_model']:.1f}% of the model)")
    log("field bench: " + json.dumps(res))
    by_name = {r["name"]: r for r in records}
    by_name["field_mul"].update(
        bench_chain_ms=res["mont_mul_ms"],
        bench_products_s=res["mont_mul_products_s"],
        bench_share_of_model=res["mont_mul_share_of_model"],
        bench_fd_mul_ms=res["fd_mul_ms"])
    by_name["msm5_pt_add"].update(
        bench_pt_add_vec_chain_ms=res["pt_add_ms"],
        bench_pt_adds_s=res["pt_adds_s"],
        bench_share_of_model=res["pt_add_share_of_model"])
    return launches


SCAN_PATTERNS = ("none", "all", "boundary", "last", "random8", "random64")


def scan_flags(pattern: str, m: int, s: int, t: int, gen):
    """(m, s) adversarial flags for kernel I on the card: none, all, at
    every run boundary of its t threads a lane, only at the last step, or
    random at 1/8 or 1/64."""
    import torch

    if pattern == "none":
        return None
    f = torch.zeros((m, s), dtype=torch.bool, device=gen.device)
    if pattern == "all":
        f[:] = True
    elif pattern == "boundary":
        f[:, ::-(-s // t)] = True
    elif pattern == "last":
        f[:, -1] = True
    else:
        den = int(pattern[len("random"):])
        f = torch.rand((m, s), generator=gen, device=gen.device) < 1 / den
    return f


def scan_err(xs, flags=None) -> int:
    """points_err of kernel I against its plain twin on (m, s) lanes.  The
    kernel adds in another order, so its triples may differ from the
    twin's; none may be the (0 : 0 : 0) that equals every point."""
    from quill_tpu_torch.ec import msm8
    from quill_tpu_torch.fields import device as fd

    got = msm8.seg_scan(xs, flags).reshape(-1, 3, fd.NLIMB)
    check(bool((got != 0).any(-1).any(-1).all()),
          "kernel I wrote a (0 : 0 : 0) triple")
    return points_err(got,
                      msm8.seg_scan_plain(xs, flags).reshape(-1, 3, fd.NLIMB))


def v8_kernels(kzg_big, records, card):
    """J on one CRS chunk of 2^16 tau powers; I on one v8 chunk's scans
    (2^16 uniform scalars: 20 windows x 256 lanes of 256 sorted entries,
    then the block totals, then the triangle's 20 x 32 lanes of 256
    buckets), and at the chunk and block-scan shapes on every adversarial
    flag pattern (SCAN_PATTERNS); E's flagged mode on that chunk's collect;
    then a v8 MSM of 2^22 uniform scalars against kernels C and D."""
    import torch

    from quill_tpu_torch.ec import curve, msm5, msm8
    from quill_tpu_torch.ec import device as ed
    from quill_tpu_torch.ec import fixed_base as fb
    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.pcs.kzg import _tau_from_seed

    bb = kzg_big._basis
    dev = bb.xy.device
    out = []

    # J: one launch of the CRS build
    chunk = fb.CHUNK
    powers = fd.from_mont(fd.powers(_tau_from_seed(0), chunk, fd.FR, dev),
                          fd.FR)
    table = fb.build_table(curve.g1_generator(), dev)
    err_j = points_err(fb.fixed_base(powers, table),
                       fb.fixed_base_plain(powers, table))
    check(err_j == 0, "kernel J disagrees with its plain twin")
    t_k = cuda_ms(lambda: fb.fixed_base(powers, table))
    t_p = cuda_ms(lambda: fb.fixed_base_plain(powers, table), reps=1)
    log(f"kernel J, {chunk} tau powers: {t_k:.3f} ms vs plain {t_p:.3f} ms")
    crs = bb.length
    out.append(dict(
        name="fixed_base", route="cuda",
        source="quill_tpu_torch/csrc/fixed_base.cu",
        replaces="quill_tpu/ec/fixed_base.py:89 (_k_fixed_base_chunk, XLA "
                 "in the TPU build)",
        shape=f"one CRS chunk: {chunk} tau powers x 64 table adds (the "
              f"CRS of {crs} points takes {-(-crs // chunk)} launches)",
        max_abs_err=err_j, ms=t_k, plain_ms=t_p,
        **bound(card, 12 * fb.FB_WINDOWS * chunk, chunk * (FE + PT)),
        library_ms=None,
        crs_bound_ms=bound(card, 12 * fb.FB_WINDOWS * crs,
                           crs * (FE + PT))["bound_ms"]))
    del powers

    # I and E on one chunk of a 2^22-point MSM
    nbig = crs - 1
    s_big = uniform_scalars(nbig, dev, 1234, [0, 1, R - 1, R - 2] + [
        8191 << (13 * w) for w in range(19)])
    canon = fd.from_mont(s_big[:msm8.CHUNK], fd.FR)
    sorted_d, xs, flags = msm8.chunk_entries(
        canon, bb.xy[:msm8.CHUNK], bb.inf[:msm8.CHUNK])
    m, steps = xs.shape[:2]
    err_i = scan_err(xs, flags)
    times = dict(
        ms=cuda_ms(lambda: msm8.seg_scan(xs, flags)),
        plain_ms=cuda_ms(lambda: msm8.seg_scan_plain(xs, flags), reps=1))
    ys, wf, offs = msm8.chunk_scan(xs, flags)
    nb = m // msm8.NWIN
    tot = ys[:, -1].reshape(msm8.NWIN, nb, 3, fd.NLIMB).contiguous()
    tot_f = wf[:, -1].reshape(msm8.NWIN, nb).contiguous()
    err_i = max(err_i, scan_err(tot, tot_f))
    threads = dict(chunk=msm8.scan_threads(m, steps),
                   block_scan=msm8.scan_threads(*tot.shape[:2]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    for lanes, name in ((xs, "chunk"), (tot, "block_scan")):
        for pattern in SCAN_PATTERNS:
            err = scan_err(lanes, scan_flags(pattern, *lanes.shape[:2],
                                             threads[name], gen))
            check(err == 0, f"kernel I disagrees with its plain twin at the "
                  f"{name} shape, flags {pattern}")
    times["block_scan_ms"] = cuda_ms(lambda: msm8.seg_scan(tot, tot_f))
    times["block_scan_plain_ms"] = cuda_ms(
        lambda: msm8.seg_scan_plain(tot, tot_f), reps=1)
    sel, a, b, f = msm8.collect_terms(sorted_d, ys, wf, offs)
    err_e = points_err(msm5.pt_add(a, b, f), msm5.pt_add_plain(a, b, f))
    check(err_e == 0, "kernel E (flagged, v8 collect) disagrees with its "
          "plain twin")
    e_rec = next(r for r in records if r["name"] == "msm5_pt_add")
    e_rec.update(
        v8_collect_shape=f"{sel.shape[0]} flagged combines (one v8 chunk's "
                         f"collect, 2^16 uniform scalars)",
        v8_collect_ms=cuda_ms(lambda: msm5.pt_add(a, b, f)),
        v8_collect_plain_ms=cuda_ms(lambda: msm5.pt_add_plain(a, b, f),
                                    reps=1))
    acc = msm8.collect(sorted_d, ys, wf, offs,
                       ed.identity(msm8.NWIN * msm8.NBUCK, dev))
    rev = acc.reshape(msm8.NWIN, msm8.NBUCK, 3, fd.NLIMB).flip(1).reshape(
        -1, msm8.BS, 3, fd.NLIMB).contiguous()
    err_i = max(err_i, scan_err(rev))
    check(err_i == 0, "kernel I disagrees with its plain twin")
    threads["triangle"] = msm8.scan_threads(*rev.shape[:2])
    times["triangle_scan_ms"] = cuda_ms(lambda: msm8.seg_scan(rev))
    times["triangle_scan_plain_ms"] = cuda_ms(
        lambda: msm8.seg_scan_plain(rev), reps=1)
    log(f"kernel I, {m} lanes x {steps} steps: {times['ms']:.3f} ms vs "
        f"plain {times['plain_ms']:.3f} ms; block scan {tot.shape[0]} x "
        f"{nb}: {times['block_scan_ms']:.3f} ms; triangle scan "
        f"{rev.shape[0]} x {msm8.BS}: {times['triangle_scan_ms']:.3f} ms; "
        f"kernel E flagged at the collect's {sel.shape[0]} entries: "
        f"{e_rec['v8_collect_ms']:.3f} ms")
    log(f"kernel I threads a lane: {json.dumps(threads)}; equal points on "
        f"flags {', '.join(SCAN_PATTERNS)} at the chunk and block-scan "
        f"shapes")
    tri_lanes = rev.shape[0]
    del xs, flags, ys, wf, offs, acc, rev, a, b, f

    torch.cuda.synchronize()
    t0 = time.time()
    got = msm8.msm(bb, s_big)
    torch.cuda.synchronize()
    v8_s = time.time() - t0
    t0 = time.time()
    want = M.msm(bb, s_big)
    torch.cuda.synchronize()
    cd_s = time.time() - t0
    check(got == want, "the v8 MSM of 2^22 points disagrees with kernels "
          "C and D")
    log(f"MSM of {nbig} points, uniform scalars: v8 route {v8_s:.3f} s, "
        f"kernels C + D {cd_s:.3f} s; equal")
    out.append(dict(
        name="msm8_seg_scan", route="cuda",
        source="quill_tpu_torch/csrc/msm8.cu",
        replaces="quill_tpu/fields/pallas8.py:379 (_seg_scan_kernel)",
        shape=f"one v8 chunk's scan: {m} lanes x {steps} steps (20 windows "
              f"x {nb} blocks of 256 sorted entries, 2^16 uniform scalars)",
        max_abs_err=err_i,
        **bound(card, 12 * m * steps, m * steps * (2 * PT + 1)),
        library_ms=None, **times,
        block_scan_shape=f"{tot.shape[0]} lanes x {nb} steps, flagged",
        block_scan_bound_ms=bound(card, 12 * msm8.NWIN * nb,
                                  msm8.NWIN * nb * (2 * PT + 1))["bound_ms"],
        triangle_scan_shape=f"{tri_lanes} lanes x {msm8.BS} steps",
        triangle_scan_bound_ms=bound(card, 12 * tri_lanes * msm8.BS,
                                     tri_lanes * msm8.BS * 2 * PT)["bound_ms"],
        threads_per_lane=threads,
        v8_msm_s=v8_s, cd_msm_s=cd_s,
        msm_shape=f"{nbig} points, uniform scalars below 2^252"))
    return out


def profile_prove(hp, witness):
    """A second prove under torch.profiler: device busy share (summed
    kernel time over wall time) and the kernels that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quill_tpu_torch.proof.hyperplonk import TraceWitness

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        hp.prove([TraceWitness(columns=witness)])
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"profile: wall {wall:.3f}s, device busy {busy_us / 1e6:.3f}s "
        f"({100 * busy_us / 1e6 / wall:.1f}%)")
    rows.sort(key=lambda e: -e.self_device_time_total)
    ours = ("sumcheck_", "ntt_stage", "bucket_", "pt_add", "tree_",
            "seg_scan", "level0_", "mont_mul_")
    for i, e in enumerate(rows):
        if i < 12 or e.key.startswith(ours):
            log(f"  {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.1f} "
                f"ms x{e.count}")


def fibonacci(rows: int):
    """The circuit and witness of scripts/prove_tpu.py:43-64."""
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.frontend.transition_circuit import TransitionCircuit
    from quill_tpu_torch.piops.virtual_poly import Const

    circuit = TransitionCircuit.new(rows)
    s1 = circuit.allocate_state_cell()
    s2 = circuit.allocate_state_cell()
    circuit.enforce_boundary_constraint(0, s1.current.to_expr())
    circuit.enforce_boundary_constraint(0, s2.current.to_expr() - Const(1))
    circuit.enforce_constraint(
        s2.next.to_expr() - (s1.current.to_expr() + s2.current.to_expr()))
    circuit.enforce_constraint(s1.next.to_expr() - s2.current.to_expr())
    witness = [[0] * rows for _ in range(circuit.num_cols())]
    a, b = 0, 1
    for row in range(rows):
        witness[s1.current.col][row] = a
        witness[s2.current.col][row] = b
        witness[s1.next.col][row] = b
        witness[s2.next.col][row] = (a + b) % R
        a, b = b, (a + b) % R
    return circuit, witness


def crs_phase(engine, host_kzg, rng):
    """The device CRS of the 2^20-row path (2^22 + 1 points, `setup`),
    held against the host CRS: its
    first 2^18 + 1 points, and CRS_SAMPLES later ones against native
    scalar products.  -> (kzg, seconds, launches)."""
    import torch

    from quill_tpu_torch.ec import curve, native_ec
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.pcs.kzg import _tau_from_seed
    from quill_tpu_torch.pcs.setup import setup

    count = COLS << BIG_LOG2_ROWS
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.time()
    kzg = setup(engine, count)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(build.LAUNCHES)
    xy = kzg._basis.xy
    n = host_kzg._basis.length
    check(torch.equal(xy[:n], host_kzg._basis.xy),
          f"the device CRS differs from the host CRS on its first {n} points")
    idx = sorted(rng.sample(range(n, count + 1), CRS_SAMPLES))
    tau = _tau_from_seed(0)
    want = native_ec.batch_to_affine(native_ec.scalar_mul_many(
        curve.g1_generator().to_affine(), [pow(tau, i, R) for i in idx]))
    got = fd.to_ints(xy[torch.tensor(idx, device=xy.device)].reshape(
        -1, fd.NLIMB), fd.FQ)
    check(got == [c for p in want for c in (p.x.v, p.y.v)],
          "the device CRS differs from native EC at sampled indices")
    log(f"CRS: {count + 1} points on the device in {secs:.1f}s (kernel J "
        f"x{launches['fixed_base']}); the first {n} equal the host CRS, "
        f"{CRS_SAMPLES} sampled later ones equal native EC")
    return kzg, secs, launches


def prove_path(engine, circuit, witness, make_kzg, tag: str):
    """One main path with the launch counts and MSM routes of its run
    alone: make_kzg() -> preprocess -> prove -> serialize -> verify."""
    import torch

    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
    from quill_tpu_torch.proof import hyperplonk
    from quill_tpu_torch.proof.hyperplonk import HyperPlonk, TraceWitness
    from quill_tpu_torch.utils.profiling import metrics
    from quill_tpu_torch.utils.proof_io import serialize_proof

    phases = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    engine.msm_counts = dict.fromkeys(engine.msm_counts, 0)
    metrics.reset()
    t0 = time.time()
    pcs = MultilinearPCS(make_kzg())
    torch.cuda.synchronize()
    phases["setup_s"] = time.time() - t0
    t0 = time.time()
    hp = HyperPlonk.preprocess([circuit], pcs)
    torch.cuda.synchronize()
    phases["preprocess_s"] = time.time() - t0
    t0 = time.time()
    proof = hp.prove([TraceWitness(columns=witness)])
    torch.cuda.synchronize()
    phases["prove_s"] = time.time() - t0
    phases["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(build.LAUNCHES)
    routes = dict(engine.msm_counts)
    data = serialize_proof(proof)
    t0 = time.time()
    hyperplonk.verify(proof, hp.to_vk(), pcs, batch_pairings=True)  # raises
    phases["verify_s"] = time.time() - t0
    digest = hashlib.sha256(data).hexdigest()
    log(f"{tag} proof: {len(data)} bytes, sha256 {digest}")
    log(f"{tag} phases: " + json.dumps(phases))
    log(f"{tag} launches: " + json.dumps(launches))
    log(f"{tag} MSMs by route (preprocess + prove): " + json.dumps(routes))
    top = sorted(metrics.report().items(), key=lambda kv: -kv[1]["total_sec"])
    log(f"{tag} host spans (utils/profiling): " + json.dumps(dict(top[:14])))
    return dict(data=data, digest=digest, launches=launches, routes=routes,
                hp=hp, pcs=pcs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cross-check", action="store_true")
    args = ap.parse_args()

    card = device_phase()
    sys.path.insert(0, ROOT)
    # every CRS is made in this run: one read from the disk cache would
    # launch no kernel J
    os.environ["QUILL_CRS_CACHE"] = "0"
    import random

    import torch

    from quill_tpu_torch.engine.device import TorchEngine
    from quill_tpu_torch.pcs.kzg import cached_trusted_setup
    from quill_tpu_torch.pcs.setup import setup

    t_start = time.time()
    build_phase()
    engine = TorchEngine("cuda")
    rng = random.Random(1234)
    t0 = time.time()
    host_kzg = cached_trusted_setup(engine, HOST_CRS_DEGREE)
    log(f"host CRS: {host_kzg.max_degree + 1} points by native EC, "
        f"{time.time() - t0:.1f}s")
    kzg_big, crs_s, crs_launches = crs_phase(engine, host_kzg, rng)

    t0 = time.time()
    records = kernel_phase(engine, host_kzg, kzg_big, rng, card)
    log(f"kernel phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    field_launches = field_bench(card, records)
    log(f"field bench phase: {time.time() - t0:.1f}s")

    rows = 1 << LOG2_ROWS
    circuit, witness = fibonacci(rows)
    small = prove_path(engine, circuit, witness,
                       lambda: setup(engine, COLS * rows),
                       f"2^{LOG2_ROWS}-row")
    check(len(small["data"]) == PINNED_LEN
          and small["digest"] == PINNED_SHA256,
          "the 2^16-row proof differs from the pinned proof")
    check(small["routes"]["v8"] == 0, "an MSM of the 2^16-row prove took v8")
    if args.profile:
        profile_prove(small["hp"], witness)
    small_launches = small["launches"]
    del small

    t0 = time.time()
    engine6 = TorchEngine("cuda", msm_impl="6")
    v6 = prove_path(engine6, circuit, witness,
                    lambda: setup(engine6, COLS * rows),
                    f"2^{LOG2_ROWS}-row, msm_impl 6")
    check(len(v6["data"]) == PINNED_LEN and v6["digest"] == PINNED_SHA256,
          "the 2^16-row proof on the v6 route differs from the pinned proof")
    check(v6["routes"]["v6"] > 0 and v6["routes"]["v8"] == 0
          and "cd" not in v6["routes"],
          "the msm_impl 6 prove took no v6 MSM, or took C + D or v8")
    v6_launches = v6["launches"]
    del v6, engine6
    log(f"2^{LOG2_ROWS}-row path on v6: {time.time() - t0:.1f}s")

    t0 = time.time()
    circuit, witness = fibonacci(1 << BIG_LOG2_ROWS)
    log(f"2^{BIG_LOG2_ROWS}-row witness: {time.time() - t0:.1f}s")
    big = prove_path(engine, circuit, witness, lambda: kzg_big,
                     f"2^{BIG_LOG2_ROWS}-row")
    check(big["routes"]["v8"] > 0, "no MSM of the 2^20-row prove took v8")
    if args.cross_check:
        shift_max = engine.msm_shift_max
        engine.msm_shift_max = 1 << 40
        other = prove_path(engine, circuit, witness, lambda: kzg_big,
                           f"2^{BIG_LOG2_ROWS}-row, no v8")
        engine.msm_shift_max = shift_max
        check(other["routes"]["v8"] == 0, "the cross-check prove took v8")
        check(other["data"] == big["data"],
              "the 2^20-row proof differs with every MSM off the v8 route")
        log("cross-check: the 2^20-row proof is the same with every MSM "
            "off the v8 route")
        del other
    check(len(big["data"]) == BIG_PINNED_LEN
          and big["digest"] == BIG_PINNED_SHA256,
          "the 2^20-row proof differs from the pinned proof")

    launches = {k: crs_launches[k] + field_launches[k] + small_launches[k]
                + v6_launches[k] + v for k, v in big["launches"].items()}
    log("launches (CRS, field bench and the three paths): "
        + json.dumps(launches))
    zero = [k for k, v in launches.items() if v == 0]
    check(not zero, f"kernels never launched on the main path: {zero}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    log(f"total: {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
