"""Prove and verify HyperPlonk proofs with quill_tpu_torch on one NVIDIA GPU:
the 2^16-row Fibonacci proof (every MSM on the small route or kernels C +
D), the same proof with the v6 MSM route (`msm_impl="6"`) and the 2^20-row
one (its largest MSMs on the v8 route), after checking the device CRS
against the host CRS, every hand-written kernel against its plain PyTorch
twin on the card, and running the field bench.

Usage (from the root of a checkout):
    python3 chip_smoke.py [--cross-check]
--cross-check proves the 2^20 rows a second time with every MSM off the
v8 route (`msm_shift_max` above the CRS: kernels C + D) and requires the
same bytes; the 2^20 pin below was fixed from such a run.

Phases, any failure exits non-zero:
1. device: a CUDA card is required; prints its name and power limit;
2. build: kernels A to M from quill_tpu_torch/csrc with nvcc (one process
   per source, all at once) and the host C libraries of native/ (G1
   arithmetic, BLAKE3) with gcc;
3. CRS: the host CRS of 2^18 + 1 points (native host EC, the reference),
   then the device CRS of 2^22 + 1 points (`setup`: kernel J's table and
   the CRS, affine, in two launches); its first 2^18 + 1 points must equal
   the host CRS and a random sample of later ones the native scalar
   products tau^i G; the tau powers and the table are timed apart;
4. kernels: each kernel against its plain twin on the card, exactly, at
   the shapes the proves give it, with the times of the kernel wrappers
   and of the plain twins and the least time the card could take for the
   same work (kernel A also at a fold + round over 5 tables of 2^22;
   every launch of kernel B's 2^18 x 2^18 product -- forward, product and
   inverse passes, the twiddle table, the S fold -- and its 2^22 x 2^22
   product timed; kernel M at an open_many batch of each prove, 4 openings
   of ~2^22 and 8 of ~2^18 coefficients; kernel E's shifted basis of one
   2^16-point chunk at 20 windows of 13 bits and at 16 of 16, of two
   chunks in one launch at (20, 13) and of 2^18 points at (16, 16), and
   its doubling at v8's triangle; kernel E's add by threads at 2^16 and
   by lanes at v8's triangle's 20 points; the leaf-level kernel (F on the
   small route, K on v6) through the sort's index at one small-route
   batch's 2,621,440 leaf pairs and at a 2^18-point v6 MSM's 2^21 (exact
   triples; the small route's sort must give an index, not leaves);
   kernels G and H one and two
   levels a launch on one small-route batch's 2,621,440 leaf pairs, the
   fused top at the batch's top level and its reduce mode on the
   collect's and v6's reductions, each with `torch.equal`, and the whole
   prefix tree against the chain of one-level launches, both timed;
   v8's entries kernels on one v8 chunk (the sorted digits, scan input
   and flags of 2^16 Montgomery scalars, `torch.equal`);
   kernel E's v8 collect mode on one v8 chunk; kernel E's walk mode, v6's
   bucket queries, against the chain of flagged launches, and the fused
   top as v6's prefix, at a 2^18-point v6 MSM's shapes; kernel J's table, one
   2^16-point chunk and the 2^18 + 1-point CRS against its twin); the
   2^18-point MSMs also against the native host MSM;
   the small-route MSM of 4 x 2^16 points (its launches logged), v6 MSMs
   of 2^18 and 2^20 points and a v8 MSM of 2^22 points against kernels C
   and D on the same scalars;
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
Each path prints its phases, its kernel launches (also split into setup,
preprocess and prove), its MSMs by route and
its host spans (`kzg/quotient` and `kzg/open_msm` on a line of their own);
every kernel must have launched in the CRS build, the field bench or one
of the paths, kernel M on the 2^16- and the 2^20-row paths, and the v8
collect on the 2^20-row path, with one entries call a chunk (as many as
collects; the prove's are logged).  The 2^16-row path's shifted basis is
kernel E's one launch a call (no E add on that path), the v6 path one
query walk and one leaf-level launch (K) a v6 MSM and no E add, and v8's
triangle one doubling launch
and 3 adds a MSM.  The line before the last is the
per-kernel JSON record, the last line the device record.
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
TRIANGLE_POINTS = 20       # v8's triangle: its window points
# kernel M: an open_many batch of each prove (its quotients' inputs: two
# tables of 2^k and two of 2^k - 1 coefficients, twice at 2^16 rows), and
# the coefficients a thread it is also timed at
QUOT_BATCHES = {
    f"2^{BIG_LOG2_ROWS}-row": [1 << 22] * 2 + [(1 << 22) - 1] * 2,
    f"2^{LOG2_ROWS}-row": ([1 << 18] * 2 + [(1 << 18) - 1] * 2) * 2,
}
QUOT_RUNS = (8, 16, 32, 64, 128)


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


def tensor_err(a, b, field=None) -> int:
    """0 for equal (n, 8) Montgomery tensors, else the largest difference
    of their canonical values (Fr unless `field` says)."""
    import torch

    from quill_tpu_torch.fields import device as fd

    if torch.equal(a, b):
        return 0
    field = field or fd.FR
    return max_abs_err(fd.to_ints(a, field), fd.to_ints(b, field))


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
    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.ec import msm5
    from quill_tpu_torch.engine import sumcheck as sc
    from quill_tpu_torch.engine.expr import OP_MUL, compile_expr
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.piops.virtual_poly import Const, Input

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
    # 2^16, a fused fold + round over 5 tables of 2^18, and the fold +
    # round of the 2^20-row prove's largest tables, 5 of 2^22
    x = [Input(i) for i in range(7)]
    fold_expr = (x[0] * x[1] - x[2]) * x[3] + x[4] * Const(5)
    cases = [
        ("round 0, 7 tables of 2^16", rows, None,
         (x[0] * x[1] - x[2]) * x[3] + (x[4] - x[5]) * x[6] + Const(R - 3)),
        ("fold + round, 5 tables of 2^18", big, rng.randrange(R), fold_expr),
        (f"fold + round, 5 tables of 2^{BIG_LOG2_ROWS + 2}",
         1 << (BIG_LOG2_ROWS + 2), rng.randrange(R), fold_expr),
    ]
    err, times = 0, []
    for i, (what, n, r, expr) in enumerate(cases):
        tables = [uniform_scalars(n, dev, 300 + 10 * i + j)
                  for j in expr.used_inputs()]
        got, gf = sc.round_messages(tables, expr, 3, r)
        want, wf = sc.round_messages(tables, expr, 3, r, plain=True)
        err = max(err, max_abs_err(got, want))
        for a, b in zip(gf or [], wf or []):
            err = max(err, tensor_err(a, b))
        del want, wf
        times.append((
            what, cuda_ms(lambda: sc.round_messages(tables, expr, 3, r)),
            cuda_ms(lambda: sc.round_messages(tables, expr, 3, r,
                                              plain=True), reps=1)))
        log(f"kernel A, {what}: {times[-1][1]:.3f} ms vs plain "
            f"{times[-1][2]:.3f} ms")
        del tables, gf
    check(err == 0, "kernel A disagrees with its plain twin")

    def a_work(n):
        # per pair of folded outputs: 2 fold products per table, then the
        # program at t = 0..3; reads 4 rows and writes 2 per table
        k = len(fold_expr.used_inputs())
        muls = sum(1 for op in compile_expr(fold_expr).ops if op == OP_MUL)
        return (n // 4) * (2 * k + 4 * muls), k * (n + n // 2) * FE

    record("sumcheck_round", "quill_tpu_torch/csrc/sumcheck_round.cu",
           "quill_tpu/engine/sumcheck8.py:292 (_round8_kernel); "
           "quill_tpu/engine/sumcheck8.py:174 (_entry_kernel)",
           *a_work(big), shape=times[1][0], max_abs_err=err, ms=times[1][1],
           plain_ms=times[1][2], round0_ms=times[0][1],
           round0_plain_ms=times[0][2], big_shape=times[2][0],
           big_ms=times[2][1], big_plain_ms=times[2][2],
           big_bound_ms=bound(card, *a_work(cases[2][1]))["bound_ms"])

    records.extend(ntt_kernels(engine, card, big, rand_fr))
    # C and D: MSMs of 2^18 points on the tau CRS, with uniform scalars
    # (witness and quotient commitments) and with the identity column's
    # scalars 0..2^18-1, whose window-1 buckets hold 2^16 points each and
    # so span thousands of kernel C threads and its fix-up levels
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
        before = build.LAUNCHES["msm_bucket_sum"]
        sums_k = M.bucket_sums(xy, keys, entries)
        check(build.LAUNCHES["msm_bucket_sum"] - before == 1,
              f"kernel C ({what}) took more than one call of its wrapper")
        _, counts = keys.unique_consecutive(return_counts=True)
        if what == "id column":
            check(int(counts.max())
                  > 4 * M.entries_a_thread(keys.numel()),
                  "the id column's buckets never spanned kernel C threads")
        sums_p = M.bucket_sums(xy, keys, entries, plain=True)
        err_c = max(err_c, points_err(sums_k, sums_p))
        # this data's least work: an occupied bucket of L >= 2 entries
        # takes one affine add (9 products) and L - 2 mixed adds (11); each
        # basis point, key and entry is read once, each bucket written once
        multi = counts[counts >= 2].to(torch.int64)
        c_work[what] = (int(9 * multi.numel() + 11 * (multi - 2).sum()),
                        big * AFF + keys.numel() * 8
                        + M.NWIN * M.NBUCK * PT)
        c_times[what] = (
            f"{keys.numel()} entries in {counts.numel()} buckets (largest "
            f"{int(counts.max())}), "
            f"{M.entries_a_thread(keys.numel())} entries a thread",
            cuda_ms(lambda: M.bucket_sums(xy, keys, entries)),
            cuda_ms(lambda: M.bucket_sums(xy, keys, entries, plain=True),
                    reps=1))
        log(f"kernel C, {what} ({c_times[what][0]}): {c_times[what][1]:.3f} "
            f"ms vs plain {c_times[what][2]:.3f} ms")
        dense = sums_k
        err_d = max(err_d, points_err(M.bucket_reduce(dense),
                                      M.bucket_reduce_plain(dense)))
        d_times[what] = (
            cuda_ms(lambda: M.bucket_reduce(dense)),
            cuda_ms(lambda: M.bucket_reduce_plain(dense), reps=1))
        log(f"kernel D, {what}: {d_times[what][0]:.3f} ms vs plain "
            f"{d_times[what][1]:.3f} ms")
        log(f"MSM 2^18 points, {what} (digits, sort, kernels C+D, host "
            f"combine): {cuda_ms(lambda: M.msm(bs, s)):.3f} ms")
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
    # D: the running sum's 2 adds a bucket, whatever the kernel's segments;
    # every bucket read once, the window sums written
    record("msm_bucket_reduce", "quill_tpu_torch/csrc/msm.cu",
           "quill_tpu/ec/msm7.py:146-160 (v7 Fenwick query phase, XLA "
           "in the TPU build)",
           12 * M.NWIN * 2 * M.NBUCK,
           (M.NWIN * M.NBUCK + M.NWIN) * PT,
           shape=f"16 windows x 2^15 buckets (uniform scalars), {M.SEG} "
                 f"buckets a thread",
           max_abs_err=err_d, ms=d_times["uniform"][0],
           plain_ms=d_times["uniform"][1], id_column_ms=d_times["id column"][0],
           id_column_plain_ms=d_times["id column"][1])

    # E to H: the small route, at the shapes of one batch of 4 one-chunk
    # MSMs.  The basis is a fresh one over the CRS points, with a shifted-
    # basis cache of its own, so the prove's cache stays cold and builds
    # its shifted basis, through kernel E, on the main path.
    own = M.TorchBasis(xy=kzg._basis.xy, inf=kzg._basis.inf,
                       length=kzg._basis.length)
    n = msm5.CHUNK
    xy0, inf0 = own.xy[:n], own.inf[:n]
    pts0 = msm5.base_points(xy0, inf0)
    # kernel E's add: by threads at the field bench's 2^16 adds, by lanes
    # at v8's triangle (20 window points)
    other = msm5.pt_dbl(pts0)
    flags = torch.tensor([rng.random() < 0.5 for _ in range(n)],
                         dtype=torch.bool, device=dev)
    tri = TRIANGLE_POINTS
    a20, b20 = other[:tri].contiguous(), pts0[:tri].contiguous()
    for x, y, lanes, what in ((pts0, other, False, "2^16 adds by threads"),
                              (pts0, other, True, "2^16 adds by lanes"),
                              (a20, b20, True, f"{tri} adds by lanes"),
                              (a20, b20, False, f"{tri} adds by threads")):
        for f in (None, flags[:x.shape[0]]):
            check(torch.equal(msm5.pt_add(x, y, f, lanes=lanes),
                              msm5.pt_add_plain(x, y, f)),
                  f"kernel E ({what}) disagrees with its plain twin")
    e_times = dict(
        ms=cuda_ms(lambda: msm5.pt_add(pts0, other, lanes=False), reps=10),
        plain_ms=cuda_ms(lambda: msm5.pt_add_plain(pts0, other), reps=1),
        flagged_ms=cuda_ms(lambda: msm5.pt_add(pts0, other, flags,
                                               lanes=False), reps=10),
        flagged_plain_ms=cuda_ms(
            lambda: msm5.pt_add_plain(pts0, other, flags), reps=1),
        lanes_2_16_ms=cuda_ms(lambda: msm5.pt_add(pts0, other, lanes=True),
                              reps=10),
        lanes_shape=f"{tri} adds by lanes (v8's triangle)",
        lanes_ms=cuda_ms(lambda: msm5.pt_add(a20, b20, lanes=True), reps=10),
        lanes_plain_ms=cuda_ms(lambda: msm5.pt_add_plain(a20, b20), reps=1),
        lanes_bound_ms=bound(card, 12 * tri, 3 * tri * PT)["bound_ms"],
        threads_20_ms=cuda_ms(lambda: msm5.pt_add(a20, b20, lanes=False),
                              reps=10),
        lane_max=msm5.ADD_LANE_MAX)
    log(f"kernel E, 2^16 adds by threads: {e_times['ms']:.4f} ms vs plain "
        f"{e_times['plain_ms']:.3f} ms; flagged {e_times['flagged_ms']:.4f} "
        f"ms vs plain {e_times['flagged_plain_ms']:.3f} ms; by lanes "
        f"{e_times['lanes_2_16_ms']:.4f} ms; {tri} adds by lanes "
        f"{e_times['lanes_ms']:.4f} ms, by threads "
        f"{e_times['threads_20_ms']:.4f} ms; equal triples")
    record("msm5_pt_add", "quill_tpu_torch/csrc/msm5.cu + "
           "quill_tpu_torch/csrc/tree.cuh",
           "quill_tpu/fields/pallas8.py:475 (_stacked_combine_kernel); "
           ":188 (_pt_add_kernel), :245 (_pt_add_b16_kernel), :283 "
           "(_seg_combine_kernel)",
           12 * n, 3 * n * PT, shape="2^16 elementwise adds by threads",
           max_abs_err=0, **e_times)
    rec, sh = shifted_basis_kernel(own, card)
    records.append(rec)
    vecs = [[rng.randrange(R) for _ in range(n)] for _ in range(4)]
    vecs[0][:4] = [0, 1, R - 1, (1 << 13) - 1]
    s_list = [fd.from_ints(v, fd.FR, dev) for v in vecs]
    scs = torch.stack([fd.from_mont(t, fd.FR) for t in s_list])
    # the sort gives the leaves' rows of the shifted basis, no leaf tensor:
    # kernel F gathers the rows itself
    out = msm5.sort_leaves(scs, inf0)
    check(len(out) == 2, "the small route's sort gives more than its keys "
          "and index")
    keys, idx = out
    check(idx.dtype == torch.int32 and idx.shape == (4 * msm5.NWIN * n,),
          "the small route's index is not 4 x 20 x n int32 rows")
    x1 = msm5.tree_up0(sh, idx)
    check(torch.equal(x1, msm5.tree_up0_plain(sh, idx)),
          "kernel F disagrees with its plain twin")
    tree_recs, tree_times = tree_kernels(sh, idx, x1, card)
    records.append(leaf_record(
        "msm5_tree_up0", "quill_tpu/ec/msm5.py:245 (_up0_kernel)", sh, idx,
        msm5.tree_up0, msm5.tree_up0_plain,
        f"{x1.shape[0]} affine leaf pairs gathered through the sort's index "
        f"(4 MSMs x 20 windows x {n} points)", card))
    records.extend(tree_recs)
    del x1, keys, idx

    # the whole small-route MSM against kernels C and D, same 4 vectors
    bs_own = M.slice_basis(own, n)
    bs_cd = M.slice_basis(kzg._basis, n)
    before = dict(build.LAUNCHES)
    got = msm5.msm_batch(bs_own, s_list)
    per_call = {k: v - before[k] for k, v in build.LAUNCHES.items()
                if v != before[k]}
    want = [M.msm(bs_cd, t) for t in s_list]
    check(all(g == w for g, w in zip(got, want)),
          "the small-route MSM disagrees with kernels C and D")
    small_ms = cuda_ms(lambda: msm5.msm_batch(bs_own, s_list))
    cd_ms = cuda_ms(lambda: [M.msm(bs_cd, t) for t in s_list])
    log(f"4 MSMs of {n} points: small route (one batch) {small_ms:.3f} ms, "
        f"kernels C + D (one at a time) {cd_ms:.3f} ms; equal")
    log("launches of one small-route call (the first on its basis, so "
        "with its shifted basis): " + json.dumps(per_call))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    msm5.msm_batch(bs_own, s_list)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"one small-route call's peak above what it was given: "
        f"{peak_mb:.1f} MB (the {4 * msm5.NWIN * n * AFF / 2**20:.0f} MB "
        f"leaf tensor of a gather is not made)")
    # E, its shifted basis, F, G, H, the top, its reduce mode
    for rec in records[-7:]:
        rec["small_route_batch_ms"] = small_ms
        rec["cd_same_4_msms_ms"] = cd_ms
    records[-5]["small_route_call_peak_mb"] = peak_mb
    records[-2]["launches_per_small_route_call"] = per_call
    records[-2].update(tree_times)
    records += v6_kernels(kzg, kzg_big, card)
    records.append(field_kernel(dev, rng, card))
    records.append(quotient_kernel(dev, rng, card))
    records += v8_kernels(kzg_big, card)
    records.append(fixed_base_kernel(kzg_big, card))
    return records


def top_adds(w: int) -> int:
    """Adds of the fused top over a level of w points: each level's pairs up
    (an odd level padded) and the same pairs' prefixes down."""
    adds, s = 0, w
    while s > 1:
        s = (s + 1) // 2
        adds += s
    return 2 * adds


def leaf_record(name, replaces, sh, idx, fn, plain, shape, card):
    """Kernel F or K, the one leaf-level kernel, through its caller's
    wrapper `fn` against the plain twin (`torch.equal`), both timed, and
    on the same leaves gathered first (no index).  The bound: 9 products a
    pair against the basis rows the index reads, read once, the index and
    the pair sums."""
    import torch

    from quill_tpu_torch.ec import msm5

    got = fn(sh, idx)
    check(torch.equal(got, plain(sh, idx)),
          f"{name} disagrees with its plain twin")
    leaves = sh[idx.long()].contiguous()
    check(torch.equal(msm5.tree_up0(leaves), got),
          f"{name} disagrees with itself on the gathered leaves")
    k = idx.shape[0] // 2
    rows = torch.unique(idx).numel()
    rec = dict(name=name, route="cuda",
               source="quill_tpu_torch/csrc/msm5.cu + "
                      "quill_tpu_torch/csrc/tree.cuh",
               replaces=replaces, shape=shape, max_abs_err=0,
               ms=cuda_ms(lambda: fn(sh, idx)),
               plain_ms=cuda_ms(lambda: plain(sh, idx), reps=1),
               **bound(card, 9 * k, rows * AFF + 2 * k * 4 + k * PT),
               library_ms=None, basis_rows_read=rows,
               contiguous_ms=cuda_ms(lambda: msm5.tree_up0(leaves)))
    log(f"kernel {name}, {k} pairs: {rec['ms']:.3f} ms through the index, "
        f"{rec['contiguous_ms']:.3f} ms on the gathered leaves, vs plain "
        f"{rec['plain_ms']:.3f} ms (bound {rec['bound_ms']:.3f} ms); equal "
        f"triples")
    return rec


def tree_kernels(sh, idx, x1, card):
    """Kernels G and H and the fused top against their plain twins with
    `torch.equal`, at the small route's shapes: one- and two-level G on the
    leaf pairs x1 (one batch of 4 x 20 x 2^16 leaves, the shifted basis sh
    read through the sort's rows idx), one- and two-level H
    back to them, both two-level launches by lanes at the path's widest
    level of at most `msm5.LANE_LEVEL` points, the top (tree mode) at the
    path's top level, its reduce mode on the collect's 4 runs of 2^14 terms
    and on v6's 2^16 query sums;
    then the whole `prefix_tree` against the chain of one-level launches
    (`msm5.prefix_tree_chain`), both timed, and the collect's reduction
    against its one-level halving.  -> (records of G, H, the top and the
    reduce mode; the tree's timings)."""
    import torch

    from quill_tpu_torch.ec import msm5

    out = []

    def held(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} disagrees with its plain twin")
        return 0

    def rec(name, replaces, adds, nbytes, shape, fn, plain, **kw):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain, reps=1)
        log(f"kernel {name}: {shape}: {ms:.3f} ms vs plain {plain_ms:.3f} "
            f"ms")
        out.append(dict(name=name, route="cuda",
                        source="quill_tpu_torch/csrc/msm5.cu + "
                               "quill_tpu_torch/csrc/tree.cuh",
                        replaces=replaces, shape=shape, max_abs_err=0,
                        ms=ms, plain_ms=plain_ms,
                        **bound(card, 12 * adds, nbytes), library_ms=None,
                        **kw))

    k1 = x1.shape[0]
    x2, x3 = msm5.tree_up2(x1)
    held("two-level G", (x2, x3), msm5.tree_up2_plain(x1))
    # the widest level of the path whose two-level launches go by lanes
    y1 = x3
    while y1.shape[0] > msm5.LANE_LEVEL:
        y1 = msm5.tree_up2(y1)[1]
    y2, y3 = msm5.tree_up2(y1)
    held("two-level G by lanes", (y2, y3), msm5.tree_up2_plain(y1))
    held("two-level H by lanes", msm5.tree_down2(y3, y2, y1),
         msm5.tree_down2_plain(y3, y2, y1))
    m1, m2, m3 = y1.shape[0], y2.shape[0], y3.shape[0]
    lanes_g = cuda_ms(lambda: msm5.tree_up2(y1))
    lanes_h = cuda_ms(lambda: msm5.tree_down2(y3, y2, y1))
    log(f"kernels G and H by lanes, two levels over {m1} points: "
        f"{lanes_g:.3f} ms and {lanes_h:.3f} ms")
    held("one-level G", msm5.tree_up(x1), msm5.tree_up_plain(x1))
    k2, k3 = x2.shape[0], x3.shape[0]
    one_g = cuda_ms(lambda: msm5.tree_up(x1))
    log(f"kernel G one level, {k2} adds: {one_g:.3f} ms")
    rec("msm5_tree_up", "quill_tpu/ec/msm3.py:258 (_up_kernel)", k2 + k3,
        (k1 + k2 + k3) * PT, f"two levels on the leaf pairs: {k1} -> {k2} "
        f"-> {k3} points, {k2 + k3} adds",
        lambda: msm5.tree_up2(x1), lambda: msm5.tree_up2_plain(x1),
        one_level_shape=f"{k2} adds", one_level_ms=one_g,
        one_level_bound_ms=bound(card, 12 * k2, 3 * k2 * PT)["bound_ms"],
        lanes_shape=f"two levels by lanes: {m1} -> {m2} -> {m3} points, "
        f"{m2 + m3} adds", lanes_ms=lanes_g,
        lanes_bound_ms=bound(card, 12 * (m2 + m3),
                             (m1 + m2 + m3) * PT)["bound_ms"])
    held("two-level H", msm5.tree_down2(x3, x2, x1),
         msm5.tree_down2_plain(x3, x2, x1))
    held("one-level H", msm5.tree_down(x2, x1), msm5.tree_down_plain(x2, x1))
    one_h = cuda_ms(lambda: msm5.tree_down(x2, x1))
    log(f"kernel H one level, {k2} adds: {one_h:.3f} ms")
    rec("msm5_tree_down", "quill_tpu/ec/msm3.py:267 (_down_kernel)", k1 - k3,
        (k3 + k2 // 2 + k1 // 2 + k1) * PT,
        f"two levels back to the leaf pairs: {k3} -> {k2} -> {k1} prefixes, "
        f"{k1 - k3} adds", lambda: msm5.tree_down2(x3, x2, x1),
        lambda: msm5.tree_down2_plain(x3, x2, x1),
        one_level_shape=f"finest level, {k2} adds, {k1} outputs",
        one_level_ms=one_h,
        one_level_bound_ms=bound(card, 12 * k2, 4 * k2 * PT)["bound_ms"],
        lanes_shape=f"two levels by lanes: {m3} -> {m2} -> {m1} prefixes, "
        f"{m1 - m3} adds", lanes_ms=lanes_h,
        lanes_bound_ms=bound(card, 12 * (m1 - m3), (
            m3 + m2 // 2 + m1 // 2 + m1) * PT)["bound_ms"])
    del x2, x3, y1, y2, y3
    levels = [x1]
    while levels[-1].shape[0] > msm5.TOP:
        levels += msm5.tree_up2(levels[-1])
    top = levels[-1].contiguous()
    w = top.shape[0]
    del levels
    held("the fused top", msm5.tree_top(top), msm5.tree_top_plain(top))
    rec("msm5_tree_top", "quill_tpu/ec/msm3.py:361 (_k_treetop_up) and "
        ":391 (_k_treetop_down), XLA in the TPU build, with the "
        ":258 (_up_kernel) and :267 (_down_kernel) launches of their "
        "levels", top_adds(w), 2 * w * PT,
        f"the path's top level, {w} points, up to one and back down",
        lambda: msm5.tree_top(top), lambda: msm5.tree_top_plain(top))
    terms = x1[:4 * 2 * msm5.NBUCK].contiguous()
    v6 = x1[:1 << 16].contiguous()
    group = 2 * msm5.NBUCK
    held("the fused top's reduce mode",
         msm5.tree_reduce(terms, group), msm5.tree_reduce_plain(terms, group))
    held("the fused top's reduce mode (v6)", msm5.tree_reduce(v6, 1 << 16),
         msm5.tree_reduce_plain(v6, 1 << 16))

    def halving(x, rows):
        while x.shape[0] > rows:
            x = msm5.tree_up(x)
        return x

    chain_ms = cuda_ms(lambda: halving(terms, 4))
    v6_ms = cuda_ms(lambda: msm5.tree_reduce(v6, 1 << 16))
    v6_chain_ms = cuda_ms(lambda: halving(v6, 1))
    log(f"collect's reduction one level a launch: {chain_ms:.3f} ms; v6's "
        f"reduce_sum on 2^16 points {v6_ms:.3f} ms, one level a launch "
        f"{v6_chain_ms:.3f} ms")
    rec("msm5_tree_reduce", "quill_tpu/ec/msm3.py:258 (_up_kernel, one "
        "launch a level) in the collect's pairwise reduction (msm3.py:557 "
        "_k_collect) and v6's (quill_tpu/ec/msm6k.py:255-279)",
        terms.shape[0] - 4, (terms.shape[0] + 4) * PT,
        f"the collect's 4 runs of {group} terms, two launches",
        lambda: msm5.tree_reduce(terms, group),
        lambda: msm5.tree_reduce_plain(terms, group),
        one_level_chain_ms=chain_ms, v6_shape="v6's reduce_sum, 2^16 points",
        v6_ms=v6_ms, v6_one_level_chain_ms=v6_chain_ms,
        v6_bound_ms=bound(card, 12 * ((1 << 16) - 1),
                          ((1 << 16) + 1) * PT)["bound_ms"])
    del terms, v6
    got = msm5.prefix_tree(sh, idx)
    leaves = sh[idx.long()].contiguous()
    chain = msm5.prefix_tree_chain(leaves, msm5.tree_up0, msm5.tree_up,
                                   msm5.tree_down)
    check(torch.equal(got, chain), "prefix_tree disagrees with the chain of "
          "one-level launches")
    del got, chain
    times = dict(
        prefix_tree_ms=cuda_ms(lambda: msm5.prefix_tree(sh, idx)),
        prefix_tree_chain_ms=cuda_ms(lambda: msm5.prefix_tree_chain(
            leaves, msm5.tree_up0, msm5.tree_up, msm5.tree_down)),
        prefix_tree_top_width=w)
    log(f"prefix_tree, {leaves.shape[0]} leaves: "
        f"{times['prefix_tree_ms']:.3f} ms; the chain of one-level launches "
        f"{times['prefix_tree_chain_ms']:.3f} ms; equal triples")
    return out, times


FERMAT_INV = 256 + 110     # products of x^(p-2): squarings, set bits of p-2


def shifted_products(nwin: int, wbits: int) -> int:
    """Field products a point of kernel E's shifted basis, by the kernel's
    own method: nwin - 1 rounds of wbits doublings of 8 products (algorithm
    9), Montgomery's trick over its nwin - 1 window points (one product up,
    two down and two for x and y: 5 each) and one Fermat inversion a
    thread."""
    return (nwin - 1) * (8 * wbits + 5) + FERMAT_INV


def shifted_least_products(nwin: int, wbits: int, n: int) -> int:
    """The shifted basis's least work, field products for n points: the
    cheapest doubling, Jacobian dbl-2009-l (7 products; the first from
    Z = 1 one fewer, mdbl-2007-bl), and each of the nwin - 1 new window
    points made affine with one inversion shared by all of them
    (Montgomery's trick, 3 products a point) and Z^-2, Z^-3, x and y (4).
    No method that doubles needs fewer."""
    return n * ((nwin - 1) * (7 * wbits + 7) - 1) + FERMAT_INV


def shifted_basis_kernel(own, card):
    """Kernel E's shifted basis against its plain twin (the doubling ladder
    and one batch normalisation a chunk), exactly, at the launches the
    routes make: one 2^16-point chunk of the host CRS at the small route's
    20 windows of 13 bits and at v6's 16 of 16, two chunks in one launch at
    (20, 13) (the small route's call on a 2^17-point slice), and v6's
    whole basis for the 2^16-row prove's largest v6 MSM (V6_POINTS[0]
    points, one window-major block).  -> (record, the (20, 13) chunk's
    basis)."""
    from quill_tpu_torch.ec import msm5, msm6
    from quill_tpu_torch.fields import device as fd

    def held(n, nwin, wbits, chunk, what):
        xy, inf = own.xy[:n], own.inf[:n]
        got = msm5.shifted_basis(xy, inf, nwin, wbits, chunk)
        want = msm5.shifted_basis_plain(xy, inf, nwin, wbits, chunk)
        err = tensor_err(got.reshape(-1, fd.NLIMB), want.reshape(-1, fd.NLIMB),
                         fd.FQ)
        check(err == 0, f"kernel E's shifted basis ({what}) disagrees with "
              f"its plain twin")
        del want
        return dict(
            err=err, sh=got,
            ms=cuda_ms(lambda: msm5.shifted_basis(xy, inf, nwin, wbits,
                                                  chunk)),
            plain_ms=cuda_ms(lambda: msm5.shifted_basis_plain(
                xy, inf, nwin, wbits, chunk), reps=1),
            **bound(card, shifted_least_products(nwin, wbits, n),
                    n * (AFF + 1 + nwin * AFF)))

    n, nv = msm5.CHUNK, V6_POINTS[0]
    res = {}
    for tag, m, nwin, wbits, chunk in (
            ("small", n, msm5.NWIN, msm5.WBITS, None),
            ("v6", n, msm6.NWIN, msm6.WBITS, None),
            ("small_2", 2 * n, msm5.NWIN, msm5.WBITS, msm5.CHUNK),
            ("v6_prove", nv, msm6.NWIN, msm6.WBITS, None)):
        what = (f"{m} points x {nwin} windows of {wbits} bits"
                + (f", chunks of {chunk}" if chunk else ""))
        res[tag] = held(m, nwin, wbits, chunk, what)
        if tag != "small":
            del res[tag]["sh"]
        log(f"kernel E shifted basis, {what}: {res[tag]['ms']:.3f} ms vs "
            f"plain {res[tag]['plain_ms']:.3f} ms (bound "
            f"{res[tag]['bound_ms']:.3f} ms)")
    small, v6, two, big = (res["small"], res["v6"], res["small_2"],
                           res["v6_prove"])
    rec = dict(
        name="msm5_shifted_basis", route="cuda",
        source="quill_tpu_torch/csrc/msm5.cu + quill_tpu_torch/csrc/"
               "ladder.cuh",
        replaces="quill_tpu/fields/pallas8.py:475 (_stacked_combine_kernel, "
                 "one launch a doubling) at quill_tpu/ec/msm3.py:90 "
                 "(_shift_doubling) and quill_tpu/ec/msm6.py:157 "
                 "(_shift_doubling16), with quill_tpu/ec/fixed_base.py:158 "
                 "(_batch_normalize, XLA)",
        shape=f"one {n}-point CRS chunk, 20 windows of 13 bits (the small "
              f"route's)",
        max_abs_err=max(r["err"] for r in res.values()), ms=small["ms"],
        plain_ms=small["plain_ms"], bound_ms=small["bound_ms"],
        bound_by=small["bound_by"], library_ms=None,
        least_products_a_point=shifted_least_products(
            msm5.NWIN, msm5.WBITS, n) / n,
        products_a_point=shifted_products(msm5.NWIN, msm5.WBITS),
        v6_shape=f"one {n}-point CRS chunk, 16 windows of 16 bits",
        v6_ms=v6["ms"], v6_plain_ms=v6["plain_ms"],
        v6_bound_ms=v6["bound_ms"],
        two_chunk_shape=f"{2 * n} points in chunks of {n}, 20 windows of "
                        f"13 bits (the small route's call on a 2^17-point "
                        f"slice)",
        two_chunk_ms=two["ms"], two_chunk_plain_ms=two["plain_ms"],
        two_chunk_bound_ms=two["bound_ms"],
        v6_prove_shape=f"{nv} points, 16 windows of 16 bits (the 2^16-row "
                       f"prove's largest v6 MSM)",
        v6_prove_ms=big["ms"], v6_prove_plain_ms=big["plain_ms"],
        v6_prove_bound_ms=big["bound_ms"])
    return rec, small["sh"]


def ntt_kernels(engine, card, big, rand_fr):
    """Kernel B's launch-level functions against their plain twins on the
    same inputs, exactly, at the 2^16-row prove's largest product (2^18 x
    2^18 coefficients: transforms of 2^19 points, two passes each): every
    forward, product and inverse pass of one product, the twiddle table
    and the S fold.  The 2^20-row prove's (2^22 x 2^22: 2^23 points, three
    passes a transform) timed: a forward transform, pass by pass, the whole
    product and the whole S polynomial.  -> records."""
    import torch

    from quill_tpu_torch.engine.device import TVec
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.poly import ntt

    dev = engine.device

    def kind(step):
        return ("ntt_product" if step.get("y") is not None
                else "ntt_forward" if step.get("dif") else "ntt_inverse")

    def launches(fn):
        """Kernel B's launches (every ntt_* count) in one call of fn."""
        before = dict(build.LAUNCHES)
        fn()
        return sum(v - before[k] for k, v in build.LAUNCHES.items()
                   if k.startswith("ntt_"))

    def work(logn, m, steps):
        """(products, bytes) of the passes `steps` on a 2^logn array whose
        first pass reads m rows: n/2 a stage, n a product by y or by the
        scale; each input row, twiddle entry and output row once."""
        n = 1 << logn
        products, rows = 0, m + n
        for st in steps:
            stages = st["s"] * ((1 if st.get("dif") else 0)
                                + (1 if st.get("dit") else 0))
            products += stages * n // 2
            products += n * ((st.get("y") is not None)
                             + (st.get("scale") is not None))
            rows += n * (st.get("y") is not None)
            rows += sum(1 << b for b in range(st["b0"], st["b0"] + st["s"]))
        return products, rows * FE

    a, b = rand_fr(big), rand_fr(big)
    logn = (2 * big - 2).bit_length()
    n = 1 << logn
    passes = ntt.plan(logn)
    ntt.TABLES.clear()
    tw = ntt.twiddle_table(logn, dev)
    errs = dict.fromkeys(("ntt_forward", "ntt_product", "ntt_inverse"), 0)
    errs["ntt_twiddles"] = tensor_err(
        tw, ntt.twiddle_table_plain(logn, dev))
    fa = ntt.chain(a, logn, ntt.forward_steps(passes), tw, False)
    chains = ((a, ntt.forward_steps(passes)),
              (b, ntt.product_steps(passes, fa, logn)))
    for x, steps in chains:
        src, valid = x, x.shape[0]
        got = torch.empty((n, fd.NLIMB), dtype=torch.int32, device=dev)
        want = torch.empty_like(got)
        for st in steps:
            ntt.pass_plain(src, want, valid, logn, tw=tw, **st)
            ntt.pass_cuda(src, got, valid, logn, tw=tw, **st)
            errs[kind(st)] = max(errs[kind(st)], tensor_err(got, want))
            src, valid = got, n
    prod = ntt.poly_mul(a, b)
    check(torch.equal(prod, got), "kernel B's launches differ from poly_mul")
    small = fd.to_ints(ntt.poly_mul(a[:64], b[:64])[:127])
    host = engine.host
    want = host.poly_mul(host.vec_from_ints(fd.to_ints(a[:64])),
                         host.vec_from_ints(fd.to_ints(b[:64])))
    check(small == [int(v) for v in want],
          "kernel B's product differs from the host product")
    h = ntt.poly_mul(a, torch.flip(b, [0]))
    errs["ntt_s_fold"] = tensor_err(ntt.s_fold(h, big),
                                    ntt.s_fold_plain(h, big))
    check(not any(errs.values()),
          f"kernel B disagrees with its plain twins: {errs}")

    x = prod.clone()
    fwd = ntt.forward_steps(passes)
    prod_step = ntt.product_steps(passes, fa, logn)[len(passes) - 1]
    inv = ntt.inverse_steps(passes[:-1])

    def passes_ms(steps, plain=False):
        run = ntt.pass_plain if plain else ntt.pass_cuda
        return cuda_ms(lambda: [run(x, x, n, logn, tw=tw, **st)
                                for st in steps], reps=1 if plain else 3)

    times = dict(
        ntt_forward=(passes_ms(fwd), passes_ms(fwd, True)),
        ntt_product=(passes_ms([prod_step]), passes_ms([prod_step], True)),
        ntt_inverse=(passes_ms(inv), passes_ms(inv, True)),
        ntt_s_fold=(cuda_ms(lambda: ntt.s_fold(h, big)),
                    cuda_ms(lambda: ntt.s_fold_plain(h, big), reps=1)),
        ntt_twiddles=(cuda_ms(lambda: ntt.twiddle_table_cuda(logn, dev)),
                      cuda_ms(lambda: ntt.twiddle_table_plain(logn, dev),
                              reps=1)))
    product_ms = cuda_ms(lambda: ntt.poly_mul(a, b))
    product_launches = launches(lambda: ntt.poly_mul(a, b))
    check(product_launches == 3 * len(passes) - 1,
          f"a 2^{logn}-point product took {product_launches} launches")
    product_plain_ms = cuda_ms(lambda: ntt.poly_mul(a, b, plain=True),
                               reps=1)
    del x, h, fa, prod, got, want

    # the 2^20-row prove's largest product, timed
    mb = 1 << (BIG_LOG2_ROWS + 2)
    lb = mb.bit_length()
    nb = 1 << lb
    ab, bb = uniform_scalars(mb, dev, 77), uniform_scalars(mb, dev, 78)
    bpasses = ntt.plan(lb)
    twb = ntt.twiddle_table(lb, dev)
    xb = ntt.chain(ab, lb, ntt.forward_steps(bpasses), twb, False)
    big_fwd = {}
    for i, st in enumerate(ntt.forward_steps(bpasses)):
        src, valid = (ab, mb) if i == 0 else (xb, nb)
        big_fwd[f"bits {st['b0']}-{st['b0'] + st['s'] - 1}"] = cuda_ms(
            lambda: ntt.pass_cuda(src, xb, valid, lb, tw=twb, **st))
    large = dict(
        forward_ms=cuda_ms(lambda: ntt.chain(
            ab, lb, ntt.forward_steps(bpasses), twb, False)),
        forward_bound_ms=bound(card, *work(
            lb, mb, ntt.forward_steps(bpasses)))["bound_ms"],
        forward_launches=launches(lambda: ntt.chain(
            ab, lb, ntt.forward_steps(bpasses), twb, False)),
        forward_pass_ms=big_fwd,
        product_ms=cuda_ms(lambda: ntt.poly_mul(ab, bb)),
        product_bound_ms=bound(card, 3 * (nb // 2) * lb + 2 * nb,
                               (2 * mb + 2 * nb) * FE)["bound_ms"],
        product_launches=launches(lambda: ntt.poly_mul(ab, bb)))
    check(large["forward_launches"] == len(bpasses) <= 4
          and large["product_launches"] == 3 * len(bpasses) - 1,
          f"the 2^{lb}-point transform and product took "
          f"{large['forward_launches']} and {large['product_launches']} "
          f"launches")
    large["s_polynomial_ms"] = cuda_ms(
        lambda: engine.s_polynomial(TVec(ab), TVec(bb)))
    del ab, bb, xb
    log(f"kernel B: exact; 2^{lb}-point transform {large['forward_ms']:.3f} "
        f"ms in {large['forward_launches']} launches (bound "
        f"{large['forward_bound_ms']:.3f}); 2^{BIG_LOG2_ROWS + 2} x "
        f"2^{BIG_LOG2_ROWS + 2} product {large['product_ms']:.3f} ms "
        f"(bound {large['product_bound_ms']:.3f}), S polynomial "
        f"{large['s_polynomial_ms']:.3f} ms")

    src = "quill_tpu_torch/csrc/ntt.cu"
    body = "quill_tpu/poly/ntt8.py:135 (_ntt_body)"
    chain = "quill_tpu/poly/ntt.py:196 (ntt_chunks)"
    shape = f"2^18 x 2^18 product (transforms of 2^{logn} points)"
    out = []

    def rec(name, replaces, products, nbytes, what, **kw):
        ms, plain_ms = times[name]
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            shape=f"{what}, {shape}", max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, **bound(card, products, nbytes),
            library_ms=None, **kw))
        log(f"kernel B {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms "
            f"(bound {out[-1]['bound_ms']:.4f})")

    rec("ntt_forward", f"{body}; {chain}", *work(logn, big, fwd),
        f"a forward transform, {len(fwd)} launches",
        big_shape=f"a forward transform of 2^{lb} points",
        **{f"big_{k}": v for k, v in large.items() if k.startswith("forward")})
    rec("ntt_product",
        f"{body}; quill_tpu/poly/ntt.py:294 (poly_mul_ntt's product and "
        f"the 1/N scale)", *work(logn, n, [prod_step]),
        "the fused product pass, 1 launch",
        poly_mul_ms=product_ms, poly_mul_plain_ms=product_plain_ms,
        poly_mul_bound_ms=bound(card, 3 * (n // 2) * logn + 2 * n,
                                (2 * big + 2 * n) * FE)["bound_ms"],
        poly_mul_launches=product_launches,
        big_poly_mul_shape=f"2^{BIG_LOG2_ROWS + 2} x 2^{BIG_LOG2_ROWS + 2}",
        big_poly_mul_ms=large["product_ms"],
        big_poly_mul_bound_ms=large["product_bound_ms"],
        big_poly_mul_launches=large["product_launches"])
    rec("ntt_inverse", f"{body}; {chain} (inverse)", *work(logn, n, inv),
        f"the inverse passes after the product pass, {len(inv)} launches")
    rec("ntt_s_fold", "quill_tpu/engine/device.py:864 (s_polynomial, XLA)",
        0, 3 * (big - 1) * FE, "S[k] = h[m + k] + h[m - 2 - k]",
        big_s_polynomial_ms=large["s_polynomial_ms"])
    # row b is entry j * 2^(logn-1-b) of the top row: the least work is
    # the top row's 2^(logn-1) products and one write of the table
    rec("ntt_twiddles", "quill_tpu/poly/ntt.py:58 (_stage_twiddles, "
        "host)", 1 << (logn - 1), ntt.tw_rows(logn) * FE,
        f"the twiddle table of rows b < {logn}")
    return out


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
            keys, idx = msm6.sort_keys(fd.from_mont(s, fd.FR), bs.inf,
                                       sh.shape[1])
            rec = leaf_record(
                "msm6_level0", "quill_tpu/ec/msm6k.py:58 (_lvl0_kernel)",
                flat, idx, msm6.level0, msm6.level0_plain,
                f"{idx.shape[0] // 2} affine leaf pairs gathered through the "
                f"sort (a v6 MSM of {n} points: 16 x {n} leaves)", card)
            walk = v6_walk(keys, flat, idx, card)
            del flat, idx, keys
        del own, bs, sh, s
    rec.update(times)
    return [rec, walk]


def v6_walk(keys, flat, idx, card):
    """Kernel E's walk mode at a v6 MSM's real shapes (its 2^16 - 1 bucket
    counts over its tree) against the chain of flagged kernel E launches
    and the plain chain with `torch.equal`; the
    fused top as the prefix of the tree's top level against Hillis-Steele
    (kernel E launches) as points.  The bound counts this data's adds: one
    a set bit of a count below the top's level.  -> the walk's record,
    with the top's times."""
    import torch

    from quill_tpu_torch.ec import device as ed
    from quill_tpu_torch.ec import msm5, msm6

    dev = keys.device
    cnt = torch.searchsorted(keys, torch.arange(
        msm6.NQ, dtype=torch.int32, device=dev), right=True)
    levels = msm6.tree(flat, idx)
    kmin, w = len(levels), levels[-1].shape[0]
    top = msm5.tree_top(levels[-1])
    hs = msm6.prefix(levels[-1])
    check(bool(ed.points_equal(top, hs).all()),
          "the fused top's prefixes are not v6's prefix sums")
    want = msm6.queries(cnt, flat, idx, levels, top)
    check(torch.equal(want, msm6.queries(cnt, flat, idx, levels, top,
                                         plain=True)),
          "the chain of kernel E launches disagrees with the plain chain")
    check(torch.equal(msm6.query_walk(cnt, flat, idx, levels, top), want),
          "v6's query walk disagrees with the chain")
    low = cnt & ((1 << kmin) - 1)
    adds = sum(int(((low >> k) & 1).sum()) for k in range(kmin))
    times = dict(
        ms=cuda_ms(lambda: msm6.query_walk(cnt, flat, idx, levels, top),
                   reps=10),
        chain_ms=cuda_ms(lambda: msm6.queries(cnt, flat, idx, levels, top)),
        plain_ms=cuda_ms(lambda: msm6.queries(cnt, flat, idx, levels, top,
                                              plain=True), reps=1),
        top_shape=f"the tree's top level, {w} points: its prefix sums",
        top_ms=cuda_ms(lambda: msm5.tree_top(levels[-1]), reps=10),
        top_chain_ms=cuda_ms(lambda: msm6.prefix(levels[-1])),
        top_bound_ms=bound(card, 12 * top_adds(w), 2 * w * PT)["bound_ms"])
    log(f"v6's query walk, {msm6.NQ} buckets over {kmin} levels ({adds} "
        f"adds): {times['ms']:.3f} ms vs the chain of kernel E launches "
        f"{times['chain_ms']:.3f} ms, plain {times['plain_ms']:.3f} ms; the "
        f"top's prefix at {w} points {times['top_ms']:.3f} ms vs "
        f"Hillis-Steele {times['top_chain_ms']:.3f} ms")
    return dict(
        name="msm5_query_walk", route="cuda",
        source="quill_tpu_torch/csrc/msm5.cu + quill_tpu_torch/csrc/"
               "query.cuh",
        replaces="quill_tpu/ec/msm6k.py:174-247 (_qinit_fn, _qstep_fn, "
                 "_qstep0_fn, _qstep_pair_fn: the XLA query walk), run before "
                 "as quill_tpu/fields/pallas8.py:475 "
                 "(_stacked_combine_kernel, flagged) a level",
        shape=f"{msm6.NQ} bucket queries of a v6 MSM of {V6_POINTS[0]} "
              f"points: {kmin} levels, {adds} adds, one bucket a thread",
        max_abs_err=0, **times,
        **bound(card, 12 * adds, msm6.NQ * (8 + PT) + adds * PT),
        library_ms=None)


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


def quotient_kernel(dev, rng, card):
    """Kernel M against its plain twin at open_many batches the proves give
    it (`chip_smoke.py` logs every path's batches): QUOT_BATCHES, uniform
    coefficients and points; both also at every run length of QUOT_RUNS,
    against the default's output."""
    import torch

    from quill_tpu_torch.engine import quotient as Q
    from quill_tpu_torch.fields.bn254 import R

    res = {}
    for tag, lengths in QUOT_BATCHES.items():
        cs = [uniform_scalars(n, dev, 4000 + 16 * n.bit_length() + j)
              for j, n in enumerate(lengths)]
        xs = [rng.randrange(1, R) for _ in lengths[1:]] + [R - 7]
        ys, qs = Q.scan(cs, xs)
        pys, pqs = Q.scan_plain(cs, xs)
        err = max([max_abs_err(ys, pys)]
                  + [tensor_err(a, b) for a, b in zip(qs, pqs)])
        check(err == 0, f"kernel M disagrees with its plain twin at {tag}")
        del pqs
        for r in QUOT_RUNS:
            rys, rqs = Q.scan(cs, xs, r)
            check(rys == ys and all(torch.equal(a, b) for a, b in
                                    zip(rqs, qs)),
                  f"kernel M at {r} coefficients a thread disagrees at {tag}")
        del qs, rqs
        # the function's least work: Horner's rule q_{k-1} = c_k + x q_k,
        # one product a coefficient, c read once and q written once.
        # Kernel M, run in parallel, does 2 (each run's recurrence, and
        # carry x^j stepped in phase 3) and reads c twice
        total = sum(lengths)
        res[tag] = dict(
            shape=f"{len(lengths)} openings of {lengths[0]} or "
                  f"{lengths[0] - 1} coefficients (an open_many batch of the "
                  f"{tag} prove)",
            err=err, ms=cuda_ms(lambda: Q.scan(cs, xs)),
            plain_ms=cuda_ms(lambda: Q.scan_plain(cs, xs), reps=1),
            run=Q.run_for(lengths),
            by_run={r: cuda_ms(lambda r=r: Q.scan(cs, xs, r))
                    for r in QUOT_RUNS},
            **bound(card, total, 2 * FE * total))
        log(f"kernel M, {res[tag]['shape']}: {res[tag]['ms']:.3f} ms vs "
            f"plain {res[tag]['plain_ms']:.3f} ms (bound "
            f"{res[tag]['bound_ms']:.3f} ms); by coefficients a thread: "
            + json.dumps(res[tag]["by_run"]))
        del cs
    big, small = res[f"2^{BIG_LOG2_ROWS}-row"], res[f"2^{LOG2_ROWS}-row"]
    return dict(
        name="quotient", route="cuda",
        source="quill_tpu_torch/csrc/quotient.cu",
        replaces="quill_tpu/engine/quotient.py:127 (quotient_many_device, "
                 "XLA in the TPU build)",
        shape=big["shape"], max_abs_err=max(big["err"], small["err"]),
        ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
        bound_by=big["bound_by"], library_ms=None,
        small_shape=small["shape"], small_ms=small["ms"],
        small_plain_ms=small["plain_ms"], small_bound_ms=small["bound_ms"],
        run=big["run"], ms_by_run=big["by_run"], small_run=small["run"],
        small_ms_by_run=small["by_run"])


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


L2_BYTES = 50e6            # the H100's L2 cache
J_NORMALISE = 5            # products a point of a block's normalisation


def fixed_base_kernel(kzg_big, card):
    """Kernel J against its twin (plain sums, then `to_affine`) with
    `torch.equal`: its table at the 2^22 + 1-point CRS's width (one launch
    over the 4-bit host table), one 2^16-point chunk of tau powers over
    it, and the whole CRS of 2^18 + 1 points (table and CRS, as `setup`
    makes it, against the twin on the same powers).  The bound counts the
    least work of a fixed-base method whose signed table fits in L2: the
    widest such w, its windows - 1 mixed adds and ~5 products of
    normalisation a point."""
    import torch

    from quill_tpu_torch.ec import fixed_base as fb
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.pcs.kzg import _tau_from_seed

    dev = kzg_big._basis.xy.device
    crs = kzg_big._basis.length
    tau = _tau_from_seed(0)
    w = fb.window_for(crs)
    w_l2 = max(v for v in range(1, 17) if fb.table_points(v) * AFF <= L2_BYTES)
    per_point = (fb.windows(w_l2) - 1) * fb.MIXED + J_NORMALISE

    def powers(n):
        return fd.from_mont(fd.powers(tau, n, fd.FR, dev), fd.FR)

    table = fb.make_table(w, dev)
    boot = fb.boot_table(dev)
    tab_s = fb.table_scalars(w, dev).reshape(-1, fd.NLIMB)
    check(torch.equal(table.reshape(-1, 2, fd.NLIMB),
                      fb.fixed_base_twin(tab_s, boot, fb.BOOT_W)),
          "kernel J's table disagrees with its twin")
    chunk = 1 << 16
    s = powers(chunk)
    check(torch.equal(fb.fixed_base(s, table, w),
                      fb.fixed_base_twin(s, table, w)),
          "kernel J disagrees with its twin on a 2^16-point chunk")
    n18 = (1 << 18) + 1
    w18 = fb.window_for(n18)
    before = build.LAUNCHES["fixed_base"]
    got = fb.device_tau_powers(tau, n18, dev)
    launches18 = build.LAUNCHES["fixed_base"] - before
    check(torch.equal(got, fb.fixed_base_twin(
        powers(n18), fb.make_table(w18, dev), w18)),
          f"the CRS of {n18} points disagrees with kernel J's twin")
    del got
    t_k = cuda_ms(lambda: fb.fixed_base(s, table, w), reps=10)
    t_p = cuda_ms(lambda: fb.fixed_base_twin(s, table, w), reps=1)
    t_table = cuda_ms(lambda: fb.make_table(w, dev))
    t_table_p = cuda_ms(lambda: fb.fixed_base_twin(tab_s, boot, fb.BOOT_W),
                        reps=1)
    log(f"kernel J, {chunk} tau powers over the {w}-bit table: {t_k:.3f} ms "
        f"vs plain {t_p:.3f} ms; the table ({fb.table_points(w)} points) "
        f"{t_table:.3f} ms vs plain {t_table_p:.3f} ms; the CRS of {n18} "
        f"points at w = {w18}: {launches18} launches, equal to the twin")
    return dict(
        name="fixed_base", route="cuda",
        source="quill_tpu_torch/csrc/fixed_base.cu + quill_tpu_torch/csrc/"
               "fixed_base.cuh",
        replaces="quill_tpu/ec/fixed_base.py:90 (_k_fixed_base_chunk, XLA "
                 "in the TPU build) and :158 (_batch_normalize, XLA)",
        shape=f"one chunk of {chunk} tau powers over the {w}-bit signed "
              f"table of the CRS of {crs} points ({fb.windows(w)} windows, "
              f"affine rows out)",
        max_abs_err=0, ms=t_k, plain_ms=t_p,
        **bound(card, per_point * chunk, chunk * (FE + AFF)),
        library_ms=None,
        bound_w=w_l2, bound_products_a_point=per_point,
        bound_as_first_counted_ms=bound(card, 12 * 64 * chunk,
                                        chunk * (FE + PT))["bound_ms"],
        crs_bound_ms=bound(card, per_point * crs,
                           crs * (FE + AFF))["bound_ms"],
        crs_bound_as_first_counted_ms=bound(card, 12 * 64 * crs,
                                            crs * (FE + PT))["bound_ms"],
        w=w, table_points=fb.table_points(w), table_ms=t_table,
        table_plain_ms=t_table_p,
        crs_2_18_w=w18, crs_2_18_launches=launches18)


def v8_kernels(kzg_big, card):
    """v8's entries kernels on one chunk of 2^16 uniform Montgomery
    scalars against their plain twin; I on that chunk's scans
    (20 windows x 256 lanes of 256 sorted entries,
    then the block totals, then the triangle's 20 x 32 lanes of 256
    buckets), and at the chunk and block-scan shapes on every adversarial
    flag pattern (SCAN_PATTERNS); kernel E's v8 collect mode on that
    chunk, into accumulators that already hold one chunk's buckets; then a
    v8 MSM of 2^22 uniform scalars against kernels C and D."""
    import torch

    from quill_tpu_torch.ec import msm8
    from quill_tpu_torch.ec import device as ed
    from quill_tpu_torch.ec import msm as M
    from quill_tpu_torch.fields import device as fd
    from quill_tpu_torch.fields.bn254 import R

    bb = kzg_big._basis
    dev = bb.xy.device
    out = []

    # I and E on one chunk of a 2^22-point MSM
    nbig = bb.length - 1
    s_big = uniform_scalars(nbig, dev, 1234, [0, 1, R - 1, R - 2] + [
        8191 << (13 * w) for w in range(19)])
    chunk = (s_big[:msm8.CHUNK], bb.xy[:msm8.CHUNK], bb.inf[:msm8.CHUNK])
    sorted_d, xs, flags = msm8.chunk_entries(*chunk)
    want = msm8.chunk_entries_plain(*chunk)
    check(all(torch.equal(g, w) for g, w in zip((sorted_d, xs, flags), want)),
          "v8's entries kernels differ from their plain twin")
    del want
    n, (nwin, npad) = msm8.CHUNK, sorted_d.shape
    out.append(dict(
        name="msm8_entries", route="cuda",
        source="quill_tpu_torch/csrc/msm8.cu + csrc/entries.cuh",
        replaces="quill_tpu/ec/msm8.py:117 (_k_sort_gather8, XLA; the "
                 "port's plain-torch digits, sort and gathers)",
        shape=f"one v8 chunk: {n} Montgomery scalars -> {nwin} x {npad} "
              f"sorted entries, four launches",
        max_abs_err=0,
        ms=cuda_ms(lambda: msm8.chunk_entries(*chunk)),
        plain_ms=cuda_ms(lambda: msm8.chunk_entries_plain(*chunk), reps=1),
        **bound(card, n, n * (FE + AFF + 1) + nwin * npad * (PT + 4 + 1)),
        library_ms=None))
    log(f"v8 entries, one chunk of {n}: {out[-1]['ms']:.3f} ms vs plain "
        f"{out[-1]['plain_ms']:.3f} ms (bound {out[-1]['bound_ms']:.4f} "
        f"ms); equal")
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
    acc = msm8.collect(sorted_d, ys, wf, offs,
                       ed.identity(msm8.NWIN * msm8.NBUCK, dev))
    got = msm8.collect(sorted_d, ys, wf, offs, acc.clone())
    want = msm8.collect_plain(sorted_d, ys, wf, offs, acc.clone())
    check(torch.equal(got, want), "kernel E's v8 collect gives other "
          "triples than its plain twin")
    err_c = points_err(got, want)
    # this chunk's work: the last position of each digit's run adds its
    # scan value (plus its block offset where unflagged) into its bucket
    nwin, npad = sorted_d.shape
    last = torch.ones_like(sorted_d, dtype=torch.bool)
    last[:, :-1] = sorted_d[:, :-1] != sorted_d[:, 1:]
    act = last & (sorted_d > 0)
    active = int(act.sum())
    unflagged = int((act & ~wf.reshape(nwin, npad)).sum())
    scratch = acc.clone()
    out.append(dict(
        name="msm8_collect", route="cuda",
        source="quill_tpu_torch/csrc/msm8.cu",
        replaces="quill_tpu/fields/pallas8.py:475 (_stacked_combine_kernel, "
                 "flagged and plain) at quill_tpu/ec/msm8.py:193 "
                 "(_k_collect8)",
        shape=f"one v8 chunk's collect: {nwin} x {msm8.NBUCK - 1} buckets, "
              f"{active} active, {unflagged} of them unflagged (2^16 "
              f"uniform scalars)",
        max_abs_err=err_c,
        ms=cuda_ms(lambda: msm8.collect(sorted_d, ys, wf, offs, scratch)),
        plain_ms=cuda_ms(lambda: msm8.collect_plain(sorted_d, ys, wf, offs,
                                                    scratch), reps=1),
        **bound(card, 12 * (active + unflagged),
                nwin * npad * 4 + active * (3 * PT + 1) + unflagged * PT),
        library_ms=None))
    del scratch, got, want
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
        f"kernel E's v8 collect ({active} buckets): {out[-1]['ms']:.3f} ms "
        f"vs plain {out[-1]['plain_ms']:.3f} ms")
    log(f"kernel I threads a lane: {json.dumps(threads)}; equal points on "
        f"flags {', '.join(SCAN_PATTERNS)} at the chunk and block-scan "
        f"shapes")
    tri_lanes = rev.shape[0]
    out.append(triangle_doubling(acc, card))
    del xs, flags, ys, wf, offs, acc, rev

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


def triangle_doubling(acc, card):
    """Kernel E's doubling at v8's triangle (`msm8.triangle`): its 20
    window points doubled 8 times in one launch, against the plain twin
    (the same triples) and the 8 kernel E adds it replaced (the same
    points); the whole triangle timed."""
    import torch

    from quill_tpu_torch.ec import msm5, msm8

    t = msm8.triangle(acc)
    k = msm8.BS.bit_length() - 1

    def chain():
        x = t
        for _ in range(k):
            x = msm5.pt_add(x, x)
        return x

    got = msm5.pt_dbl(t, k)
    check(torch.equal(got, msm5.pt_dbl_plain(t, k)),
          "kernel E's doubling disagrees with its plain twin")
    err = points_err(got, chain())
    check(err == 0, "kernel E's doubling disagrees with its add chain")
    rec = dict(
        name="msm5_pt_dbl", route="cuda", source="quill_tpu_torch/csrc/msm5.cu",
        replaces="quill_tpu/fields/pallas8.py:475 (_stacked_combine_kernel) "
                 "in the place of quill_tpu/ec/msm8.py:271 (_k_triangle): "
                 "the port's triangle weighs its lane sums by 2^8, 8 kernel "
                 "E launches of P + P before",
        shape=f"{t.shape[0]} window points x {k} doublings (v8's triangle)",
        max_abs_err=err, ms=cuda_ms(lambda: msm5.pt_dbl(t, k)),
        plain_ms=cuda_ms(lambda: msm5.pt_dbl_plain(t, k), reps=1),
        # least work: k Jacobian doublings of 7 products, and 3 products
        # into and 3 out of Jacobian coordinates where that is cheaper
        # than the complete formula's 8 a doubling
        **bound(card, min(8 * k, 7 * k + 6) * t.shape[0],
                2 * t.shape[0] * PT),
        library_ms=None, add_chain_ms=cuda_ms(chain),
        triangle_ms=cuda_ms(lambda: msm8.triangle(acc)))
    log(f"kernel E doubling, {rec['shape']}: {rec['ms']:.4f} ms vs plain "
        f"{rec['plain_ms']:.3f} ms, {k} kernel E adds {rec['add_chain_ms']:.4f}"
        f" ms; the triangle {rec['triangle_ms']:.3f} ms")
    return rec


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
    """The device CRS of the 2^20-row path (2^22 + 1 points, `setup`: kernel
    J's table, then the CRS, two launches), held against the host CRS: its
    first 2^18 + 1 points, and CRS_SAMPLES later ones against native
    scalar products.  Its parts are timed apart after it: the tau powers
    (plain torch) and the table.  -> (kzg, seconds, launches)."""
    import torch

    from quill_tpu_torch.ec import curve, native_ec
    from quill_tpu_torch.ec import fixed_base as fb
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
    check(launches["fixed_base"] <= 4, "the CRS took more than 4 kernel J "
          "launches")
    dev = xy.device
    w = fb.window_for(count + 1)
    powers_ms = cuda_ms(lambda: fd.from_mont(fd.powers(tau, count + 1, fd.FR,
                                                       dev), fd.FR), reps=1)
    table_ms = cuda_ms(lambda: fb.make_table(w, dev), reps=1)
    log(f"CRS: {count + 1} points on the device in {secs:.3f}s (kernel J "
        f"x{launches['fixed_base']}, w = {w}; apart: the tau powers "
        f"{powers_ms:.1f} ms of plain torch, the table "
        f"{table_ms:.1f} ms); the first {n} equal the host CRS, "
        f"{CRS_SAMPLES} sampled later ones equal native EC")
    return kzg, secs, launches


def prove_path(engine, circuit, witness, make_kzg, tag: str):
    """One main path with the launch counts, MSM routes and kernel M's
    batch shapes of its run alone: make_kzg() -> preprocess -> prove ->
    serialize -> verify."""
    import torch

    from quill_tpu_torch.kernels import build
    from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
    from quill_tpu_torch.poly import ntt
    from quill_tpu_torch.proof import hyperplonk
    from quill_tpu_torch.proof.hyperplonk import HyperPlonk, TraceWitness
    from quill_tpu_torch.utils.profiling import metrics
    from quill_tpu_torch.utils.proof_io import serialize_proof

    phases = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # every twiddle table is made in the path, as every CRS is
    ntt.TABLES.clear()
    build.reset_counts()
    engine.msm_counts = dict.fromkeys(engine.msm_counts, 0)
    engine.quotient_batches = {}
    metrics.reset()
    t0 = time.time()
    marks = []                 # build.LAUNCHES after each phase
    pcs = MultilinearPCS(make_kzg())
    torch.cuda.synchronize()
    phases["setup_s"] = time.time() - t0
    marks.append(dict(build.LAUNCHES))
    t0 = time.time()
    hp = HyperPlonk.preprocess([circuit], pcs)
    torch.cuda.synchronize()
    phases["preprocess_s"] = time.time() - t0
    marks.append(dict(build.LAUNCHES))
    t0 = time.time()
    proof = hp.prove([TraceWitness(columns=witness)])
    torch.cuda.synchronize()
    phases["prove_s"] = time.time() - t0
    phases["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(build.LAUNCHES)
    marks.append(launches)
    by_phase = {k: [marks[0][k], marks[1][k] - marks[0][k],
                    marks[2][k] - marks[1][k]]
                for k in launches if launches[k]}
    routes = dict(engine.msm_counts)
    data = serialize_proof(proof)
    t0 = time.time()
    hyperplonk.verify(proof, hp.to_vk(), pcs, batch_pairings=True)  # raises
    phases["verify_s"] = time.time() - t0
    digest = hashlib.sha256(data).hexdigest()
    log(f"{tag} proof: {len(data)} bytes, sha256 {digest}")
    log(f"{tag} phases: " + json.dumps(phases))
    log(f"{tag} launches: " + json.dumps(launches))
    log(f"{tag} launches by phase (setup, preprocess, prove): "
        + json.dumps(by_phase))
    log(f"{tag} MSMs by route (preprocess + prove): " + json.dumps(routes))
    batches = {" + ".join(f"2^{n.bit_length() - 1}" if n & (n - 1) == 0
                          else str(n) for n in key): count
               for key, count in engine.quotient_batches.items()}
    log(f"{tag} kernel M batches (coefficients a job: count): "
        + json.dumps(batches))
    spans = metrics.report()
    top = sorted(spans.items(), key=lambda kv: -kv[1]["total_sec"])
    log(f"{tag} host spans (utils/profiling): " + json.dumps(dict(top[:14])))
    log(f"{tag} kzg spans: " + json.dumps(
        {k: spans.get(k) for k in ("kzg/quotient", "kzg/open_msm",
                                   "mlpcs/s_poly")}))
    return dict(data=data, digest=digest, launches=launches, routes=routes,
                by_phase=by_phase)


def main():
    ap = argparse.ArgumentParser()
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
    check(small["launches"]["quotient"] > 0,
          "kernel M never launched on the 2^16-row path")
    check(small["launches"]["msm5_shifted_basis"] > 0
          and small["launches"]["msm5_pt_add"] == 0,
          "the 2^16-row path built no shifted basis, or added with kernel E")
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
    check(v6["launches"]["msm5_query_walk"] == v6["routes"]["v6"]
          and v6["launches"]["msm6_level0"] == v6["routes"]["v6"]
          and v6["launches"]["msm5_pt_add"] == 0,
          "the v6 prove did not take one query walk and one leaf-level "
          "launch a v6 MSM, or added with kernel E")
    v6_launches = v6["launches"]
    del v6, engine6
    log(f"2^{LOG2_ROWS}-row path on v6: {time.time() - t0:.1f}s")

    t0 = time.time()
    circuit, witness = fibonacci(1 << BIG_LOG2_ROWS)
    log(f"2^{BIG_LOG2_ROWS}-row witness: {time.time() - t0:.1f}s")
    big = prove_path(engine, circuit, witness, lambda: kzg_big,
                     f"2^{BIG_LOG2_ROWS}-row")
    check(big["routes"]["v8"] > 0, "no MSM of the 2^20-row prove took v8")
    check(big["launches"]["quotient"] > 0
          and big["launches"]["msm8_collect"] > 0,
          "kernel M or the v8 collect never launched on the 2^20-row path")
    v8 = big["routes"]["v8"]
    check(big["launches"]["msm8_entries"] == big["launches"]["msm8_collect"],
          "the 2^20-row path did not take one entries call a v8 chunk")
    log(f"2^{BIG_LOG2_ROWS}-row prove: {big['by_phase']['msm8_entries'][2]} "
        f"v8 entries calls (one a chunk)")
    check(big["launches"]["msm5_pt_dbl"] == v8
          and big["launches"]["msm5_pt_add"] == 3 * v8,
          "v8's triangle did not take one doubling and 3 adds a MSM")
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
