"""The v8 MSM route: per-window bucket sums by segmented scans, kernel I
(`csrc/msm8.cu`), kernel E's v8 collect mode (the same source) and their
plain PyTorch twins, with kernel E (`csrc/msm5.cu`) for the triangle's
elementwise adds.

Counterpart of `quill_tpu/ec/msm8.py`, the route the JAX engine takes for
bases above 2^20 points (`TorchEngine.msm_route`).  It holds no shifted
basis and no tree: one CRS chunk of 2^16 points at a time, and across
chunks only a fixed (20 windows x 8192 buckets) array of projective
accumulators.  Per chunk:

1. entries (`chunk_entries`, four launches of the entries kernels in
   `csrc/msm8.cu`): each Montgomery scalar's 20 unsigned 13-bit windows,
   each window's digits sorted stably; an entry whose digit is 0, or whose
   basis point is at infinity, becomes the identity and stays in the
   sequence (`msm8.py:117-153`); a flag marks every position where the
   digit changes, and the first position of each window;
2. chunk scan (`msm8.py:180-190`): each window's sorted sequence is cut
   into blocks of 256 entries, one scan lane per block; kernel I scans
   every lane, then the block totals of each window (restarting where a
   block holds a flag), which shifted by one block are the block offsets;
3. collect (`msm8.py:193-220`): the last position of each digit in each
   window, its within-block scan value combined with its block offset
   unless a segment started inside the block before it (flag ? b : a + b),
   added into the accumulator of the digit; kernel E's v8 collect mode does
   both adds in one launch, one thread a (window, digit), and leaves the
   buckets of absent digits as they are (the JAX package adds the identity
   to them).

Then the triangle (`msm8.py:246-286`), sum_k k B_k per window from two
unsegmented kernel I scans over the reversed buckets (see `triangle`),
and the 20 window sums are combined on the host: Horner over the
windows, 13 doublings each (`msm8.py:315-327`).

The TPU kernels laid every scan out as (S, 3L, M) f32 tiles with the steps
leading; here a scan input is (lanes, steps, 3, 8), lane-major, so every
sorted sequence above reshapes into lanes without a transpose.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..fields import device as fd
from ..fields.device import FQ, FR
from ..kernels import build
from ..utils.profiling import phase
from . import curve
from . import device as ed
from . import msm5
from .msm import TorchBasis

NWIN = msm5.NWIN
NBUCK = msm5.NBUCK
WBITS = msm5.WBITS
CHUNK = 1 << 16            # CRS points per chunk
BS = 256                   # scan steps per lane (entries per block)
SEG = 2048                 # scalars a segment of the entries' counting sort
CHUNK_MAX = 1 << 16        # the entries kernels keep 16-bit scalar indices

_FN = {}


def _fn(name="quill_seg_scan"):
    if not _FN:
        lib = build.lib("msm8")
        _FN["quill_seg_scan"] = build.bind(
            lib, "quill_seg_scan",
            [build.VP, build.VP, build.I64, build.I64, build.VP, build.VP])
        _FN["quill_seg_scan_threads"] = build.bind(
            lib, "quill_seg_scan_threads", [build.I64, build.I64, build.VP])
        _FN["quill_v8_collect"] = build.bind(
            lib, "quill_v8_collect",
            [build.VP, build.I32, build.I64, build.I32, build.I32, build.VP,
             build.VP, build.VP, build.VP, build.VP])
        _FN["quill_v8_entries"] = build.bind(
            lib, "quill_v8_entries",
            [build.VP, build.VP, build.VP, build.I64, build.I64, build.I64]
            + [build.VP] * 8)
    return _FN[name]


@lru_cache(maxsize=None)
def _ident(device: str) -> torch.Tensor:
    """The (1, 3, 8) identity point on `device`, made once: each
    `ed.identity` copies its constant from host memory, and such a copy
    waits for the card."""
    return ed.identity(1, device)


# ---------------------------------------------------------------------------
# kernel I: segmented scan
# ---------------------------------------------------------------------------


def seg_scan(xs: torch.Tensor, flags: torch.Tensor | None = None):
    """Kernel I: (m, s, 3, 8) points -> (m, s, 3, 8) inclusive scans along
    the steps of every lane, restarting at x[t] where the (m, s) bool
    `flags` is set: y[t] = flag[t] ? x[t] : y[t-1] + x[t], y[-1] the
    identity.  With no flags, a plain inclusive scan."""
    if not xs.is_cuda:
        return seg_scan_plain(xs, flags)
    if not (xs.dtype == torch.int32 and xs.is_contiguous() and xs.dim() == 4
            and xs.shape[2:] == (3, fd.NLIMB)):
        raise ValueError("xs must be a contiguous (m, s, 3, 8) int32 tensor")
    if flags is not None and not (
            flags.is_cuda and flags.dtype == torch.bool
            and flags.is_contiguous() and flags.shape == xs.shape[:2]):
        raise ValueError("flags must be a contiguous (m, s) bool tensor on "
                         "CUDA")
    m, s = xs.shape[:2]
    ys = torch.empty_like(xs)
    rc = _fn()(xs.data_ptr(), None if flags is None else flags.data_ptr(),
               m, s, ys.data_ptr(), build.stream_ptr())
    build.check(rc, "msm8_seg_scan")
    build.count("msm8_seg_scan")
    return ys


def scan_threads(m: int, s: int) -> int:
    """The threads kernel I gives each of m lanes of s steps on the current
    card (`threads_per_lane` in `csrc/msm8.cu`)."""
    t = ctypes.c_int(0)
    build.check(_fn("quill_seg_scan_threads")(m, s, ctypes.byref(t)),
                "msm8_seg_scan_threads")
    return t.value


def seg_scan_plain(xs: torch.Tensor, flags: torch.Tensor | None = None):
    """A serial loop over the steps, the lanes vectorised."""
    m, s = xs.shape[:2]
    acc = ed.identity_w((m,), xs.device)
    ys = torch.empty_like(xs)
    for t in range(s):
        x = fd.to_w16(xs[:, t])
        acc = ed.padd_w(acc, x)
        if flags is not None:
            acc = torch.where(flags[:, t, None, None], x, acc)
        ys[:, t] = fd.from_w16(acc)
    return ys


# ---------------------------------------------------------------------------
# one chunk: digits, sort, scans, collect
# ---------------------------------------------------------------------------


def chunk_entries(scs: torch.Tensor, xy: torch.Tensor, inf: torch.Tensor):
    """(n, 8) Montgomery scalars against a chunk's (n, 2, 8) affine points
    and (n,) infinity mask -> (sorted int32 digits (NWIN, npad), scan input
    (NWIN * nb, BS, 3, 8), flags (NWIN * nb, BS)), npad = nb * BS the
    chunk padded with digit-0 entries.  On the card the entries kernels
    (`csrc/msm8.cu`: four launches, no host synchronisation); on the CPU
    the plain twin."""
    if not scs.is_cuda:
        return chunk_entries_plain(scs, xy, inf)
    n = scs.shape[0]
    for t, shape, dt in ((scs, (n, fd.NLIMB), torch.int32),
                         (xy, (n, 2, fd.NLIMB), torch.int32),
                         (inf, (n,), torch.bool)):
        if not (t.is_cuda and t.dtype == dt and t.is_contiguous()
                and t.shape == shape):
            raise ValueError("chunk_entries takes contiguous CUDA tensors: "
                             "(n, 8) int32 scalars, (n, 2, 8) int32 points, "
                             "an (n,) bool mask")
    if not 1 <= n <= CHUNK_MAX or xy.data_ptr() % 16:
        raise ValueError(f"chunk_entries takes 1 to {CHUNK_MAX} scalars and "
                         "16-byte aligned points")
    dev = scs.device
    nb = -(-n // BS)
    npad = nb * BS
    i32 = dict(dtype=torch.int32, device=dev)
    dig = torch.empty((NWIN, n), dtype=torch.int16, device=dev)
    hist = torch.empty((NWIN, -(-n // SEG), NBUCK), **i32)
    tot = torch.empty((NWIN, NBUCK), **i32)
    ent = torch.empty((NWIN, npad), **i32)
    sorted_d = torch.empty((NWIN, npad), **i32)
    pts = torch.empty((NWIN * nb, BS, 3, fd.NLIMB), **i32)
    flags = torch.empty((NWIN * nb, BS), dtype=torch.bool, device=dev)
    rc = _fn("quill_v8_entries")(
        scs.data_ptr(), xy.data_ptr(), inf.data_ptr(), n, npad, SEG,
        dig.data_ptr(), hist.data_ptr(), tot.data_ptr(), ent.data_ptr(),
        sorted_d.data_ptr(), pts.data_ptr(), flags.data_ptr(),
        build.stream_ptr())
    build.check(rc, "msm8_entries")
    build.count("msm8_entries")
    return sorted_d, pts, flags


def chunk_entries_plain(scs: torch.Tensor, xy: torch.Tensor,
                        inf: torch.Tensor):
    """The plain twin: the scalars out of Montgomery form, their digits
    (`msm5.window_digits`), a stable `torch.sort` of each window, the
    points gathered through the permutation."""
    n = scs.shape[0]
    nb = -(-n // BS)
    d = msm5.window_digits(fd.from_mont(scs, FR)).T.to(torch.int32)
    d = d.contiguous()
    if nb * BS > n:
        d = torch.cat((d, d.new_zeros((NWIN, nb * BS - n))), 1)
    sorted_d, perm = torch.sort(d, dim=1, stable=True)
    pc = perm.clamp(max=n - 1)
    dead = (sorted_d == 0) | inf[pc]
    ident = _ident(str(scs.device))
    one = ident[0, 1].expand(*pc.shape, 1, fd.NLIMB)
    pts = torch.cat((xy[pc], one), -2)
    pts = torch.where(dead[..., None, None], ident, pts)
    flags = torch.ones_like(dead)
    flags[:, 1:] = sorted_d[:, 1:] != sorted_d[:, :-1]
    return (sorted_d, pts.reshape(NWIN * nb, BS, 3, fd.NLIMB),
            flags.reshape(NWIN * nb, BS))


def chunk_scan(xs: torch.Tensor, flags: torch.Tensor):
    """-> (within-block scans ys, within-block flag prefixes wf, block
    offsets (lanes, 3, 8)): the offsets are each window's scan of its block
    totals, restarting at a block that holds a flag, shifted by one block
    with the identity first."""
    ys = seg_scan(xs, flags)
    wf = torch.cummax(flags.to(torch.uint8), 1).values.bool()
    nb = xs.shape[0] // NWIN
    bys = seg_scan(ys[:, -1].reshape(NWIN, nb, 3, fd.NLIMB).contiguous(),
                   wf[:, -1].reshape(NWIN, nb).contiguous())
    ident = _ident(str(xs.device)).expand(NWIN, 1, 3, fd.NLIMB)
    offs = torch.cat((ident, bys[:, :-1]), 1)
    return ys, wf, offs.reshape(NWIN * nb, 3, fd.NLIMB)


def collect(sorted_d, ys, wf, offs, acc):
    """Kernel E's v8 collect mode (`csrc/msm8.cu`): each window's bucket
    totals from the chunk's scans (`chunk_entries`' int32 sorted digits,
    `chunk_scan`'s outputs) added into the (NWIN * NBUCK, 3, 8)
    accumulators in place, one thread a (window, digit) for digits 1 to
    8191; a digit absent from the chunk leaves its bucket as it is.  One
    launch, no host synchronisation."""
    if not acc.is_cuda:
        return collect_plain(sorted_d, ys, wf, offs, acc)
    nwin, npad = sorted_d.shape
    for t, dt in ((sorted_d, torch.int32), (ys, torch.int32),
                  (wf, torch.bool), (offs, torch.int32), (acc, torch.int32)):
        if not (t.is_cuda and t.dtype == dt and t.is_contiguous()):
            raise ValueError("collect takes contiguous CUDA tensors: int32 "
                             "digits and points, bool flags")
    if not (npad % BS == 0 and ys.numel() == nwin * npad * 24
            and wf.numel() == nwin * npad
            and offs.numel() == nwin * npad // BS * 24
            and acc.shape == (nwin * NBUCK, 3, fd.NLIMB)):
        raise ValueError("collect: operand shapes do not match the digits")
    rc = _fn("quill_v8_collect")(
        sorted_d.data_ptr(), nwin, npad, NBUCK, BS, ys.data_ptr(),
        wf.data_ptr(), offs.data_ptr(), acc.data_ptr(), build.stream_ptr())
    build.check(rc, "msm8_collect")
    build.count("msm8_collect")
    return acc


def collect_plain(sorted_d, ys, wf, offs, acc):
    """The plain twin, dense over the chunk's sorted positions: the last
    position of each digit's run (digit > 0) adds into its bucket, every
    other position into a scratch row past the accumulators, so nothing is
    compacted and nothing waits for the host.  The adds in the kernel's
    order, acc + (flag ? ys : offs + ys).  (Dense over the 20 x 8192
    buckets instead, a CPU run would pay 2 x 163,840 adds a chunk whatever
    its size.)"""
    nwin, npad = sorted_d.shape
    dev = sorted_d.device
    last = torch.ones_like(sorted_d, dtype=torch.bool)
    last[:, :-1] = sorted_d[:, :-1] != sorted_d[:, 1:]
    win = torch.arange(nwin, device=dev)[:, None]
    tgt = torch.where(last & (sorted_d > 0), win * NBUCK + sorted_d,
                      nwin * NBUCK).reshape(-1)
    v = msm5.pt_add_plain(offs.repeat_interleave(BS, 0),
                          ys.reshape(-1, 3, fd.NLIMB), wf.reshape(-1))
    ext = torch.cat((acc, ed.identity(1, dev)))
    ext[tgt] = msm5.pt_add_plain(ext[tgt], v)
    acc.copy_(ext[:-1])
    return acc


# ---------------------------------------------------------------------------
# triangle and host combine
# ---------------------------------------------------------------------------


def _neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack((p[:, 0], fd.neg(p[:, 1], FQ), p[:, 2]), 1)


def triangle(acc: torch.Tensor) -> torch.Tensor:
    """(NWIN * NBUCK, 3, 8) buckets -> (NWIN, 3, 8) window sums
    T = sum_k k B_k.

    With rev the reversed buckets and P their prefix sums (P[k'] is the
    suffix sum of the buckets from 8191 - k' up), T = sum_{k' < 8191} P[k']
    = sum_{k'} P[k'] - P[8191].  In lanes of BS buckets, P[l, t] = O[l] +
    y[l, t] with y the within-lane prefix sums and O[l] the sum of the lane
    totals Y before lane l; so, with Q the prefix sums of Y and
    Z[l] = sum_t y[l, t],

        T = BS (sum_l Q[l] - Q[-1]) + sum_l Z[l] - Q[-1].

    Kernel I scans the reversed buckets (y), then y itself (its totals are
    Z), then the 32 lane totals of each window (Q) and Q and Z together
    (their totals); kernel E adds, doubles 8 times in one launch
    (`msm5.pt_dbl`) and adds twice.  `msm8.py:246-286`
    takes a full scan, a combine pass over all buckets and a second full
    scan; this takes two scans and no combine pass."""
    nb = NBUCK // BS
    rev = acc.reshape(NWIN, NBUCK, 3, fd.NLIMB).flip(1)
    y = seg_scan(rev.reshape(NWIN * nb, BS, 3, fd.NLIMB).contiguous())
    z = seg_scan(y)[:, -1].reshape(NWIN, nb, 3, fd.NLIMB)
    q = seg_scan(y[:, -1].reshape(NWIN, nb, 3, fd.NLIMB).contiguous())
    tot = seg_scan(torch.cat((q, z), 0))[:, -1]
    sum_q, sum_z = tot[:NWIN], tot[NWIN:]
    last = _neg(q[:, -1])
    t = msm5.pt_dbl(msm5.pt_add(sum_q.contiguous(), last),
                    BS.bit_length() - 1)
    return msm5.pt_add(msm5.pt_add(t, sum_z.contiguous()), last)


def combine_windows(wsums: torch.Tensor) -> curve.Jacobian:
    """sum_w 2^(13 w) W_w on the host."""
    jac = ed.proj_to_jacobians(wsums)
    acc = curve.Jacobian.identity(curve.Fq(1))
    for w in range(NWIN - 1, -1, -1):
        for _ in range(WBITS):
            acc = acc.double()
        acc = acc.add(jac[w])
    return acc


def msm(basis: TorchBasis, scalars: torch.Tensor) -> curve.Jacobian:
    """(n, 8) Montgomery Fr scalars against the basis's first n points, one
    chunk of CHUNK points at a time.  On the card nothing up to the host
    combine waits for the host."""
    n = min(basis.length, scalars.shape[0])
    if n == 0:
        return curve.Jacobian.identity(curve.Fq(1))
    dev = basis.xy.device
    with phase("msm/v8/digits"):
        scs = scalars[:n].contiguous()
        acc = _ident(str(dev)).repeat(NWIN * NBUCK, 1, 1)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        with phase("msm/v8/digits"):
            sorted_d, xs, flags = chunk_entries(
                scs[lo:hi], basis.xy[lo:hi], basis.inf[lo:hi])
        with phase("msm/v8/scan"):
            ys, wf, offs = chunk_scan(xs, flags)
        del xs
        with phase("msm/v8/collect"):
            acc = collect(sorted_d, ys, wf, offs, acc)
    with phase("msm/v8/triangle"):
        wsums = triangle(acc)
    with phase("msm/v8/combine"):
        return combine_windows(wsums)
