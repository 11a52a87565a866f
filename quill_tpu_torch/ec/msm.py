"""Multi-scalar multiplication over G1: kernels C and D (`csrc/msm.cu`) and
their plain PyTorch twins.

Counterpart of `quill_tpu/ec/msm.py` (`DeviceBasis`, `load_basis`,
`slice_basis`) and of the v7 pipeline `quill_tpu/ec/msm7.py` with its
kernels `ec/msm7k.py` and `ec/msm6k.py`: the route of every MSM that the
small route (`ec/msm5.py`, `TorchEngine.msm_route`) does not take.  One
MSM:

1. scalars leave Montgomery form and are recoded into 16 signed 16-bit
   digits d in [-2^15, 2^15) (`ec/msm7.py:61-75`); basis points at
   infinity get digit 0;
2. every nonzero digit becomes an entry keyed by (window, |d| - 1), and
   `torch.sort` orders the keys (where the TPU build used XLA
   `sort_key_val`, `ec/msm7.py:96`);
3. kernel C sums each key's run of points into its bucket, in a fixed
   number of launches that read nothing back;
4. kernel D reduces each window's 2^15 buckets to sum_b b * B_b;
5. the 16 window sums are combined on the host with `curve.Jacobian`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..fields import device as fd
from ..fields.device import FR
from ..kernels import build
from . import curve
from . import device as ed

WBITS = 16
NWIN = 16
NBUCK = 1 << (WBITS - 1)   # |d| in [1, 2^15]
K_MIN, K_MAX = 16, 128     # sorted entries a kernel C thread sums
BLOCK = 64                 # threads a block of kernels C and D (msm.cu:
                           # MSM_BLOCK)
SEG = 16                   # buckets a kernel D thread reduces; with BLOCK
                           # the fastest on an H100 (PERF.md)
assert NBUCK % (SEG * BLOCK) == 0 and NBUCK // (SEG * BLOCK) <= BLOCK

_FN = {}


def _fns():
    if not _FN:
        lib = build.lib("msm")
        _FN["sums"] = build.bind(lib, "quill_msm_bucket_sums", [
            build.VP, build.VP, build.VP, build.I64, build.I32, build.I64,
            build.VP, build.VP, build.VP, build.VP])
        _FN["reduce"] = build.bind(lib, "quill_msm_bucket_reduce", [
            build.VP, build.I32, build.I32, build.I32, build.VP, build.VP,
            build.VP])
    return _FN


@dataclass
class TorchBasis:
    """CRS points on the device: (n, 2, 8) affine Fq Montgomery rows and an
    (n,) infinity mask (infinity rows hold (0, 0)).  A slice keeps the
    basis it was cut from as `root`; the small-MSM route caches its shifted
    bases per CRS chunk on the root (`shifted`), so slices share them."""

    xy: torch.Tensor
    inf: torch.Tensor
    length: int
    root: "TorchBasis | None" = None
    shifted: dict = field(default_factory=dict)


def load_basis(affines: list, device) -> TorchBasis:
    xy, inf = ed.affines_to_tensor(affines, device)
    return TorchBasis(xy=xy.contiguous(), inf=inf, length=len(affines))


def slice_basis(basis: TorchBasis, n: int) -> TorchBasis:
    n = min(n, basis.length)
    return TorchBasis(xy=basis.xy[:n], inf=basis.inf[:n], length=n,
                      root=basis.root or basis)


# ---------------------------------------------------------------------------
# digits and sorted entries (torch ops)
# ---------------------------------------------------------------------------


def signed_digits(s: torch.Tensor) -> torch.Tensor:
    """(n, 8) canonical scalars -> (n, 16) int64 signed digits."""
    v = s.to(torch.int64) & 0xFFFFFFFF
    u = torch.stack((v & 0xFFFF, v >> 16), -1).reshape(s.shape[0], NWIN)
    out = torch.empty_like(u)
    carry = torch.zeros_like(u[:, 0])
    for w in range(NWIN):
        t = u[:, w] + carry
        neg = (t >= (1 << (WBITS - 1))).to(torch.int64)
        out[:, w] = t - (neg << WBITS)
        carry = neg
    return out


def sorted_entries(digits: torch.Tensor, inf: torch.Tensor):
    """-> (keys, entries): int32 keys window * 2^15 + |d| - 1 in sorted
    order, int32 entries point * 2 + sign in the same order."""
    n = digits.shape[0]
    dev = digits.device
    win = torch.arange(NWIN, dtype=torch.int64, device=dev)
    keys = win.unsqueeze(0) * NBUCK + digits.abs() - 1
    pt = torch.arange(n, dtype=torch.int64, device=dev).unsqueeze(1)
    ent = pt * 2 + (digits < 0).to(torch.int64)
    valid = (digits != 0) & ~inf.unsqueeze(1)
    keys, ent = keys[valid].to(torch.int32), ent[valid]
    keys, perm = torch.sort(keys)
    return keys, ent[perm].to(torch.int32)


# ---------------------------------------------------------------------------
# kernel C: bucket sums
# ---------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"MSM kernel input: {what}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def entries_a_thread(n: int) -> int:
    """Kernel C's K for n sorted entries: the power of two in [K_MIN, K_MAX]
    nearest n / 2^15, so about 2^15 threads (two thirds of a wave of the
    H100 at 384 threads an SM); the fastest measured from 2^17 to 2^22
    points (PERF.md), while a sparse MSM keeps enough threads."""
    k = K_MIN
    while k < K_MAX and 3 * k << 14 <= n:        # n >= 1.5 k 2^15
        k *= 2
    return k


def bucket_sums(xy, keys, entries, plain: bool = False,
                test_k: int | None = None):
    """Sorted keys and entries (`sorted_entries`) against the (n, 2, 8)
    affine basis -> (NWIN * NBUCK, 3, 8) bucket sums, the identity where no
    entry falls.  Kernel C: a thread sums `entries_a_thread` consecutive
    entries; a fixed number of launches, nothing read back.  `plain` runs
    the plain twin whatever the device.  `test_k`, a hook for the card
    tests and `probe_msm --sweep`, sets the entries a thread instead."""
    if plain or not xy.is_cuda:
        return bucket_sums_plain(xy, keys, entries)
    _require(xy.dtype == torch.int32 and xy.is_contiguous()
             and xy.shape[1:] == (2, fd.NLIMB), "basis must be (n, 2, 8)")
    for t in (keys, entries):
        _require(t.is_cuda and t.dtype == torch.int32 and t.is_contiguous(),
                 "keys and entries must be contiguous int32 on CUDA")
    _require(keys.shape == entries.shape, "keys and entries differ in length")
    n = keys.shape[0]
    k = entries_a_thread(n) if test_k is None else test_k
    _require(k >= 1, "k must be positive")
    n1 = _cdiv(_cdiv(n, k), BLOCK)                  # the blocks' items
    m = n1 + _cdiv(n1, BLOCK) + 1
    dev = xy.device
    dense = torch.empty((NWIN * NBUCK, 3, fd.NLIMB), dtype=torch.int32,
                        device=dev)
    meta = torch.empty((m, 2), dtype=torch.int32, device=dev)
    pts = torch.empty((m, 2, 3, fd.NLIMB), dtype=torch.int32, device=dev)
    rc = _fns()["sums"](xy.data_ptr(), keys.data_ptr(), entries.data_ptr(), n,
                     k, NWIN * NBUCK, dense.data_ptr(), meta.data_ptr(),
                     pts.data_ptr(), build.stream_ptr())
    build.check(rc, "msm_bucket_sum")
    build.count("msm_bucket_sum")
    return dense


def bucket_sums_plain(xy, keys, entries):
    """The same sums: signed points summed by a pairwise tree within each
    run of equal keys (`segment_sums_w`), scattered into identities."""
    dense = ed.identity(NWIN * NBUCK, xy.device)
    if keys.numel() == 0:
        return dense
    e = entries.to(torch.int64)
    pts = ed.neg_y_w(fd.to_w16(xy[e >> 1]), (e & 1).bool())
    uniq, sums = segment_sums_w(keys, ed.affine_to_proj_w(pts))
    dense[uniq.to(torch.int64)] = fd.from_w16(sums)
    return dense


# ---------------------------------------------------------------------------
# kernel D: per-window bucket reduce
# ---------------------------------------------------------------------------


def bucket_reduce(buckets: torch.Tensor) -> torch.Tensor:
    """(NWIN * NBUCK, 3, 8) dense buckets (bucket i of a window holds digit
    i + 1) -> (NWIN, 3, 8) window sums sum_i (i + 1) B_i.  Kernel D: a
    thread reduces SEG buckets, a block and then a window combine them."""
    if not buckets.is_cuda:
        return bucket_reduce_plain(buckets)
    _require(buckets.dtype == torch.int32 and buckets.is_contiguous()
             and buckets.shape == (NWIN * NBUCK, 3, fd.NLIMB),
             "buckets must be contiguous (16 * 2^15, 3, 8) int32")
    dev = buckets.device
    xy = torch.empty((NWIN * (NBUCK // (SEG * BLOCK)), 2, 3, fd.NLIMB),
                     dtype=torch.int32, device=dev)
    out = torch.empty((NWIN, 3, fd.NLIMB), dtype=torch.int32, device=dev)
    rc = _fns()["reduce"](buckets.data_ptr(), NWIN, NBUCK, SEG,
                          xy.data_ptr(), out.data_ptr(), build.stream_ptr())
    build.check(rc, "msm_bucket_reduce")
    build.count("msm_bucket_reduce")
    return out


def segment_sums_w(keys: torch.Tensor, pts: torch.Tensor):
    """Sorted keys and w16 points -> (unique keys, one sum per key), by a
    pairwise tree inside every run of equal keys."""
    uniq, inv, counts = torch.unique_consecutive(
        keys, return_inverse=True, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(keys.shape[0], device=keys.device) - start[inv]
    run_len = counts[inv]
    x = pts.clone()
    step = 1
    while step < int(counts.max()):
        sel = torch.nonzero((rank % (2 * step) == 0)
                            & (rank + step < run_len)).flatten()
        x[sel] = ed.padd_w(x[sel], x[sel + step])
        step *= 2
    return uniq, x[start]


def _tree_sum_w(g: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over dim 1 (a power of two) of (m, k, 3, 16) points."""
    while g.shape[1] > 1:
        half = g.shape[1] // 2
        g = ed.padd_w(g[:, :half], g[:, half:])
    return g[:, 0]


def bucket_reduce_plain(buckets: torch.Tensor) -> torch.Tensor:
    """The same sums, over the occupied buckets only.  Each term v P (v =
    i + 1, 16 bits, at bit position 0) is split three times: into its two
    bytes, each byte into its two nibbles, each nibble into its bits.  A
    split turns a term into one entry per nonzero digit (the digit is its
    new weight, its bit position moves up by the digit's offset), and one
    segmented sum adds the entries of equal (window, position, weight), so
    each stage costs about as many adds as there are occupied groups.  What
    is left is one point H_b per window and bit position b, weight 1; a
    doubling ladder scales every H_b by 2^b at once."""
    dev = buckets.device
    occ = torch.nonzero((buckets[:, 2] != 0).any(-1)).flatten()
    if occ.numel() == 0:
        return ed.identity(NWIN, dev)
    win = occ // NBUCK
    pos = torch.zeros_like(occ)
    weight = occ % NBUCK + 1
    pts = fd.to_w16(buckets[occ])
    for width, ndig in ((8, 2), (4, 2), (1, 4)):
        offs = width * torch.arange(ndig, device=dev)
        digit = (weight.unsqueeze(1) >> offs) & ((1 << width) - 1)
        row, j = torch.nonzero(digit, as_tuple=True)
        keys = ((win[row] * WBITS + pos[row] + offs[j]) << width) \
            | digit[row, j]
        keys, order = torch.sort(keys)
        keys, pts = segment_sums_w(keys, pts[row[order]])
        win, pos = (keys >> width) // WBITS, (keys >> width) % WBITS
        weight = keys & ((1 << width) - 1)
    h = ed.identity_w((NWIN * WBITS,), dev)
    h[win * WBITS + pos] = pts
    h = h.view(NWIN, WBITS, 3, fd.NW)
    for b in range(1, WBITS):
        h[:, b:] = ed.padd_w(h[:, b:], h[:, b:])
    return fd.from_w16(_tree_sum_w(h))


# ---------------------------------------------------------------------------
# the MSM
# ---------------------------------------------------------------------------


def dense_buckets(basis: TorchBasis, scalars: torch.Tensor,
                  plain: bool = False):
    """Digits, sort and kernel C: -> (NWIN * NBUCK, 3, 8) buckets, or None
    when every digit is zero.  Nothing is read back after the sort."""
    n = min(basis.length, scalars.shape[0])
    if n == 0:
        return None
    digits = signed_digits(fd.from_mont(scalars[:n], FR))
    keys, entries = sorted_entries(digits, basis.inf[:n])
    if keys.numel() == 0:
        return None
    return bucket_sums(basis.xy[:n].contiguous(), keys, entries, plain)


def window_sums(basis: TorchBasis, scalars: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """(n, 8) Montgomery Fr scalars against the first n basis points ->
    (NWIN, 3, 8) projective window sums."""
    dense = dense_buckets(basis, scalars, plain)
    if dense is None:
        return ed.identity(NWIN, basis.xy.device)
    return bucket_reduce_plain(dense) if plain else bucket_reduce(dense)


def combine_windows(wsums: torch.Tensor) -> curve.Jacobian:
    """sum_w 2^(16 w) W_w on the host."""
    jac = ed.proj_to_jacobians(wsums)
    acc = jac[-1]
    for w in range(NWIN - 2, -1, -1):
        for _ in range(WBITS):
            acc = acc.double()
        acc = acc.add(jac[w])
    return acc


def msm(basis: TorchBasis, scalars: torch.Tensor,
        plain: bool = False) -> curve.Jacobian:
    return combine_windows(window_sums(basis, scalars, plain))
