"""The v6 MSM route: one global sort over a flat 16-window space, a binary
tree over the sorted leaves and Fenwick prefix queries; kernel K (the
leaf-level kernel it shares with kernel F, `csrc/msm5.cu` + `csrc/tree.cuh`)
and its plain PyTorch twin, with kernels E, G and the fused top for the
projective adds.

Counterpart of `quill_tpu/ec/msm6.py` and `quill_tpu/ec/msm6k.py`, the
route `QUILL_MSM_IMPL=6` gives the JAX engine (`TorchEngine(msm_impl="6")`
here) for bases of more than `msm_small_chunks` chunks of 2^16 points and
at most `msm_shift_max` points.  One MSM over n points:

1. digits: 16 unsigned 16-bit digits of each canonical scalar
   (`msm6.py:112-137`), digit 0 where the basis point is at infinity.
   Element (w, i) sits at w * n + i of a flat space padded with digit-0
   elements to FL = 16 * next_pow2(n) (the JAX package pads to whole chunks
   of 2^16 points, `msm6.py:426-435`; a digit-0 element has coefficient 0
   in step 6, so both give the same sum, and this keeps small MSMs small);
2. shifted basis (`msm6.py:157-328`): window w holds 2^(16 w) P_i as affine
   points, points at infinity replaced by the generator, built once per
   root basis by 15 rounds of 16 doublings and a normalisation in kernel
   E's shifted-basis launch (`msm5.shifted_basis`), and extended when a
   wider MSM needs more points, in one launch over the new points.  The
   JAX package builds a tau CRS's by fixed-base products instead
   (`:258-303`; the same points) and keeps a disk cache (`:205-256`), which
   the port does not;
3. one `torch.sort` of the FL keys, and idx[p], the shifted-basis row of the
   element at sorted position p, pad elements clamped to the last real one
   (`msm6.py:358-372`);
4. tree: node s of level k is the sum of the sorted leaves
   [s 2^k, (s + 1) 2^k).  Kernel K builds level 1 from the shifted basis
   through idx, kernel G the levels above from adjacent pairs, two a launch,
   up to a top level of at most MIN_TOP = 512 nodes (the JAX package's
   `_MIN_H` is 1024); every level is kept.  The JAX
   package lays the leaves out in bit-reversed order (`msm6.py:346-355`)
   only so that its Pallas blocks pair contiguous halves, and gathers them
   into a leaf array first (`_k_sort_gather`); kernel K gathers them itself;
5. queries (`msm6k.py:137-249`): the inclusive prefix sums of the top level
   (the fused top's tree mode, one launch), then, for every bucket
   b < 2^16 - 1, the sum P[c_b] of the first c_b sorted leaves, c_b the
   number of keys <= b: the top prefix gives its coarse part, and one level
   at a time from the top down a node is added where bit k of c_b is set,
   all in kernel E's one walk launch (`csrc/query.cuh`).  The plain twins
   run the chain the port ran before: Hillis-Steele prefix sums (`prefix`)
   and one flagged kernel E launch a level with plain-torch gathers
   (`queries`);
6. reduce and finalize (`msm6k.py:255-279`, `msm6.py:396-420`): the
   2^16 - 1 query results and one identity summed by halving (the fused
   top's reduce mode, `msm5.tree_reduce`),
   and on the host (2^16 - 1) T - S with T the sum of all leaves: the sum
   over b of T - P[c_b] counts a leaf of digit d exactly d times.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import device as fd
from ..fields.device import FQ, FR
from ..kernels import build
from . import curve
from . import device as ed
from . import msm5
from .msm import TorchBasis

WBITS = 16
NWIN = 16
NBUCK = 1 << WBITS
NQ = NBUCK - 1             # bucket queries, b = 0 .. 2^16 - 2
# the widest top level of the tree: the fused top's width (`msm5.TOP`),
# which takes its prefixes in one launch; the JAX package's `_MIN_H` is
# 1024, one level less (the same points)
MIN_TOP = msm5.TOP
CHUNK = msm5.CHUNK         # the shifted basis grows by whole chunks
CACHE_KEY = "v6"           # of the shifted basis in TorchBasis.shifted

# ---------------------------------------------------------------------------
# kernel K: the affine level 0
# ---------------------------------------------------------------------------


def level0(sh, idx):
    """Kernel K: an (r, 2, 8) affine shifted basis and (2k,) int32 rows of
    it in sorted order -> (k, 3, 8) level 1, o[j] = sh[idx[2j]] +
    sh[idx[2j + 1]] (9 products, Z = 1): kernel F's launch
    (`msm5.leaf_level`), counted as `msm6_level0`.  Every idx entry must be
    below r: the kernel does not check, and a row out of range faults on
    the card."""
    if not sh.is_cuda:
        return level0_plain(sh, idx)
    return msm5.leaf_level(sh, idx, "msm6_level0")


def level0_plain(sh, idx):
    return msm5.tree_up0_plain(sh, idx)


# ---------------------------------------------------------------------------
# digits, shifted basis, sort
# ---------------------------------------------------------------------------


def digits16(s):
    """(n, 8) canonical scalars -> (n, 16) int32 unsigned 16-bit digits."""
    v = s.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack((v & 0xFFFF, v >> 16), -1)
    return d.reshape(s.shape[0], NWIN).to(torch.int32)


def shifted(basis: TorchBasis, n: int):
    """The v6 shifted basis over at least the root's first n points:
    (16, m, 2, 8) affine, m >= n, row (w, i) holding 2^(16 w) P_i (the
    generator's multiple where P_i is at infinity).  Cached on the root;
    a wider MSM extends it to whole chunks of CHUNK points, all its new
    points in one kernel E launch (`msm5.shifted_basis`)."""
    root = basis.root or basis
    have = root.shifted.get(CACHE_KEY)
    m = 0 if have is None else have.shape[1]
    if m >= n:
        return have
    hi = min(root.length, -(-n // CHUNK) * CHUNK)
    new = msm5.shifted_basis(root.xy[m:hi], root.inf[m:hi], NWIN, WBITS)
    new = new.reshape(NWIN, hi - m, 2, fd.NLIMB)
    sh = new if have is None else torch.cat((have, new), 1)
    root.shifted[CACHE_KEY] = sh
    return sh


def sort_keys(canon, inf, width: int):
    """(n, 8) canonical scalars and their basis points' (n,) infinity mask
    -> (keys, idx), both (16 * next_pow2(n),) int32: the sorted digits and
    the row of each sorted element in a shifted basis of `width` points a
    window."""
    n = canon.shape[0]
    real = NWIN * n
    fl = NWIN << max(0, n - 1).bit_length()
    d = digits16(canon).masked_fill(inf[:n, None], 0)
    keys = torch.zeros(fl, dtype=torch.int32, device=canon.device)
    keys[:real] = d.T.reshape(-1)
    keys, perm = torch.sort(keys)
    perm = perm.clamp(max=real - 1)
    rows = (perm // n) * width + perm % n
    return keys, rows.to(torch.int32)


# ---------------------------------------------------------------------------
# tree, queries, reduce
# ---------------------------------------------------------------------------


def tree(sh, idx) -> list:
    """Kernel K, then kernel G two levels a launch (one where a single level
    reaches the top) -> [level 1, ..., top], the top level at most MIN_TOP
    nodes wide."""
    levels = [level0(sh, idx)]
    while levels[-1].shape[0] > MIN_TOP:
        if levels[-1].shape[0] > 2 * MIN_TOP:
            levels += msm5.tree_up2(levels[-1])
        else:
            levels.append(msm5.tree_up(levels[-1]))
    return levels


def prefix(x):
    """Inclusive prefix sums of (h, 3, 8) points: Hillis-Steele, one kernel
    E launch a step.  The plain reference of the fused top's tree mode,
    which `msm` takes for the top level (`msm5.tree_top`; other triples,
    the same points); nothing on a card path calls it."""
    step = 1
    while step < x.shape[0]:
        x = torch.cat((x[:step], msm5.pt_add(x[:-step], x[step:])), 0)
        step *= 2
    return x


def add_where(node, acc, has):
    """has ? node + acc : acc, kernel E's flagged mode (flags = ~has); on
    the CPU `add_where_plain`."""
    if acc.is_cuda:
        return msm5.pt_add(node.contiguous(), acc, ~has)
    return add_where_plain(node, acc, has)


def add_where_plain(node, acc, has):
    """`add_where` by the plain twin, adding only the rows where `has` is
    set."""
    out = acc.clone()
    sel = torch.nonzero(has).flatten()
    out[sel] = msm5.pt_add_plain(node[sel], acc[sel])
    return out


def queries(cnt, sh, idx, levels, top, plain=False):
    """(NQ,) counts c_b -> (NQ, 3, 8) prefixes P[c_b], from the kept levels
    (levels[k - 1] is level k), their top's prefix sums `top`, and the
    leaves read through idx with Z = 1: one flagged kernel E launch a
    level, with plain-torch gathers between them.  The plain twin of
    `query_walk` (the same triples); nothing on a card path calls it."""
    dev = cnt.device
    kmin = len(levels)
    q = cnt >> kmin
    acc = torch.where((q > 0)[:, None, None], top[(q - 1).clamp(min=0)],
                      ed.identity(1, dev))
    offset = q << kmin
    for k in range(kmin - 1, -1, -1):
        has = ((cnt >> k) & 1).bool()
        if k:
            lvl = levels[k - 1]
            node = lvl[(offset >> k).clamp(max=lvl.shape[0] - 1)]
        else:
            leaf = sh[idx[offset.clamp(max=idx.shape[0] - 1)].to(torch.int64)]
            one = fd.const(1, FQ, dev).expand(cnt.shape[0], 1, fd.NLIMB)
            node = torch.cat((leaf, one), 1)
        acc = (add_where_plain if plain else add_where)(node, acc, has)
        offset = offset + (has.to(offset.dtype) << k)
    return acc


def query_walk(cnt, sh, idx, levels, top):
    """Kernel E's walk mode: `queries` in one launch (`csrc/query.cuh`), a
    bucket to a thread.  cnt: (nq,) int64 counts, each at most idx's
    length."""
    if not cnt.is_cuda:
        return queries(cnt, sh, idx, levels, top)
    kmin = len(levels)
    msm5._require(cnt.dtype == torch.int64 and cnt.is_contiguous()
                  and cnt.dim() == 1, "cnt must be a contiguous (nq,) int64 "
                  "tensor")
    msm5._require(1 <= kmin <= 41, "1 to 41 levels")
    for t, what in [(top, "top")] + [(lv, "a level") for lv in levels]:
        msm5._check_tree(t, what)
    msm5._check_points(sh, 2, "sh")
    msm5._require(sh.data_ptr() % 16 == 0 and idx.is_cuda
                  and idx.dtype == torch.int32 and idx.is_contiguous(),
                  "sh must be 16-byte aligned, idx contiguous int32 on CUDA")
    ptrs = (ctypes.c_uint64 * max(kmin - 1, 1))(
        *[lv.data_ptr() for lv in levels[:-1]])
    nq = cnt.shape[0]
    out = msm5._out(nq, top)
    rc = msm5._fns()["walk"](cnt.data_ptr(), nq, top.data_ptr(), ptrs, kmin,
                             sh.data_ptr(), idx.data_ptr(), out.data_ptr(),
                             build.stream_ptr())
    build.check(rc, "msm5_query_walk")
    build.count("msm5_query_walk")
    return out


def reduce_sum(x):
    """(2^j, 3, 8) points -> (1, 3, 8) their sum by halving: the fused top's
    reduce mode (`msm5.tree_reduce`)."""
    return msm5.tree_reduce(x, x.shape[0])


def msm(basis: TorchBasis, scalars: torch.Tensor) -> curve.Jacobian:
    """(n, 8) Montgomery Fr scalars against the basis's first n points."""
    n = min(basis.length, scalars.shape[0])
    if n == 0:
        return curve.Jacobian.identity(curve.Fq(1))
    dev = basis.xy.device
    sh = shifted(basis, n)
    canon = fd.from_mont(scalars[:n], FR)
    keys, idx = sort_keys(canon, basis.inf, sh.shape[1])
    b = torch.arange(NQ, dtype=torch.int32, device=dev)
    cnt = torch.searchsorted(keys, b, right=True)
    del keys
    flat = sh.reshape(-1, 2, fd.NLIMB)
    levels = tree(flat, idx)
    top = msm5.tree_top(levels[-1])
    acc = query_walk(cnt, flat, idx, levels, top)
    del levels
    s_sum = reduce_sum(torch.cat((acc, ed.identity(1, dev)), 0))
    s_pt, t_pt = ed.proj_to_jacobians(torch.cat((s_sum, top[-1:]), 0))
    return t_pt.scalar_mul(NQ).add(s_pt.neg())
