"""The small-MSM route: a shifted basis and a prefix tree, kernels E to H
(`csrc/msm5.cu`) and their plain PyTorch twins.

Counterpart of `quill_tpu/ec/msm5.py` and of the parts of
`quill_tpu/ec/msm3.py` it shares.  The TPU build laid the tree out as
(S=256, 3L, M) tiles, fused its top levels and ran a Hillis-Steele ladder
over the lanes, all to save TPU dispatches; here the tree is one flat
sequence of `(n, 3, 8)` int32 Montgomery points, two levels a launch
through shared memory and its top in one block (`csrc/tree.cuh`).
For B MSMs over one CRS chunk of n <= 2^16 points:

1. digits: 20 unsigned 13-bit windows per scalar
   (`quill_tpu/ec/msm.py:131 _extract_digits`); digits of basis points at
   infinity are forced to 0 (`msm5.py:177`);
2. shifted basis: window w holds 2^(13 w) G_i as an affine point, points
   at infinity replaced by the generator (`msm5.py:24-29`): 19 rounds of
   13 doublings and a normalisation, all inside kernel E's one shifted-
   basis launch (`csrc/ladder.cuh`: one thread a point, Montgomery's
   trick over its own windows) for every chunk a call needs.  It is cached
   per CRS chunk on the root basis, so slices share it;
3. leaves: every (MSM b, window w, point i) is keyed b * 8192 + digit, one
   stable `torch.sort` orders the B * 20 * n keys, and the leaves are the
   shifted affine points in that order, read through their rows idx (the
   JAX package gathers them into a leaf array first; kernel F gathers them
   itself);
4. prefix tree (`msm3.py:395 _tree(full=False)`, `msm5.py:288 _tree5`):
   kernel F adds affine leaf pairs, kernel G adds the projective levels up
   two a launch (odd levels padded with the identity) until one holds at
   most TOP points, the fused top takes that level up to one point and
   back down, and kernel H expands the levels below it two a launch,
   stopping at the pair level: I1[j] = P[2j + 1], P the inclusive prefix
   sums of the leaves.  Every triple is the one the chain of one-level
   plain twins gives (`prefix_tree_chain`);
5. collect (`msm3.py:490 _cgather_fn`, `msm5.py:308`): since G1 is a group
   the Pippenger sum telescopes, sum_d d B_d = 8191 P[e_8191] -
   sum_{c < 8191} P[e_c] with e_c the last sorted position whose key is
   at most b * 8192 + c (a digit-0 leaf, and every leaf of an earlier MSM,
   cancels).  Prefixes at even positions are I1 minus the next leaf; the
   2 * 8191 terms of each MSM are summed pairwise by the fused top's
   reduce mode;
6. finalize on the host (`msm3.py:587 _finalize_host`): 8191 T_b - S_b.

The JAX package builds the shifted basis of a tau-powers CRS with a
fixed-base generator instead (`msm3.py:140-191`); the points are the same.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.device import FQ, FR
from ..kernels import build
from ..utils.profiling import phase
from . import curve
from . import device as ed
from .msm import TorchBasis

WBITS = 13
NWIN = 20                  # ceil(254 / 13)
NBUCK = 1 << WBITS
CHUNK = 1 << 16            # CRS points per shifted-basis chunk
# `csrc/tree.cuh: TREE_TOP` (tests/test_torch_tree_blocked.py holds this
# copy to it), the widest level the fused top takes; at least 2, so that a
# two-level launch never goes past the single point
TOP = 512
# `csrc/tree.cuh: TREE_LANE_LEVEL` (held to it by the same test): two-level
# launches over at most this many points give an add to six lanes
LANE_LEVEL = 1 << 16
# kernel E's adds go one a group of six lanes up to this many points (one a
# thread above it): on an H100 (PERF.md, PR 11) lanes took 1.5x the time
# of threads at 2^16 points, and from 2^8 to 2^14 both were within the
# ~20-30 us of a launch from Python
ADD_LANE_MAX = 1 << 10

_FN = {}


def _fns():
    if not _FN:
        lib = build.lib("msm5")
        vp, i64 = build.VP, build.I64
        _FN["add"] = build.bind(lib, "quill_pt_add",
                                [vp, vp, vp, i64, build.I32, vp, vp])
        _FN["walk"] = build.bind(lib, "quill_query_walk",
                                 [vp, i64, vp, vp, build.I32, vp, vp, vp,
                                  vp])
        _FN["dbl"] = build.bind(lib, "quill_pt_dbl",
                                [vp, i64, build.I32, vp, vp])
        _FN["shifted"] = build.bind(
            lib, "quill_shifted_basis",
            [vp, vp, i64, i64, build.I32, build.I32, vp, vp, vp])
        _FN["leaf"] = build.bind(lib, "quill_tree_leaf",
                                 [vp, vp, i64, vp, vp])
        _FN["up"] = build.bind(lib, "quill_tree_up", [vp, i64, vp, vp])
        _FN["up2"] = build.bind(lib, "quill_tree_up2",
                                [vp, i64, vp, vp, vp])
        _FN["down"] = build.bind(lib, "quill_tree_down",
                                 [vp, vp, i64, vp, vp])
        _FN["down2"] = build.bind(lib, "quill_tree_down2",
                                  [vp, vp, vp, i64, vp, vp])
        _FN["top"] = build.bind(lib, "quill_tree_top",
                                [vp, build.I32, vp, vp])
        _FN["reduce"] = build.bind(lib, "quill_tree_reduce",
                                   [vp, i64, build.I32, vp, vp])
    return _FN


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"small-MSM kernel input: {what}")


def _check_points(t: torch.Tensor, coords: int, what: str) -> None:
    _require(t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()
             and t.dim() == 3 and t.shape[1:] == (coords, fd.NLIMB),
             f"{what} must be contiguous (n, {coords}, 8) int32 on CUDA")


def _check_tree(t: torch.Tensor, what: str) -> None:
    """Kernels G and H copy 16-byte pieces."""
    _check_points(t, 3, what)
    _require(t.data_ptr() % 16 == 0, f"{what} must be 16-byte aligned")


def _out(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((n, 3, fd.NLIMB), dtype=torch.int32,
                       device=like.device)


# ---------------------------------------------------------------------------
# kernel E: elementwise add, and the flagged combine
# ---------------------------------------------------------------------------


def pt_add(a, b, flags=None, lanes=None):
    """Kernel E: a + b for (n, 3, 8) points, elementwise; with an (n,)
    bool `flags`, fb ? b : a + b (`seg_combine_stacked`).  One add a group
    of six lanes for at most ADD_LANE_MAX points (`lanes` None), else one a
    thread; either way staged through shared memory, the same triples."""
    if not a.is_cuda:
        return pt_add_plain(a, b, flags)
    _check_tree(a, "a")
    _check_tree(b, "b")
    _require(a.shape == b.shape, "a and b differ in shape")
    if flags is not None:
        _require(flags.is_cuda and flags.dtype == torch.bool
                 and flags.is_contiguous() and flags.shape == a.shape[:1],
                 "flags must be a contiguous (n,) bool tensor on CUDA")
    n = a.shape[0]
    lanes = n <= ADD_LANE_MAX if lanes is None else lanes
    out = _out(n, a)
    rc = _fns()["add"](a.data_ptr(), b.data_ptr(),
                       None if flags is None else flags.data_ptr(), n,
                       int(lanes), out.data_ptr(), build.stream_ptr())
    build.check(rc, "msm5_pt_add")
    build.count("msm5_pt_add")
    return out


def pt_add_plain(a, b, flags=None):
    out = fd.from_w16(ed.padd_w(fd.to_w16(a), fd.to_w16(b)))
    if flags is not None:
        out = torch.where(flags[:, None, None], b, out)
    return out


def pt_dbl(p, k: int = 1):
    """Kernel E's doubling: 2^k p for (n, 3, 8) points, k doublings
    (`bn254.cuh: g1_dbl`) in one launch."""
    if not p.is_cuda:
        return pt_dbl_plain(p, k)
    _check_points(p, 3, "p")
    _require(k >= 0, "k must be >= 0")
    out = _out(p.shape[0], p)
    rc = _fns()["dbl"](p.data_ptr(), p.shape[0], k, out.data_ptr(),
                       build.stream_ptr())
    build.check(rc, "msm5_pt_dbl")
    build.count("msm5_pt_dbl")
    return out


def pt_dbl_plain(p, k: int = 1):
    w = fd.to_w16(p)
    for _ in range(k):
        w = ed.pdbl_w(w)
    return fd.from_w16(w)


# ---------------------------------------------------------------------------
# kernels F, G, H: the prefix tree's levels
# ---------------------------------------------------------------------------


def leaf_level(sh, idx, counter: str):
    """Kernels F and K, one kernel: an (r, 2, 8) affine basis and (2k,)
    int32 rows of it (None: rows 0 .. 2k - 1, contiguous leaves) -> (k, 3,
    8) pair sums o[j] = sh[idx[2j]] + sh[idx[2j + 1]] (9 products, Z = 1),
    gathered in the kernel.  `counter` names the caller's launch count.
    Every idx entry must be below r: the kernel does not check, and a row
    out of range faults on the card."""
    _check_points(sh, 2, "sh")
    _require(sh.data_ptr() % 16 == 0, "sh must be 16-byte aligned")
    if idx is None:
        _require(sh.shape[0] % 2 == 0, "odd number of leaves")
        k = sh.shape[0] // 2
    else:
        _require(idx.is_cuda and idx.dtype == torch.int32
                 and idx.is_contiguous() and idx.dim() == 1
                 and idx.shape[0] % 2 == 0,
                 "idx must be a contiguous (2k,) int32 tensor on CUDA")
        k = idx.shape[0] // 2
    out = _out(k, sh)
    rc = _fns()["leaf"](sh.data_ptr(), None if idx is None else idx.data_ptr(),
                        k, out.data_ptr(), build.stream_ptr())
    build.check(rc, counter)
    build.count(counter)
    return out


def tree_up0(sh, idx=None):
    """Kernel F: the small route's leaf level, `leaf_level` on the shifted
    basis and the sort's rows (idx None: sh holds the 2k leaves)."""
    if not sh.is_cuda:
        return tree_up0_plain(sh, idx)
    return leaf_level(sh, idx, "msm5_tree_up0")


def tree_up0_plain(sh, idx=None):
    """The leaves gathered (sh[idx]), then each pair added."""
    leaves = sh if idx is None else sh[idx.to(torch.int64)]
    w = fd.to_w16(leaves)
    return fd.from_w16(ed.aadd_w(w[0::2], w[1::2]))


def tree_up(x):
    """Kernel G, one level: (2k, 3, 8) -> (k, 3, 8), o[j] = x[2j] +
    x[2j+1]."""
    if not x.is_cuda:
        return tree_up_plain(x)
    _check_tree(x, "x")
    _require(x.shape[0] % 2 == 0, "odd number of points")
    k = x.shape[0] // 2
    out = _out(k, x)
    rc = _fns()["up"](x.data_ptr(), k, out.data_ptr(), build.stream_ptr())
    build.check(rc, "msm5_tree_up")
    build.count("msm5_tree_up")
    return out


def tree_up_plain(x):
    w = fd.to_w16(x)
    return fd.from_w16(ed.padd_w(w[0::2], w[1::2]))


def _pad(x):
    """An odd level padded with the identity (0 : 1 : 0)."""
    if x.shape[0] % 2 == 0:
        return x
    return torch.cat((x, ed.identity(1, x.device)), 0)


def _half(m: int) -> int:
    return (m + 1) // 2


def tree_up2(x):
    """Kernel G, two levels: level l (m, 3, 8) -> (level l + 1, level l +
    2), (ceil(m / 2), 3, 8) and (ceil(m / 4), 3, 8), each odd level padded
    with the identity before its pairs are added."""
    if not x.is_cuda:
        return tree_up2_plain(x)
    _check_tree(x, "x")
    m = x.shape[0]
    _require(m >= 1, "an empty level")
    o1, o2 = _out(_half(m), x), _out(_half(_half(m)), x)
    rc = _fns()["up2"](x.data_ptr(), m, o1.data_ptr(), o2.data_ptr(),
                       build.stream_ptr())
    build.check(rc, "msm5_tree_up2")
    build.count("msm5_tree_up")
    return o1, o2


def tree_up2_plain(x):
    a = tree_up_plain(_pad(x))
    return a, tree_up_plain(_pad(a))


def tree_down(i, u):
    """Kernel H, one level: prefixes i (k, 3, 8) of a level and the level
    below it u (2k, 3, 8) -> that level's prefixes (2k, 3, 8): o[2j+1] =
    i[j], o[2j] = i[j] - u[2j+1]."""
    if not i.is_cuda:
        return tree_down_plain(i, u)
    _check_tree(i, "i")
    _check_tree(u, "u")
    _require(u.shape[0] == 2 * i.shape[0], "u must be twice as long as i")
    k = i.shape[0]
    out = _out(2 * k, i)
    rc = _fns()["down"](i.data_ptr(), u.data_ptr(), k, out.data_ptr(),
                        build.stream_ptr())
    build.check(rc, "msm5_tree_down")
    build.count("msm5_tree_down")
    return out


def tree_down_plain(i, u):
    neg = torch.ones(i.shape[0], dtype=torch.bool, device=i.device)
    even = ed.padd_w(fd.to_w16(i), ed.neg_y_w(fd.to_w16(u[1::2]), neg))
    out = torch.empty_like(u)
    out[0::2] = fd.from_w16(even)
    out[1::2] = i
    return out


def tree_down2(p, u1, u0):
    """Kernel H, two levels: the prefixes p of level l + 2 (at least
    ceil(m / 4) rows), level l + 1 u1 (ceil(m / 2), 3, 8) and level l u0
    (m, 3, 8), unpadded -> level l's prefixes (m, 3, 8)."""
    if not p.is_cuda:
        return tree_down2_plain(p, u1, u0)
    for t, what in ((p, "p"), (u1, "u1"), (u0, "u0")):
        _check_tree(t, what)
    m = u0.shape[0]
    _require(m >= 1 and u1.shape[0] == _half(m)
             and p.shape[0] >= _half(_half(m)),
             "u1 must have ceil(m / 2) rows and p at least ceil(m / 4)")
    out = _out(m, u0)
    rc = _fns()["down2"](p.data_ptr(), u1.data_ptr(), u0.data_ptr(), m,
                         out.data_ptr(), build.stream_ptr())
    build.check(rc, "msm5_tree_down2")
    build.count("msm5_tree_down")
    return out


def tree_down2_plain(p, u1, u0):
    m1 = u1.shape[0]
    p1 = tree_down_plain(p[:_half(m1)], _pad(u1))[:m1]
    return tree_down_plain(p1, _pad(u0))[:u0.shape[0]]


def tree_top(x):
    """The fused top, tree mode: a level x (w, 3, 8), 1 <= w <= TOP -> its
    prefixes (w, 3, 8), every level above it up and back down in one
    launch."""
    if not x.is_cuda:
        return tree_top_plain(x)
    _check_tree(x, "x")
    w = x.shape[0]
    _require(1 <= w <= TOP, f"the top takes 1 to {TOP} points")
    out = _out(w, x)
    rc = _fns()["top"](x.data_ptr(), w, out.data_ptr(), build.stream_ptr())
    build.check(rc, "msm5_tree_top")
    build.count("msm5_tree_top")
    return out


def tree_top_plain(x):
    return _chain(x, tree_up_plain, tree_down_plain)


def _chain(x, up, down):
    """The prefixes of level x one level a call: the odd levels padded, up
    to one point, then down."""
    w = x.shape[0]
    levels = []
    while x.shape[0] > 1:
        x = _pad(x)
        levels.append(x)
        x = up(x)
    for lvl in reversed(levels):
        x = down(x[:lvl.shape[0] // 2].contiguous(), lvl)
    return x[:w]


def tree_reduce(x, group: int):
    """The fused top, reduce mode: (k group, 3, 8) points, group a power of
    two -> (k, 3, 8), row g the pairwise sum of rows [g group, (g + 1)
    group): the one-level halving's triples, in ceil(log2(group) / 9)
    launches of spans of at most TOP points."""
    _require(group >= 1 and group & (group - 1) == 0
             and x.shape[0] % group == 0,
             "group must be a power of two that divides the rows")
    if not x.is_cuda:
        return tree_reduce_plain(x, group)
    _check_tree(x, "x")
    while group > 1:
        span = min(group, TOP)
        out = _out(x.shape[0] // span, x)
        rc = _fns()["reduce"](x.data_ptr(), out.shape[0], span,
                              out.data_ptr(), build.stream_ptr())
        build.check(rc, "msm5_tree_reduce")
        build.count("msm5_tree_reduce")
        x, group = out, group // span
    return x


def tree_reduce_plain(x, group: int):
    while group > 1:
        x, group = tree_up_plain(x), group // 2
    return x


# ---------------------------------------------------------------------------
# shifted basis
# ---------------------------------------------------------------------------


def shifted_basis(xy, inf, nwin: int = NWIN, wbits: int = WBITS,
                  chunk: int | None = None):
    """Kernel E's shifted basis: (n, 2, 8) affine points and their (n,)
    infinity mask -> (nwin * n, 2, 8) affine rows of 2^(wbits w) P_i (the
    generator's where P_i is at infinity), in chunks of `chunk` points
    (default: all n in one), each window-major: window w of point i sits
    at row c0 * nwin + w * nc + (i - c0), c0 the chunk's first point and nc
    its size.  One launch; nothing is read back."""
    n = xy.shape[0]
    chunk = n if chunk is None else chunk
    if not xy.is_cuda:
        return shifted_basis_plain(xy, inf, nwin, wbits, chunk)
    _check_points(xy, 2, "xy")
    _require(inf.is_cuda and inf.dtype == torch.bool and inf.is_contiguous()
             and inf.shape == (n,), "inf must be a contiguous (n,) bool "
             "tensor on CUDA")
    _require(xy.data_ptr() % 16 == 0 and chunk > 0 and nwin >= 1
             and wbits >= 0, "xy must be 16-byte aligned, chunk > 0, "
             "nwin >= 1 and wbits >= 0")
    out = torch.empty((nwin * n, 2, fd.NLIMB), dtype=torch.int32,
                      device=xy.device)
    scratch = torch.empty((max(nwin - 1, 1) * n, 2, fd.NLIMB),
                          dtype=torch.int32, device=xy.device)
    rc = _fns()["shifted"](xy.data_ptr(), inf.data_ptr(), n, chunk, nwin,
                           wbits, out.data_ptr(), scratch.data_ptr(),
                           build.stream_ptr())
    build.check(rc, "msm5_shifted_basis")
    build.count("msm5_shifted_basis")
    return out


def shifted_basis_plain(xy, inf, nwin: int = NWIN, wbits: int = WBITS,
                        chunk: int | None = None):
    """The plain twin of `shifted_basis`: per chunk, the doubling ladder
    and one batch normalisation."""
    n = xy.shape[0]
    chunk = n if chunk is None else chunk
    parts = []
    for lo in range(0, n, chunk):
        pts = base_points(xy[lo:lo + chunk], inf[lo:lo + chunk])
        lad = shift_ladder(pts, nwin, wbits).reshape(-1, 3, fd.NLIMB)
        parts.append(to_affine(lad))
    return torch.cat(parts, 0) if parts else xy.new_empty((0, 2, fd.NLIMB))


def base_points(xy, inf):
    """(n, 2, 8) affine points -> (n, 3, 8) projective with Z = 1, points at
    infinity replaced by the generator."""
    dev = xy.device
    g = curve.g1_affine_generator()
    gen = fd.from_ints([g.x.v, g.y.v], FQ, dev)
    xy = torch.where(inf[:, None, None], gen, xy)
    one = fd.const(1, FQ, dev).expand(xy.shape[0], 1, fd.NLIMB)
    return torch.cat((xy, one), 1).contiguous()


def shift_ladder(p, nwin: int = NWIN, wbits: int = WBITS):
    """(n, 3, 8) points -> (nwin, n, 3, 8), window w holding 2^(wbits w) p:
    nwin - 1 rounds of wbits plain doublings (`ec/device.py: pdbl_w`, the
    kernel's formula)."""
    w = fd.to_w16(p)
    wins = [w]
    for _ in range(nwin - 1):
        for _ in range(wbits):
            w = ed.pdbl_w(w)
        wins.append(w)
    return fd.from_w16(torch.stack(wins, 0))


def to_affine(p):
    """(n, 3, 8) projective points, none the identity -> (n, 2, 8) affine
    with one field inversion (`ec/fixed_base.py:158 _batch_normalize`)."""
    zinv = fd.to_w16(fd.batch_inverse(p[:, 2].contiguous(), FQ))
    xy = fd.w_mul(fd.to_w16(p[:, :2]), zinv.unsqueeze(1), FQ)
    return fd.from_w16(xy).contiguous()


def _chunk(root: TorchBasis, j: int) -> tuple:
    return j * CHUNK, min(root.length, (j + 1) * CHUNK)


def shifted(basis: TorchBasis, j: int):
    """The shifted basis of chunk j of the root basis: (NWIN * n, 2, 8)
    affine, window-major (row w * n + i holds 2^(13 w) G_i), cached on the
    root.  A miss builds chunk j and every later chunk the basis reaches in
    one launch, and caches each."""
    root = basis.root or basis
    if j not in root.shifted:
        last = max(j, -(-basis.length // CHUNK) - 1)
        lo, hi = _chunk(root, j)[0], _chunk(root, last)[1]
        sh = shifted_basis(root.xy[lo:hi], root.inf[lo:hi], chunk=CHUNK)
        off = 0
        for c in range(j, last + 1):
            rows = NWIN * (_chunk(root, c)[1] - _chunk(root, c)[0])
            root.shifted[c] = sh[off:off + rows]
            off += rows
    return root.shifted[j]


# ---------------------------------------------------------------------------
# digits, sort, tree, collect
# ---------------------------------------------------------------------------


def window_digits(s):
    """(n, 8) canonical scalars -> (n, NWIN) int64 unsigned 13-bit digits."""
    v = s.to(torch.int64) & 0xFFFFFFFF
    out = []
    for w in range(NWIN):
        limb, sh = divmod(w * WBITS, 32)
        d = v[:, limb] >> sh
        if sh + WBITS > 32 and limb + 1 < fd.NLIMB:
            d = d | (v[:, limb + 1] << (32 - sh))
        out.append(d & (NBUCK - 1))
    return torch.stack(out, 1)


def sort_leaves(scs, inf):
    """(B, n, 8) canonical scalars and the chunk's (n,) infinity mask ->
    (sorted keys, idx): leaf k is the element (b, w, i) of sorted position
    k, its key b * 8192 + digit, and idx[k] (int32) its row w * n + i of
    the chunk's (NWIN * n, 2, 8) shifted basis.  No leaf is gathered:
    kernel F reads the rows through idx."""
    nb, n = scs.shape[:2]
    d = window_digits(scs.reshape(nb * n, fd.NLIMB)).reshape(nb, n, NWIN)
    d = d.masked_fill(inf[None, :, None], 0)
    off = torch.arange(nb, device=scs.device) * NBUCK
    keys = (d.transpose(1, 2) + off[:, None, None]).reshape(-1)
    keys, perm = torch.sort(keys, stable=True)
    return keys, (perm % (NWIN * n)).to(torch.int32)


def prefix_tree(sh, idx=None):
    """The shifted basis (r, 2, 8) and the T sorted leaves' rows idx (T,)
    int32, T even (None: sh holds the T leaves) -> I1 (T/2, 3, 8), I1[j]
    the sum of leaves 0 to 2j + 1: kernel F, kernel G two levels a launch
    down to a level of at most TOP points, the fused top, kernel H two
    levels a launch."""
    levels = [tree_up0(sh, idx)]
    while levels[-1].shape[0] > TOP:
        levels += tree_up2(levels[-1])
    p = tree_top(levels[-1])
    for k in range(len(levels) - 3, -1, -2):
        p = tree_down2(p, levels[k + 1], levels[k])
    return p


def prefix_tree_chain(leaves, up0=None, up=None, down=None):
    """`prefix_tree` of (T, 2, 8) contiguous leaves one level a launch, as
    the route ran before kernels G and H took two levels a launch: up0, up
    and down default to the plain twins of kernels F, G and H (the card's
    one-level launches where the caller passes `tree_up0`, `tree_up`,
    `tree_down`)."""
    return _chain((up0 or tree_up0_plain)(leaves), up or tree_up_plain,
                  down or tree_down_plain)


def collect(keys, idx, i1, sh, nb: int):
    """-> (S, T), each (nb, 3, 8): S_b the sum of the 8191 bucket-end
    prefixes P[e_c] of MSM b, T_b its last prefix P[e_8191]."""
    dev = keys.device
    m = NBUCK - 1
    base = torch.arange(nb, device=dev) * NBUCK
    q = torch.cat(((base[:, None] + torch.arange(m, device=dev)).reshape(-1),
                   base + m))
    pos = torch.searchsorted(keys, q, right=True) - 1
    ok = pos >= 0
    pc = pos.clamp(min=0)
    ident = ed.identity(1, dev)
    vals = torch.where(ok[:, None, None], i1[pc // 2], ident)
    # P[2j] = I1[j] - leaf[2j + 1]; the last position is odd, so 2j + 1
    # is always a leaf
    nxt = sh[idx[pc + 1 - pc % 2].to(torch.int64)]
    one = fd.const(1, FQ, dev).expand(q.shape[0], 1, fd.NLIMB)
    neg = torch.cat((nxt[:, :1], fd.neg(nxt[:, 1], FQ).unsqueeze(1), one), 1)
    corr = torch.where((ok & (pc % 2 == 0))[:, None, None], neg, ident)
    # per MSM 8191 prefixes, 8191 corrections and 2 identities: 2^14 terms,
    # summed pairwise inside each MSM's run
    shape = (nb, m, 3, fd.NLIMB)
    terms = torch.cat((vals[:nb * m].view(shape), corr[:nb * m].view(shape),
                       ident.expand(nb, 2, 3, fd.NLIMB)), 1)
    terms = terms.reshape(-1, 3, fd.NLIMB).contiguous()
    totals = tree_up(torch.stack((vals[nb * m:], corr[nb * m:]), 1)
                     .reshape(-1, 3, fd.NLIMB).contiguous())
    return tree_reduce(terms, 2 * NBUCK), totals


def finalize(s_pts: list, t_pts: list) -> list:
    """Per MSM 8191 T_b - S_b on the host (curve.Jacobian)."""
    return [t.scalar_mul(NBUCK - 1).add(s.neg())
            for s, t in zip(s_pts, t_pts)]


def msm_batch(basis: TorchBasis, scalars: list) -> list:
    """B = len(scalars) MSMs over one basis, each (n_b, 8) Montgomery Fr
    vector against the basis's first n_b points -> curve.Jacobian list."""
    root = basis.root or basis
    nb = len(scalars)
    n = basis.length
    dev = basis.xy.device
    with phase("msm/small/sort"):
        canon = [fd.from_mont(s[:n], FR) for s in scalars]
    ident = curve.Jacobian.identity(curve.Fq(1))
    s_acc, t_acc = [ident] * nb, [ident] * nb
    for j in range(-(-n // CHUNK)):
        sh = shifted(basis, j)
        nj = sh.shape[0] // NWIN
        lo = j * CHUNK
        with phase("msm/small/sort"):
            scs = torch.zeros((nb, nj, fd.NLIMB), dtype=torch.int32,
                              device=dev)
            for b, c in enumerate(canon):
                part = c[lo:lo + nj]
                scs[b, :part.shape[0]] = part
            keys, idx = sort_leaves(scs, root.inf[lo:lo + nj])
        i1 = prefix_tree(sh, idx)
        s_pts, t_pts = collect(keys, idx, i1, sh, nb)
        with phase("msm/small/combine"):
            s_acc = [a.add(p) for a, p in
                     zip(s_acc, ed.proj_to_jacobians(s_pts))]
            t_acc = [a.add(p) for a, p in
                     zip(t_acc, ed.proj_to_jacobians(t_pts))]
    with phase("msm/small/combine"):
        return finalize(s_acc, t_acc)
