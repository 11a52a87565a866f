"""NTT polynomial products over Fr: kernel B (`csrc/ntt.cu`) and its plain
PyTorch twins.

Counterpart of `quill_tpu/poly/ntt.py` (`ntt_chunks`, `poly_mul_ntt`) and
`quill_tpu/poly/ntt8.py` (the in-chunk four-step NTT kernel).  As there,
the forward transform leaves a fixed internal order that the inverse
consumes: here the forward transform is decimation in frequency (natural
order in, bit-reversed out) and the inverse decimation in time
(bit-reversed in, natural out, scaled by 1/n), so no pass permutes
(`csrc/ntt.cuh`).  Roots come from `fields/bn254.py` (`FR_ROOT_OF_UNITY` of
order 2^`FR_TWO_ADICITY`).

A transform runs in tile passes (`plan`): each launch holds tiles of
2^TILE_LOG elements in shared memory and runs 6 to 11 stages on them.
`poly_mul` fuses b's last forward pass, the pointwise product, the 1/n
scale and the inverse's first pass into one launch (the product pass), so
the product runs no plain-torch field op on the card.  Each launch-level
function has a plain twin (`pass_plain`, `twiddle_table_plain`,
`s_fold_plain`) that computes the same function stage by stage over the
whole array; the wrappers take them only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import device as fd
from ..fields.bn254 import FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from ..fields.device import FR
from ..kernels import build

TILE_LOG = 11           # csrc/ntt.cuh: NTT_TILE_LOG

_FN = {}
# the cached twiddle table of each device: (logn, tensor), rows b < logn
TABLES: dict = {}


def _fn(name: str):
    if not _FN:
        lib = build.lib("ntt")
        _FN["pass"] = build.bind(lib, "quill_ntt_pass", [
            build.VP, build.VP, build.I64, build.VP, build.VP, build.I32,
            build.I32, build.I32, build.I32, build.I32, build.I32, build.VP,
            build.VP])
        _FN["twiddles"] = build.bind(lib, "quill_ntt_twiddles", [
            build.VP, build.I32, build.VP, build.VP])
        _FN["s_fold"] = build.bind(lib, "quill_ntt_s_fold", [
            build.VP, build.VP, build.I64, build.VP])
    return _FN[name]


def root_of_unity(n: int) -> int:
    logn = n.bit_length() - 1
    assert n == 1 << logn and logn <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - logn), R)


def plan(logn: int, tile_log: int = TILE_LOG) -> list:
    """The passes of a forward transform of 2^logn points, in order:
    (b0, s, logc) = stages on bits [b0, b0 + s) over tiles of 2^s rows of
    2^logc columns.  The last pass is the contiguous one (b0 = 0, up to
    tile_log bits); the bits above it go in balanced strided passes of at
    most tile_log - 3 bits, so a row is at least 8 elements (256 bytes)."""
    last = min(logn, tile_log)
    rest = logn - last
    most = max(1, tile_log - 3)
    count = -(-rest // most)
    out, top = [], logn
    for i in range(count):
        s = -(-(top - last) // (count - i))
        out.append((top - s, s, tile_log - s))
        top -= s
    out.append((0, last, 0))
    return out


def tw_rows(logn: int) -> int:
    """Entries of the twiddle table's rows b < logn (2^b + 1 each)."""
    return (1 << logn) - 1 + logn


def twiddle_table_plain(logn: int, device) -> torch.Tensor:
    """Row b: w_(2^(b+1))^j for j = 0 .. 2^b, rows in order of b."""
    rows = [fd.powers(root_of_unity(2 << b), (1 << b) + 1, FR, device)
            for b in range(logn)]
    if not rows:
        return torch.zeros((0, fd.NLIMB), dtype=torch.int32,
                           device=torch.device(device))
    return torch.cat(rows, 0)


def twiddle_table_cuda(logn: int, device) -> torch.Tensor:
    out = torch.empty((tw_rows(logn), fd.NLIMB), dtype=torch.int32,
                      device=device)
    roots = (ctypes.c_uint32 * (8 * (FR_TWO_ADICITY + 1)))(
        *[w for m in range(FR_TWO_ADICITY + 1)
          for w in fd.mont_words(root_of_unity(1 << m))])
    rc = _fn("twiddles")(out.data_ptr(), logn, ctypes.addressof(roots),
                         build.stream_ptr())
    build.check(rc, "ntt_twiddles")
    build.count("ntt_twiddles")
    return out


def twiddle_table(logn: int, device, plain: bool = False) -> torch.Tensor:
    """The table of rows b < logn or more, cached for the device (rows do
    not depend on the transform's size); on the card kernel B's twiddle
    launch builds it, and `plain` the plain twin."""
    device = torch.device(device)
    key = (str(device), plain or device.type != "cuda")
    have = TABLES.get(key)
    if have is None or have[0] < logn:
        make = twiddle_table_plain if key[1] else twiddle_table_cuda
        have = (logn, make(logn, device))
        TABLES[key] = have
    return have[1]


def _stage_plain(w: torch.Tensor, b: int, tw: torch.Tensor,
                 inverse: bool) -> torch.Tensor:
    """One stage on bit b of a w16 (n, 16) array."""
    n, h = w.shape[0], 1 << b
    v = w.view(n // (2 * h), 2, h, fd.NW)
    row = tw[tw_rows(b):tw_rows(b) + h + 1]
    u, x = v[:, 0], v[:, 1]
    if not inverse:
        t = fd.to_w16(row[:h])
        out = (fd.w_add(u, x, FR), fd.w_mul(fd.w_sub(u, x, FR), t, FR))
    else:
        t = fd.w_mul(x, fd.to_w16(torch.flip(row[1:], [0])), FR)
        out = (fd.w_sub(u, t, FR), fd.w_add(u, t, FR))
    return torch.stack(out, 1).reshape(n, fd.NW)


def pass_plain(src, dst, valid: int, logn: int, b0: int, s: int, logc: int,
               tw, dif: bool = False, dit: bool = False, y=None,
               scale: int | None = None) -> None:
    """The plain twin of one pass: the same stages, product and scale over
    the whole array (the tile shape logc does not change the function)."""
    n = 1 << logn
    x = torch.zeros((n, fd.NLIMB), dtype=torch.int32, device=dst.device)
    x[:valid] = src[:valid]
    w = fd.to_w16(x)
    if dif:
        for q in reversed(range(s)):
            w = _stage_plain(w, b0 + q, tw, False)
    if y is not None:
        w = fd.w_mul(w, fd.to_w16(y[:n]), FR)
    if scale is not None:
        w = fd.w_mul(w, fd.w_const(scale, FR, dst.device), FR)
    if dit:
        for q in range(s):
            w = _stage_plain(w, b0 + q, tw, True)
    dst.copy_(fd.from_w16(w))


def pass_cuda(src, dst, valid: int, logn: int, b0: int, s: int, logc: int,
              tw, dif: bool = False, dit: bool = False, y=None,
              scale: int | None = None) -> None:
    for t in (src, dst, tw) + (() if y is None else (y,)):
        if not (t.is_cuda and t.is_contiguous() and t.dtype == torch.int32):
            raise ValueError("ntt pass needs contiguous int32 CUDA tensors")
    if dst.shape[0] != 1 << logn or (y is not None
                                     and y.shape[0] < 1 << logn):
        raise ValueError(f"ntt pass of 2^{logn} rows on {dst.shape[0]}")
    if s and tw.shape[0] < tw_rows(b0 + s):
        raise ValueError("ntt pass: twiddle table too short")
    c_scale = None
    if scale is not None:
        c_scale = (ctypes.c_uint32 * fd.NLIMB)(*fd.mont_words(scale))
    rc = _fn("pass")(
        src.data_ptr(), dst.data_ptr(), min(valid, src.shape[0]),
        None if y is None else y.data_ptr(), tw.data_ptr(), logn, b0, s,
        logc, int(dif), int(dit),
        None if c_scale is None else ctypes.addressof(c_scale),
        build.stream_ptr())
    build.check(rc, "ntt_pass")
    build.count("ntt_product" if y is not None
                else "ntt_forward" if dif else "ntt_inverse")


def chain(x, logn: int, steps: list, tw, plain: bool = False) -> torch.Tensor:
    """Passes (dicts of pass keywords, at least one) on x zero-padded to
    2^logn rows: the first reads x, the others run in place; `pass_cuda`
    on the card, `pass_plain` on the CPU or when `plain`."""
    run = pass_plain if plain or not x.is_cuda else pass_cuda
    dst = torch.empty((1 << logn, fd.NLIMB), dtype=torch.int32,
                      device=x.device)
    src, valid = x.contiguous(), x.shape[0]
    for step in steps:
        run(src, dst, valid, logn, tw=tw, **step)
        src, valid = dst, 1 << logn
    return dst


def forward_steps(passes) -> list:
    return [dict(b0=b0, s=s, logc=logc, dif=True) for b0, s, logc in passes]


def inverse_steps(passes) -> list:
    return [dict(b0=b0, s=s, logc=logc, dit=True)
            for b0, s, logc in reversed(passes)]


def product_steps(passes, fa: torch.Tensor, logn: int) -> list:
    """b's passes in a product with a's forward transform fa: b's forward
    passes but the last, the product pass (b's last forward pass, the
    pointwise product by fa, the 1/n scale and the inverse's first pass in
    one launch), then the inverse's other passes."""
    b0, s, logc = passes[-1]
    product = dict(b0=b0, s=s, logc=logc, dif=True, dit=True, y=fa,
                   scale=pow(1 << logn, R - 2, R))
    return (forward_steps(passes[:-1]) + [product]
            + inverse_steps(passes[:-1]))


def ntt(a: torch.Tensor, inverse: bool = False,
        plain: bool = False) -> torch.Tensor:
    """Transform of a power-of-two-length (n, 8) Montgomery tensor:
    forward from natural order to the DIF (bit-reversed) order, inverse
    from that order to natural order, scaled by 1/n in its first pass.
    `plain` runs the plain twins whatever the device."""
    n = a.shape[0]
    logn = n.bit_length() - 1
    assert n == 1 << logn
    passes = plan(logn)
    tw = twiddle_table(logn, a.device, plain)
    if not inverse:
        return chain(a, logn, forward_steps(passes), tw, plain)
    steps = inverse_steps(passes)
    steps[0]["scale"] = pow(n, R - 2, R)
    return chain(a, logn, steps, tw, plain)


def poly_mul(a: torch.Tensor, b: torch.Tensor,
             plain: bool = False) -> torch.Tensor:
    """Coefficient product of two (la, 8) and (lb, 8) Montgomery tensors.
    Returns a tensor of the padded power-of-two length; entries at and
    beyond la + lb - 1 are zero.  On the card: a's forward passes, b's
    forward passes but the last, the fused product pass, the inverse's
    other passes (one launch each)."""
    out_len = a.shape[0] + b.shape[0] - 1
    logn = max(out_len - 1, 0).bit_length()
    passes = plan(logn)
    tw = twiddle_table(logn, a.device, plain)
    fa = chain(a, logn, forward_steps(passes), tw, plain)
    return chain(b, logn, product_steps(passes, fa, logn), tw, plain)


def s_fold_plain(h: torch.Tensor, m: int) -> torch.Tensor:
    return fd.add(h[m:2 * m - 1], torch.flip(h[:m - 1], [0]), FR)


def s_fold(h: torch.Tensor, m: int, plain: bool = False) -> torch.Tensor:
    """S[k] = h[m + k] + h[m - 2 - k] for k < m - 1, as (m - 1, 8)."""
    if plain or not h.is_cuda:
        return s_fold_plain(h, m)
    if not (h.is_contiguous() and h.dtype == torch.int32
            and h.shape[0] >= 2 * m - 1):
        raise ValueError("s_fold needs a contiguous int32 (>= 2m - 1, 8) "
                         "CUDA tensor")
    out = torch.empty((max(m - 1, 0), fd.NLIMB), dtype=torch.int32,
                      device=h.device)
    rc = _fn("s_fold")(h.data_ptr(), out.data_ptr(), m, build.stream_ptr())
    build.check(rc, "ntt_s_fold")
    build.count("ntt_s_fold")
    return out


def s_polynomial(f: torch.Tensor, g: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """IPA S polynomial of two (m, 8) tensors with ONE product
    (`quill_tpu/engine/device.py:864-885`): h = f * rev(g),
    S[k] = h[m + k] + h[m - 2 - k], k < m - 1."""
    m = f.shape[0]
    h = poly_mul(f, torch.flip(g, [0]), plain)
    return s_fold(h, m, plain)
