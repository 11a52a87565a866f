"""Fixed-base tau powers on the device, the CRS of `KZG.device_setup`:
kernel J (`csrc/fixed_base.cu`) and its plain PyTorch twin.

Counterpart of `quill_tpu/ec/fixed_base.py`.  The base G is fixed, so the
host builds a small windowed table T[w][d] = d 2^(4w) G (64 windows x 16
digits, d = 0 the identity; `build_table`), and every tau^i G is 64 table
adds, one per four-bit digit of tau^i (kernel J, one launch per CRS chunk
of 2^16 points, as the TPU build ran one XLA program per chunk).  The
projective points are then normalised to affine with one batch inversion
(`msm5.to_affine`, one host inversion per call).  The tau powers
themselves are computed on the device (`fields/device.py: powers`), where
the TPU build ran a host loop; they are the same integers.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.bn254 import R
from ..fields.device import FQ, FR
from ..kernels import build
from . import curve
from . import device as ed
from .msm5 import to_affine

FB_WINDOW = 4
FB_DIGITS = 1 << FB_WINDOW
FB_WINDOWS = 64            # 64 x 4 bits cover the 256-bit limbs
CHUNK = 1 << 16            # points per kernel J launch

_FN = {}


def _fn():
    if not _FN:
        _FN["j"] = build.bind(build.lib("fixed_base"), "quill_fixed_base",
                              [build.VP, build.VP, build.I64, build.VP,
                               build.VP])
    return _FN["j"]


def build_table(base: curve.Jacobian, device="cpu") -> torch.Tensor:
    """(64, 16, 3, 8) projective Montgomery table: T[w][d] = d 2^(4w) base,
    the identity (0 : 1 : 0) at d = 0 and Z = 1 elsewhere
    (`quill_tpu/ec/fixed_base.py:41 _build_table`)."""
    vals = []
    bw = base
    for _ in range(FB_WINDOWS):
        multiples, acc = [], curve.Jacobian.identity(curve.Fq(1))
        for _ in range(FB_DIGITS):
            multiples.append(acc)
            acc = acc.add(bw)
        affs = curve.batch_to_affine(multiples)
        for d in range(FB_DIGITS):
            vals += [0, 1, 0] if d == 0 else [affs[d].x.v, affs[d].y.v, 1]
        for _ in range(FB_WINDOW):
            bw = bw.double()
    t = fd.from_ints(vals, FQ, device)
    return t.reshape(FB_WINDOWS, FB_DIGITS, 3, fd.NLIMB).contiguous()


def window_digits4(s: torch.Tensor) -> torch.Tensor:
    """(n, 8) canonical scalars -> (n, 64) int64 four-bit digits."""
    v = s.to(torch.int64) & 0xFFFFFFFF
    sh = FB_WINDOW * torch.arange(32 // FB_WINDOW, device=s.device)
    d = (v.unsqueeze(-1) >> sh) & (FB_DIGITS - 1)
    return d.reshape(s.shape[0], FB_WINDOWS)


def fixed_base(scalars: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel J: (n, 8) canonical scalars -> (n, 3, 8) projective points
    sum_w T[w][digit_w]."""
    if not scalars.is_cuda:
        return fixed_base_plain(scalars, table)
    if not (scalars.dtype == torch.int32 and scalars.is_contiguous()
            and scalars.dim() == 2 and scalars.shape[1] == fd.NLIMB):
        raise ValueError("scalars must be contiguous (n, 8) int32")
    if not (table.is_cuda and table.dtype == torch.int32
            and table.is_contiguous()
            and table.shape == (FB_WINDOWS, FB_DIGITS, 3, fd.NLIMB)):
        raise ValueError("table must be a contiguous (64, 16, 3, 8) int32 "
                         "tensor on CUDA")
    n = scalars.shape[0]
    out = torch.empty((n, 3, fd.NLIMB), dtype=torch.int32,
                      device=scalars.device)
    rc = _fn()(scalars.data_ptr(), table.data_ptr(), n, out.data_ptr(),
               build.stream_ptr())
    build.check(rc, "fixed_base")
    build.count("fixed_base")
    return out


def fixed_base_plain(scalars: torch.Tensor, table: torch.Tensor):
    digits = window_digits4(scalars)
    flat = table.reshape(FB_WINDOWS * FB_DIGITS, 3, fd.NLIMB)
    acc = ed.identity_w((scalars.shape[0],), scalars.device)
    for w in range(FB_WINDOWS):
        acc = ed.padd_w(acc, fd.to_w16(flat[FB_DIGITS * w + digits[:, w]]))
    return fd.from_w16(acc)


def device_tau_powers(tau: int, count: int, device) -> torch.Tensor:
    """[G, tau G, ..., tau^(count-1) G] as a (count, 2, 8) affine Montgomery
    tensor on `device` (`quill_tpu/ec/fixed_base.py:189`)."""
    assert 0 < tau < R and count > 0
    powers = fd.from_mont(fd.powers(tau, count, FR, device), FR)
    table = build_table(curve.g1_generator(), device)
    pts = torch.cat([fixed_base(powers[lo:lo + CHUNK], table)
                     for lo in range(0, count, CHUNK)], 0)
    del powers
    return to_affine(pts)
