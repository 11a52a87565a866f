"""Fixed-base tau powers on the device, the CRS of `KZG.device_setup`:
kernel J (`csrc/fixed_base.cu`) and its plain PyTorch twin.

Counterpart of `quill_tpu/ec/fixed_base.py`.  The base G is fixed, so
every tau^i G is a sum of table rows, one a window of the scalar tau^i:
signed windows of w bits, `windows(w)` of them, the table holding
|d| 2^(w k) G for 1 <= |d| <= 2^(w-1) as affine rows (`csrc/fixed_base.cuh`
has the digits and the design).  Kernel J adds a point's rows with mixed
adds and normalises each block of points to affine rows with one
inversion, so the whole CRS is one launch.  Its table is made on the card
too, by one kernel J launch over a small table of 4-bit windows
(`boot_table`, 512 points made once a process on the host): two launches
a CRS, where the TPU build ran one XLA program a chunk of 2^16 points and
a batch normalisation after them.  The width follows the CRS's size
(`window_for`): a wide table saves adds a point but costs its own
points.  The tau powers are computed on the device (`fields/device.py:
powers`, plain torch), where the TPU build ran a host loop; they are the
same integers.
"""

from __future__ import annotations

import functools

import torch

from ..fields import device as fd
from ..fields.bn254 import R
from ..fields.device import FQ, FR
from ..kernels import build
from . import curve
from . import device as ed
from .msm5 import to_affine

BOOT_W = 4                 # the host table's window
W_RANGE = range(8, 17)     # the widths the card's table may take
MIXED = 11                 # products of a mixed add (bn254.cuh)

_FN = {}


def _fn():
    if not _FN:
        _FN["j"] = build.bind(build.lib("fixed_base"), "quill_fixed_base",
                              [build.VP, build.I64, build.VP, build.I32,
                               build.VP, build.VP, build.VP])
    return _FN["j"]


def windows(w: int) -> int:
    """Signed windows of w bits of a scalar below r < 2^254: ceil(255 / w),
    so that the top one never carries out (`fixed_base.cuh: fb_windows`)."""
    return -(-255 // w)


def table_points(w: int) -> int:
    return windows(w) << (w - 1)


def window_for(count: int) -> int:
    """The table width for a CRS of `count` points: the fewest products of
    the CRS and its table, (windows - 1) mixed adds a point of each (the
    table's over the 4-bit host table), BOOT_W itself (no table) when
    nothing wider pays; the smaller width on a tie.  The card's sweep
    (`probe_crs.py --sweep`, PERF.md) is what this model is held to."""
    def cost(w):
        table = 0 if w == BOOT_W else table_points(w) * (windows(BOOT_W) - 1)
        return MIXED * (count * (windows(w) - 1) + table)

    return min([BOOT_W, *W_RANGE], key=lambda w: (cost(w), w))


@functools.lru_cache(maxsize=None)
def _boot_ints() -> tuple:
    """The 4-bit table's affine coordinates as ints, rows |d| 2^(4k) G
    (native host EC where it is built, else the host curve's adds)."""
    from . import native_ec

    half = 1 << (BOOT_W - 1)
    scalars = [(d << (BOOT_W * k)) % R for k in range(windows(BOOT_W))
               for d in range(1, half + 1)]
    g = curve.g1_generator()
    if native_ec.available():
        pts = native_ec.batch_to_affine(native_ec.scalar_mul_many(
            g.to_affine(), scalars))
    else:
        pts, base = [], g
        for _ in range(windows(BOOT_W)):
            acc = base
            for _ in range(half):
                pts.append(acc)
                acc = acc.add(base)
            for _ in range(BOOT_W):
                base = base.double()
        pts = curve.batch_to_affine(pts)
    return tuple(c for p in pts for c in (p.x.v, p.y.v))


def boot_table(device="cpu") -> torch.Tensor:
    """(windows(4), 8, 2, 8) affine Montgomery table of 4-bit signed
    windows: row (k, |d| - 1) = |d| 2^(4k) G."""
    t = fd.from_ints(_boot_ints(), FQ, device)
    return t.reshape(windows(BOOT_W), 1 << (BOOT_W - 1), 2, fd.NLIMB)


def table_scalars(w: int, device="cpu") -> torch.Tensor:
    """(windows(w), 2^(w-1), 8) canonical scalars |d| 2^(w k) mod r: one
    plain Montgomery product of the raw |d| and 2^(w k) R mod r each."""
    half = 1 << (w - 1)
    d = torch.zeros((half, fd.NLIMB), dtype=torch.int32, device=device)
    d[:, 0] = torch.arange(1, half + 1, dtype=torch.int32, device=device)
    base = fd.from_ints([pow(2, w * k, R) for k in range(windows(w))], FR,
                        device)
    return fd.mul(d.unsqueeze(0), base.unsqueeze(1), FR)


def make_table(w: int, device="cpu", flag=None) -> torch.Tensor:
    """(windows(w), 2^(w-1), 2, 8) affine table of signed w-bit windows:
    the 4-bit host table for w = 4, else one kernel J launch over it."""
    boot = boot_table(device)
    if w == BOOT_W:
        return boot
    s = table_scalars(w, device).reshape(-1, fd.NLIMB)
    return fixed_base(s, boot, BOOT_W, flag).reshape(
        windows(w), 1 << (w - 1), 2, fd.NLIMB)


def _check(scalars, table, w):
    if not (1 <= w <= 16 and table.shape == (windows(w), 1 << (w - 1), 2,
                                             fd.NLIMB)):
        raise ValueError(f"table must be (windows(w), 2^(w-1), 2, 8) for "
                         f"1 <= w <= 16, got {tuple(table.shape)} at w={w}")
    if not (scalars.dim() == 2 and scalars.shape[1] == fd.NLIMB):
        raise ValueError("scalars must be (n, 8)")


def fixed_base(scalars: torch.Tensor, table: torch.Tensor, w: int,
               flag=None) -> torch.Tensor:
    """Kernel J: (n, 8) canonical scalars, none 0 mod r, and a table of
    signed w-bit windows -> (n, 2, 8) affine rows s_i G.  A point at
    infinity sets `flag` (a (1,) int32 tensor on the card) and raises
    ValueError: at once without `flag`, else where the caller reads it."""
    _check(scalars, table, w)
    if not scalars.is_cuda:
        return fixed_base_twin(scalars, table, w)
    if not (scalars.dtype == torch.int32 and scalars.is_contiguous()
            and table.is_cuda and table.dtype == torch.int32
            and table.is_contiguous() and table.data_ptr() % 16 == 0):
        raise ValueError("scalars and table must be contiguous int32 "
                         "tensors on CUDA, the table 16-byte aligned")
    own = flag is None
    if own:
        flag = torch.zeros(1, dtype=torch.int32, device=scalars.device)
    n = scalars.shape[0]
    out = torch.empty((n, 2, fd.NLIMB), dtype=torch.int32,
                      device=scalars.device)
    rc = _fn()(scalars.data_ptr(), n, table.data_ptr(), w, out.data_ptr(),
               flag.data_ptr(), build.stream_ptr())
    build.check(rc, "fixed_base")
    build.count("fixed_base")
    if own:
        check_flag(flag)
    return out


def check_flag(flag) -> None:
    """Raise where kernel J met a point at infinity (one 4-byte read)."""
    if int(flag.item()):
        raise ValueError("kernel J: a scalar is 0 mod r (a point at "
                         "infinity)")


def signed_digits(scalars: torch.Tensor, w: int) -> torch.Tensor:
    """(n, 8) canonical scalars -> (n, windows(w)) int64 signed digits,
    |d| <= 2^(w-1) (`fixed_base.cuh: fb_digit`)."""
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    half, out = 1 << (w - 1), []
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64,
                        device=scalars.device)
    for k in range(windows(w)):
        limb, sh = divmod(w * k, 32)
        d = v[:, limb] >> sh
        if sh + w > 32 and limb + 1 < fd.NLIMB:
            d = d | (v[:, limb + 1] << (32 - sh))
        d = (d & ((1 << w) - 1)) + carry
        carry = (d > half).to(torch.int64)
        out.append(d - (carry << w))
    return torch.stack(out, 1)


def fixed_base_plain(scalars: torch.Tensor, table: torch.Tensor, w: int):
    """(n, 3, 8) projective s_i G: complete adds of each window's row (the
    identity for a zero digit) from the identity, in plain torch."""
    _check(scalars, table, w)
    digits = signed_digits(scalars, w)
    half = 1 << (w - 1)
    flat = fd.to_w16(table.reshape(-1, 2, fd.NLIMB))
    acc = ed.identity_w((scalars.shape[0],), scalars.device)
    for k in range(digits.shape[1]):
        d = digits[:, k]
        row = flat[k * half + (d.abs() - 1).clamp(min=0)]
        q = ed.neg_y_w(ed.affine_to_proj_w(row), d < 0)
        q = torch.where((d == 0)[:, None, None],
                        ed.identity_w((d.shape[0],), d.device), q)
        acc = ed.padd_w(acc, q)
    return fd.from_w16(acc)


def fixed_base_twin(scalars: torch.Tensor, table: torch.Tensor, w: int):
    """Kernel J's plain twin: `fixed_base_plain`, then `to_affine`; raises
    ValueError for a point at infinity, as the kernel's flag does."""
    p = fixed_base_plain(scalars, table, w)
    if bool((p[:, 2] == 0).all(-1).any()):
        raise ValueError("kernel J: a scalar is 0 mod r (a point at "
                         "infinity)")
    return to_affine(p)


def device_tau_powers(tau: int, count: int, device) -> torch.Tensor:
    """[G, tau G, ..., tau^(count-1) G] as a (count, 2, 8) affine Montgomery
    tensor on `device` (`quill_tpu/ec/fixed_base.py:189`): the table (one
    kernel J launch, none at w = 4), then the CRS (one), their flag read
    once after both."""
    assert 0 < tau < R and count > 0
    w = window_for(count)
    flag = None
    if torch.device(device).type == "cuda":
        flag = torch.zeros(1, dtype=torch.int32, device=device)
    powers = fd.from_mont(fd.powers(tau, count, FR, device), FR)
    table = make_table(w, device, flag)
    xy = fixed_base(powers, table, w, flag)
    if flag is not None:
        check_flag(flag)
    return xy
