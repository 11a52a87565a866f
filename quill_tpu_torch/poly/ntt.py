"""NTT polynomial products over Fr: kernel B (`csrc/ntt.cu`) and its plain
PyTorch twin.

Counterpart of `quill_tpu/poly/ntt.py` (`ntt_chunks`, `poly_mul_ntt`) and
`quill_tpu/poly/ntt8.py` (the in-chunk four-step NTT kernel).  The port
transforms a whole power-of-two vector with an iterative radix-2
Cooley-Tukey NTT: bit-reverse the input (a torch gather), then one kernel
launch per stage.  Roots come from `fields/bn254.py` (`FR_ROOT_OF_UNITY`
of order 2^`FR_TWO_ADICITY`).  The inverse uses omega^-1 and scales by
1/n.  Only products leave this module, so the transform order is free.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import device as fd
from ..fields.bn254 import FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from ..fields.device import FR
from ..kernels import build

_FN = {}


def _fn():
    if "stage" not in _FN:
        _FN["stage"] = build.bind(build.lib("ntt"), "quill_ntt_stage", [
            build.VP, build.I64, build.I64, build.VP, build.I64, build.VP])
    return _FN["stage"]


def root_of_unity(n: int) -> int:
    logn = n.bit_length() - 1
    assert n == 1 << logn and logn <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - logn), R)


@lru_cache(maxsize=16)
def twiddles(n: int, inverse: bool, device: str) -> torch.Tensor:
    """(max(n/2, 1), 8) Montgomery table of omega^k, k < n/2."""
    w = root_of_unity(n)
    if inverse:
        w = pow(w, R - 2, R)
    return fd.powers(w, max(n // 2, 1), FR, device)


@lru_cache(maxsize=16)
def bitrev(n: int, device: str) -> torch.Tensor:
    logn = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev.to(torch.device(device))


def stage(a: torch.Tensor, h: int, tw: torch.Tensor, tw_stride: int) -> None:
    """One radix-2 stage of half-width h on a (n, 8) tensor, in place."""
    if a.is_cuda:
        stage_cuda(a, h, tw, tw_stride)
    else:
        stage_plain(a, h, tw, tw_stride)


def stage_cuda(a, h, tw, tw_stride) -> None:
    if not (a.is_contiguous() and a.dtype == torch.int32 and tw.is_cuda):
        raise ValueError("ntt stage needs contiguous int32 CUDA tensors")
    rc = _fn()(a.data_ptr(), a.shape[0], h, tw.data_ptr(), tw_stride,
               build.stream_ptr())
    build.check(rc, "ntt_stage")
    build.count("ntt_stage")


def stage_plain(a, h, tw, tw_stride) -> None:
    n = a.shape[0]
    v = a.view(n // (2 * h), 2, h, fd.NLIMB)
    w = fd.to_w16(tw[0:h * tw_stride:tw_stride])          # (h, 16)
    u = fd.to_w16(v[:, 0])
    t = fd.w_mul(fd.to_w16(v[:, 1]), w, FR)
    out = torch.stack((fd.from_w16(fd.w_add(u, t, FR)),
                       fd.from_w16(fd.w_sub(u, t, FR))), 1)
    a.copy_(out.view(n, fd.NLIMB))


def stages(x: torch.Tensor, tw: torch.Tensor, plain: bool = False) -> None:
    """Every radix-2 stage of a bit-reversed (n, 8) tensor, in place, with
    the twiddle table of its n."""
    run = stage_plain if plain else stage
    n = x.shape[0]
    h = 1
    while h < n:
        run(x, h, tw, n // (2 * h))
        h *= 2


def ntt(a: torch.Tensor, inverse: bool = False,
        plain: bool = False) -> torch.Tensor:
    """Transform of a power-of-two-length (n, 8) Montgomery tensor.
    `plain` runs the plain stages whatever the device (for comparing
    kernel B with its twin on the card)."""
    n = a.shape[0]
    dev = str(a.device)
    x = a[bitrev(n, dev)].contiguous()
    stages(x, twiddles(n, inverse, dev), plain)
    if inverse:
        x = fd.mul_scalar(x, pow(n, R - 2, R), FR)
    return x


def poly_mul(a: torch.Tensor, b: torch.Tensor,
             plain: bool = False) -> torch.Tensor:
    """Coefficient product of two (la, 8) and (lb, 8) Montgomery tensors.
    Returns a tensor of the padded power-of-two length; entries at and
    beyond la + lb - 1 are zero."""
    la, lb = a.shape[0], b.shape[0]
    out_len = la + lb - 1
    n = 1
    while n < out_len:
        n *= 2
    dev = a.device
    pa = torch.zeros((n, fd.NLIMB), dtype=torch.int32, device=dev)
    pb = torch.zeros((n, fd.NLIMB), dtype=torch.int32, device=dev)
    pa[:la] = a
    pb[:lb] = b
    fa = ntt(pa, plain=plain)
    fb = ntt(pb, plain=plain)
    return ntt(fd.mul(fa, fb, FR), inverse=True, plain=plain)
