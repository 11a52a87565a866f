"""Elementwise field and point kernels: kernel L (`csrc/field.cu`) and the
elementwise modes of kernel E (`csrc/msm5.cu`), with their plain twins.

Counterpart of `quill_tpu/fields/pallas8.py:113-335`, on the port's
`(n, 8)` int32 Montgomery layout (R = 2^256; the JAX package holds 33 8-bit
limbs with R = 2^264, so the two compare through canonical integers):

- `mont_mul_vec` (`_mul_kernel`): kernel L, one Montgomery product a thread;
- `pt_add_vec` (`_pt_add_kernel`): the complete projective add over
  `(n, 3, 8)` points, which is kernel E; the TPU kernel differs from
  `_stacked_combine_kernel` (also kernel E) only in holding x, y and z as
  separate arrays;
- `pt_add_b16` (`_pt_add_b16_kernel`): the same add, kernel E.  The TPU
  kept points at rest as bf16 because its 8-bit limbs lived in f32 words
  with spare bits (`pallas8.py:229-232`); the port's 32-bit limbs have no
  spare bits, so there is no narrower form to keep at rest, and this takes
  and returns the int32 layout;
- `seg_combine` (`_seg_combine_kernel`): (f2 ? q : p + q, f1 | f2), kernel
  E's flagged mode and an `|` of the (n,) bool flags.

The JAX package's one caller of the first two is its field bench
(`scripts/bench_field8.py`; the port's is `quill_tpu_torch/bench_field.py`).
"""

from __future__ import annotations

import torch

from ..ec import msm5
from ..kernels import build
from . import device as fd
from .device import FR, Field

FIELD_ID = {"fr": 0, "fq": 1}

_FN = {}


def _fn():
    if not _FN:
        _FN["l"] = build.bind(build.lib("field"), "quill_mont_mul",
                              [build.VP, build.VP, build.I64, build.I32,
                               build.VP, build.VP])
    return _FN["l"]


def mont_mul_vec(a: torch.Tensor, b: torch.Tensor,
                 field: Field = FR) -> torch.Tensor:
    """Kernel L: (n, 8) x (n, 8) Montgomery elements of Fr or Fq -> their
    elementwise Montgomery products a b / 2^256, canonical."""
    if not a.is_cuda:
        return mont_mul_vec_plain(a, b, field)
    for t in (a, b):
        if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()
                and t.dim() == 2 and t.shape[1] == fd.NLIMB
                and t.data_ptr() % 16 == 0):
            raise ValueError("operands must be contiguous, 16-byte aligned "
                             "(n, 8) int32 tensors on CUDA")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} != "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(a)
    rc = _fn()(a.data_ptr(), b.data_ptr(), a.shape[0], FIELD_ID[field.name],
               out.data_ptr(), build.stream_ptr())
    build.check(rc, "field_mul")
    build.count("field_mul")
    return out


def mont_mul_vec_plain(a, b, field: Field = FR):
    return fd.mul(a, b, field)


def pt_add_vec(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective p + q of (n, 3, 8) points, elementwise (kernel
    E; its plain twin `msm5.pt_add_plain`)."""
    return msm5.pt_add(p, q)


# `pallas8.pt_add_b16`: the same add, in the int32 layout (32-bit limbs
# leave no spare bits for a narrower one at rest)
pt_add_b16 = pt_add_vec


def seg_combine(a: tuple, b: tuple) -> tuple:
    """((p, f1), (q, f2)) -> (f2 ? q : p + q, f1 | f2): the segmented-scan
    combine of (n, 3, 8) points and (n,) bool flags, kernel E's flagged
    mode."""
    (p, f1), (q, f2) = a, b
    return msm5.pt_add(p, q, f2), f1 | f2
