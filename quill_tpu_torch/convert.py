"""Carry the JAX package's data layouts across to the port's tensors.

The prover has no weights; what crosses between the two packages is field
and curve data.  The JAX package keeps it in three layouts:

- `quill_tpu/engine/device.py: DVec`: chunks of (22, N) int32 12-bit limbs
  in Montgomery form with radix 2^264 (`fields/device.py`, `fields/limbs.py`);
- (33, N) float32 8-bit limbs, the Pallas layout (`fields/device8.py`),
  with the same radix;
- `quill_tpu/ec/msm.py: DeviceBasis`: per-chunk x / y coordinate limbs
  (12-bit, Montgomery over Fq) and infinity masks;

and `HostEngine` vectors are numpy object arrays of canonical ints.  Limbs
made by the JAX device code may be lazy (of either sign, wider than their
nominal bits, the value above the modulus); every conversion here is exact
for them too.  The
port's radix is 2^256, so limbs never carry over bit for bit: every
conversion goes through canonical integers.  Inputs are numpy arrays (or
anything `np.asarray` takes), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ec.msm import TorchBasis
from .fields import device as fd
from .fields.bn254 import R
from .fields.device import FQ, FR
from .fields.limbs import limbs_to_ints

JAX_R_BITS = 264


def _unmont_jax(values, modulus: int) -> list[int]:
    r_inv = pow(1 << JAX_R_BITS, -1, modulus)
    return [int(v) % modulus * r_inv % modulus for v in values]


def _exact_ints(arr, bits: int) -> list[int]:
    """(L, N) limbs of `bits` bits each -> the exact ints sum_i a_i 2^(bits
    i).  The limbs may be lazy, as the JAX device code leaves them: of
    either sign and wider than `bits` (`quill_tpu/fields/device.py`, the
    lazy section), int32 or integral float32."""
    a = np.asarray(arr).astype(np.int64)
    for i in range(a.shape[0] - 1):
        carry = a[i] >> bits
        a[i] -= carry << bits
        a[i + 1] += carry
    top = a[-1].tolist()
    a[-1] = 0
    if bits == 12:
        low = limbs_to_ints(a)
    else:
        width = a.shape[0] * bits // 8
        data = np.ascontiguousarray(a.T.astype(np.uint8)).tobytes()
        low = [int.from_bytes(data[i * width:(i + 1) * width], "little")
               for i in range(a.shape[1])]
    shift = bits * (a.shape[0] - 1)
    return [lo + (int(t) << shift) for lo, t in zip(low, top)]


def limbs12_to_ints(arr, montgomery: bool = True, modulus: int = R):
    """(22, N) 12-bit limbs, canonical or lazy -> canonical ints (out of
    the 2^264 Montgomery form when `montgomery`)."""
    vals = _exact_ints(arr, 12)
    return _unmont_jax(vals, modulus) if montgomery else [
        v % modulus for v in vals]


def limbs8_to_ints(arr, montgomery: bool = False, modulus: int = R):
    """(33, N) 8-bit limbs (float32, canonical or lazy) -> ints."""
    vals = _exact_ints(arr, 8)
    return _unmont_jax(vals, modulus) if montgomery else [
        v % modulus for v in vals]


def from_limbs12(arr, montgomery: bool = True, field=FR, device="cpu"):
    """A 12-bit limb array -> the port's (N, 8) Montgomery tensor."""
    return fd.from_ints(limbs12_to_ints(arr, montgomery, field.modulus),
                        field, device)


def from_limbs8(arr, montgomery: bool = False, field=FR, device="cpu"):
    """An 8-bit limb array -> the port's (N, 8) Montgomery tensor."""
    return fd.from_ints(limbs8_to_ints(arr, montgomery, field.modulus),
                        field, device)


def from_dvec(dvec, device="cpu") -> torch.Tensor:
    """A JAX `DVec` (chunks + logical length) -> (length, 8) tensor."""
    if not dvec.chunks:
        return torch.zeros((0, fd.NLIMB), dtype=torch.int32,
                           device=torch.device(device))
    arr = np.concatenate([np.asarray(c) for c in dvec.chunks], axis=1)
    return from_limbs12(arr[:, :dvec.length], True, FR, device)


def from_host_vec(arr, device="cpu") -> torch.Tensor:
    """A `HostEngine` object array -> (N, 8) tensor."""
    return fd.from_ints([int(x) for x in arr], FR, device)


def from_device_basis(basis, device="cpu") -> TorchBasis:
    """A JAX `DeviceBasis` -> `TorchBasis` (same points, same length).
    Only the chunks are read, never `affines`: a CRS made on the device
    (`KZG.device_setup`, from `device_tau_powers` or its npz cache) has
    `affines=None`, lazy 12-bit limbs and chunks padded past its length."""
    n = basis.length
    xs = np.concatenate([np.asarray(c) for c in basis.x_chunks], axis=1)
    ys = np.concatenate([np.asarray(c) for c in basis.y_chunks], axis=1)
    inf = np.concatenate([np.asarray(c) for c in basis.inf_chunks])[:n]
    x = from_limbs12(xs[:, :n], True, FQ, device)
    y = from_limbs12(ys[:, :n], True, FQ, device)
    mask = torch.from_numpy(inf.astype(bool)).to(torch.device(device))
    xy = torch.stack((x, y), 1)
    xy[mask] = 0
    return TorchBasis(xy=xy.contiguous(), inf=mask, length=n)
