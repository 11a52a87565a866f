"""Canonical bytes <-> 12-bit limb array conversions (host side, numpy).

Device representation of a vector of field elements: int32 array of shape
(22, N) -- limb-major so the element axis is the TPU vector-lane axis.  Limb i
holds bits [12i, 12i+12) of the canonical integer.  22 * 12 = 264 bits covers
the 254-bit BN254 moduli with Montgomery radix R = 2^264.

Why 12-bit limbs in int32: products of canonical limbs are < 2^24, so a
44-column schoolbook product accumulates at most 44 * 2^24 < 2^30 per column
-- no overflow anywhere in the Montgomery multiply without intermediate
normalization (SURVEY §7 "bignum on TPU").
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 12
NUM_LIMBS = 22
LIMB_MASK = (1 << LIMB_BITS) - 1
BYTES = 33  # ceil(264 / 8)


def int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK
                     for i in range(NUM_LIMBS)], dtype=np.int32)


def ints_to_limbs(xs) -> np.ndarray:
    """Vector of canonical ints -> (22, N) int32 limb array.

    Bulk path: serialize to bytes once per element, then vectorized numpy bit
    surgery (unpacking 33 bytes into 22 x 12-bit limbs).
    """
    n = len(xs)
    if n == 0:
        return np.zeros((NUM_LIMBS, 0), dtype=np.int32)
    buf = bytearray(n * BYTES)
    for i, x in enumerate(xs):
        buf[i * BYTES:(i + 1) * BYTES] = int(x).to_bytes(BYTES, "little")
    raw = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(n, BYTES)
    # 2 limbs per 3 bytes: limbs[2k]   = b[3k] | (b[3k+1] & 0xF) << 8
    #                      limbs[2k+1] = b[3k+1] >> 4 | b[3k+2] << 4
    b = raw.astype(np.int32)
    limbs = np.empty((n, NUM_LIMBS), dtype=np.int32)
    for k in range(NUM_LIMBS // 2):
        limbs[:, 2 * k] = b[:, 3 * k] | ((b[:, 3 * k + 1] & 0xF) << 8)
        limbs[:, 2 * k + 1] = (b[:, 3 * k + 1] >> 4) | (b[:, 3 * k + 2] << 4)
    return np.ascontiguousarray(limbs.T)


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """(22, N) canonical limb array -> list of ints (exact)."""
    limbs = np.asarray(limbs)
    n = limbs.shape[1]
    b = np.zeros((n, BYTES), dtype=np.uint8)
    arr = limbs.T.astype(np.int64)
    for k in range(NUM_LIMBS // 2):
        lo = arr[:, 2 * k]
        hi = arr[:, 2 * k + 1]
        b[:, 3 * k] = lo & 0xFF
        b[:, 3 * k + 1] = ((lo >> 8) & 0xF) | ((hi & 0xF) << 4)
        b[:, 3 * k + 2] = (hi >> 4) & 0xFF
    data = b.tobytes()
    return [int.from_bytes(data[i * BYTES:(i + 1) * BYTES], "little")
            for i in range(n)]
