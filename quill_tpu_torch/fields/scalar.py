"""Host-side prime-field arithmetic on Python ints.

This is the *exact* reference arithmetic used by the transcript, the verifier
and the small-size tail of every device phase.  Device kernels are tested for
bit-exact equality against these functions.

Counterpart of arkworks `ark_ff::PrimeField` as consumed by the reference
(e.g. `quill-zkvm/pcs/src/kzg.rs:1-8`).
"""

from __future__ import annotations

from .bn254 import P, R


def inv(a: int, p: int) -> int:
    """Modular inverse. Raises ZeroDivisionError on 0 (the reference unwraps:
    `quill-zkvm/hyperplonk/src/piops/multiset_check.rs:51`)."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of zero field element")
    return pow(a, p - 2, p)


def batch_inverse(vals: list[int], p: int) -> list[int]:
    """Montgomery's batch-inversion trick: one modular inverse + 3(n-1) muls.

    Replaces the reference's per-element inversions
    (`quill-zkvm/hyperplonk/src/piops/multiset_check.rs:43-65`).
    """
    n = len(vals)
    if n == 0:
        return []
    prefix = [0] * n
    acc = 1
    for i, v in enumerate(vals):
        if v % p == 0:
            raise ZeroDivisionError("inverse of zero field element in batch")
        acc = acc * v % p
        prefix[i] = acc
    acc_inv = inv(acc, p)
    out = [0] * n
    for i in range(n - 1, 0, -1):
        out[i] = prefix[i - 1] * acc_inv % p
        acc_inv = acc_inv * vals[i] % p
    out[0] = acc_inv
    return out


def from_le_bytes_mod_order(data: bytes, p: int) -> int:
    """arkworks `F::from_le_bytes_mod_order`
    (`quill-zkvm/transcript/src/transcript.rs:73`)."""
    return int.from_bytes(data, "little") % p


def to_le_bytes(x: int, length: int = 32) -> bytes:
    return int(x).to_bytes(length, "little")


def fr(x: int) -> int:
    return x % R


def fq(x: int) -> int:
    return x % P
