"""ark-serialize 0.5 compatible `serialize_uncompressed` byte encodings.

Everything the reference appends to its Fiat-Shamir transcript goes through
arkworks `CanonicalSerialize::serialize_uncompressed`
(`quill-zkvm/transcript/src/transcript.rs:33-45`).  To produce
bit-identical transcripts we reproduce those encodings exactly:

- `usize`            -> u64 little-endian (8 bytes)
- `Fr` / `Fq`        -> 32-byte LE of the canonical integer
- `Vec<T>` / `&[T]`  -> u64 LE length prefix + elements
- `DensePolynomial`  -> its `coeffs: Vec<F>` (trailing zero coefficients are
                        stripped by arkworks polynomial arithmetic, so the
                        serialized length is true degree + 1)
- `G1` (projective)  -> normalized to affine; x (32B LE), then y (32B LE) with
                        ark-ec `SWFlags` in the two top bits of the final byte:
                        bit 7 = y is "negative" (y > p/2), bit 6 = infinity
                        (infinity serializes as x = y = 0 + flag).

No Rust toolchain exists in this environment, so the G1 flag layout is pinned
from the ark-ec 0.5 source (models/short_weierstrass/affine.rs
`serialize_with_mode`: uncompressed mode writes x plain, then
`y.serialize_with_flags(self.to_flags())`).  All encoders live in this one
module so a compatibility fix is a one-line change.
"""

from __future__ import annotations

from ..fields.bn254 import FIELD_BYTES, P

SW_Y_IS_NEGATIVE = 1 << 7
SW_POINT_AT_INFINITY = 1 << 6


def ser_usize(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


def ser_field(x: int) -> bytes:
    """Canonical (non-Montgomery) integer, 32 bytes LE."""
    return int(x).to_bytes(FIELD_BYTES, "little")


def ser_field_vec(xs) -> bytes:
    out = bytearray(ser_usize(len(xs)))
    for x in xs:
        out += ser_field(x)
    return bytes(out)


def ser_dense_poly(coeffs) -> bytes:
    """arkworks `DensePolynomial { coeffs: Vec<F> }` with trailing zeros
    stripped (`DensePolynomial::from_coefficients_vec` truncates leading-degree
    zeros, so serialized length is the true degree + 1)."""
    cs = list(coeffs)
    while cs and cs[-1] == 0:
        cs.pop()
    return ser_field_vec(cs)


def ser_g1(point) -> bytes:
    """Serialize a G1 point per ark-ec SW uncompressed layout.  Accepts our
    `ec.curve` Jacobian (normalized first, matching arkworks projective
    serialization) or Affine; coordinates may be ints or Fq wrappers."""
    if hasattr(point, "to_affine"):
        point = point.to_affine()
    if point.infinity:
        x_bytes = ser_field(0)
        y = bytearray(ser_field(0))
        y[-1] |= SW_POINT_AT_INFINITY
        return x_bytes + bytes(y)
    x = point.x.v if hasattr(point.x, "v") else int(point.x)
    y = point.y.v if hasattr(point.y, "v") else int(point.y)
    x_bytes = ser_field(x)
    y_bytes = bytearray(ser_field(y))
    # SWFlags::from_y_coordinate: "negative" iff y > -y, i.e. y > p/2
    if y > P - y:
        y_bytes[-1] |= SW_Y_IS_NEGATIVE
    return x_bytes + bytes(y_bytes)
