"""Fiat-Shamir transcript: blake3 hash chain, byte-compatible with the
reference (`quill-zkvm/transcript/src/transcript.rs:13-75`).

State = 32-byte blake3 digest.  `new` hashes the domain tag; each append
rehashes `state || message`; challenges are blake3-XOF over
`state || b"challenge"` and are appended back into the state; a field draw
takes 48 bytes reduced mod r.

The transcript lives on the host: it is the inherently-sequential spine of the
protocol, and every device phase runs between two transcript events.
"""

from __future__ import annotations

from ..fields.bn254 import CHALLENGE_BYTES, R
from ..hashing.blake3 import blake3_digest, blake3_xof
from . import serialize as ser


class Transcript:
    __slots__ = ("domain", "state")

    def __init__(self, domain: bytes):
        self.domain = bytes(domain)
        self.state = blake3_digest(self.domain)

    def append_bytes(self, message: bytes) -> None:
        self.state = blake3_digest(self.state + message)

    # -- typed appends matching reference call sites ------------------------

    def append_usize(self, n: int) -> None:
        self.append_bytes(ser.ser_usize(n))

    def append_field(self, x: int) -> None:
        self.append_bytes(ser.ser_field(x))

    def append_field_vec(self, xs) -> None:
        self.append_bytes(ser.ser_field_vec(xs))

    def append_dense_poly(self, coeffs) -> None:
        self.append_bytes(ser.ser_dense_poly(coeffs))

    def append_g1(self, point) -> None:
        self.append_bytes(ser.ser_g1(point))

    # -- challenges ---------------------------------------------------------

    def draw_challenge(self, n: int) -> bytes:
        challenge = blake3_xof(self.state + b"challenge", n)
        self.append_bytes(challenge)
        return challenge

    def draw_field_element(self) -> int:
        data = self.draw_challenge(CHALLENGE_BYTES)
        return int.from_bytes(data, "little") % R
