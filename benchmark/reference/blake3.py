"""Pure-Python BLAKE3 (hash and extendable output), from the public BLAKE3
specification: the hash of the proof transcript's Fiat-Shamir chain.

A frozen copy of the program's pure-Python fallback, kept here so that the
reference verifier imports nothing of the program.  Transcript messages are
small, so no native backend is needed.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024

MASK32 = 0xFFFFFFFF

def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state: list[int], m: list[int]) -> None:
    # Columns
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    # Diagonals
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _compress(
    chaining_value: tuple[int, ...],
    block_words: list[int],
    counter: int,
    block_len: int,
    flags: int,
) -> list[int]:
    state = [
        chaining_value[0], chaining_value[1], chaining_value[2], chaining_value[3],
        chaining_value[4], chaining_value[5], chaining_value[6], chaining_value[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32,
        block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r != 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    out = [0] * 16
    for i in range(8):
        out[i] = state[i] ^ state[i + 8]
        out[i + 8] = state[i + 8] ^ chaining_value[i]
    return out


def _words_from_block(block: bytes) -> list[int]:
    if len(block) < BLOCK_LEN:
        block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


class _Output:
    """A node ready to produce root output bytes (or its chaining value)."""

    def __init__(self, cv, block_words, counter, block_len, flags):
        self.cv = tuple(cv)
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self) -> tuple[int, ...]:
        return tuple(_compress(self.cv, self.block_words, self.counter,
                               self.block_len, self.flags)[:8])

    def root_output_bytes(self, length: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < length:
            words = _compress(self.cv, self.block_words, counter,
                              self.block_len, self.flags | ROOT)
            out.extend(struct.pack("<16I", *words))
            counter += 1
        return bytes(out[:length])


def _chunk_output(chunk: bytes, chunk_counter: int) -> _Output:
    """Process one chunk (<= 1024 bytes) into its output node."""
    cv = IV
    blocks = [chunk[i:i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    n = len(blocks)
    for i, block in enumerate(blocks[:-1]):
        flags = CHUNK_START if i == 0 else 0
        cv = tuple(_compress(cv, _words_from_block(block), chunk_counter,
                             BLOCK_LEN, flags)[:8])
    flags = CHUNK_END
    if n == 1:
        flags |= CHUNK_START
    return _Output(cv, _words_from_block(blocks[-1]), chunk_counter,
                   len(blocks[-1]), flags)


def _parent_output(left_cv: tuple[int, ...], right_cv: tuple[int, ...]) -> _Output:
    block_words = list(left_cv) + list(right_cv)
    return _Output(IV, block_words, 0, BLOCK_LEN, PARENT)


def _root_node(data: bytes) -> _Output:
    # Split into chunks; build the (left-heavy, largest-power-of-two) binary tree.
    chunks = [data[i:i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)]
    if not chunks:
        chunks = [b""]

    def build(start: int, count: int) -> _Output:
        if count == 1:
            return _chunk_output(chunks[start], start)
        # left subtree gets the largest power of two strictly less than count
        left = 1
        while left * 2 < count:
            left *= 2
        l = build(start, left)
        r = build(start + left, count - left)
        return _parent_output(l.chaining_value(), r.chaining_value())

    return build(0, len(chunks))


def digest(data: bytes) -> bytes:
    """The 32-byte BLAKE3 hash of `data`."""
    return _root_node(data).root_output_bytes(32)


def xof(data: bytes, length: int) -> bytes:
    """The first `length` bytes of BLAKE3's output stream for `data`."""
    return _root_node(data).root_output_bytes(length)
