"""Pure-Python BLAKE3 (hash + XOF), implemented from the public BLAKE3 spec.

The reference transcript is a blake3 hash chain with XOF challenge draws
(`quill-zkvm/transcript/src/transcript.rs:14-62`); the Python `blake3`
binding is not available in this environment, so we implement the function
ourselves.  Transcript messages are small (well under one 1024-byte chunk in
virtually all protocol events), so pure Python is fast enough; a C extension
backend can be slotted in behind `blake3_digest`/`blake3_xof` later.
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


def _py_digest(data: bytes) -> bytes:
    return _root_node(data).root_output_bytes(32)


def _py_xof(data: bytes, length: int) -> bytes:
    return _root_node(data).root_output_bytes(length)


# -- native backend (ctypes over native/blake3.c), Python fallback -----------

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes

    from ..kernels import build

    path = str(build.native_lib("blake3"))
    try:
        lib = ctypes.CDLL(path)
        lib.quill_blake3.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        lib.quill_blake3.restype = None
        # self-check against the Python implementation before trusting it
        probe = bytes(range(200))
        buf = (ctypes.c_uint8 * 64)()
        lib.quill_blake3(probe, len(probe), buf, 64)
        if bytes(buf) != _py_xof(probe, 64):
            raise RuntimeError("native blake3 self-check failed")
        _NATIVE = lib
    except Exception:
        _NATIVE = False
    return _NATIVE


def blake3_digest(data: bytes) -> bytes:
    """32-byte BLAKE3 hash (native C backend when available)."""
    lib = _load_native()
    if lib:
        import ctypes

        buf = (ctypes.c_uint8 * 32)()
        lib.quill_blake3(data, len(data), buf, 32)
        return bytes(buf)
    return _py_digest(data)


def blake3_xof(data: bytes, length: int) -> bytes:
    """Extendable output: first `length` bytes of the BLAKE3 output stream."""
    lib = _load_native()
    if lib:
        import ctypes

        buf = (ctypes.c_uint8 * length)()
        lib.quill_blake3(data, len(data), buf, length)
        return bytes(buf)
    return _py_xof(data, length)
