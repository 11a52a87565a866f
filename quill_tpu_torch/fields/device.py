"""Plain-PyTorch BN254 prime-field arithmetic (Fr and Fq).

Counterpart of `quill_tpu/fields/device.py` (12-bit XLA limbs) and
`quill_tpu/fields/device8.py` (8-bit Pallas limbs).  The port has ONE
layout: a vector of field elements is an `(n, 8)` `torch.int32` tensor whose
rows hold the value's eight uint32 limbs (bit patterns), little-endian, in
Montgomery form with radix R = 2^256, always canonical (< modulus).  The
JAX radix is 2^264, so limb arrays do not carry over bit for bit:
`quill_tpu_torch/convert.py` converts through canonical integers.

Arithmetic widens to int64 and works on sixteen 16-bit halves ("w16" form,
`(..., 16)` int64): a 16x16 limb product is < 2^32 and a column of sixteen
of them < 2^36, so nothing overflows.  Montgomery reduction is done in one
shot (m = T_low * (-p^-1) mod 2^256, then (T + m p) / 2^256, both products
by a constant as exact float64 matrix products), and carries
are resolved without data-dependent loops: a few fixed carry passes bring
every limb to [0, 2^16], then a carry-lookahead step settles the rest
(the carry into limb k is the sign of the highest non-trivial limb below
it, read off a running sum of signs times powers of two, computed as an
exact float64 product with a triangular matrix).  No op
synchronises with the device, so the same code serves as the engine's
elementwise path on the GPU and as the plain twin of every CUDA kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bn254 import P, R
from .scalar import inv

NLIMB = 8          # uint32 limbs per element in storage
NW = 16            # 16-bit limbs per element in w16 form
MASK16 = 0xFFFF
R_BITS = 256
R256 = 1 << R_BITS


class Field:
    """One prime modulus and its Montgomery constants (Python ints)."""

    def __init__(self, name: str, modulus: int):
        self.name = name
        self.modulus = modulus
        self.one_mont = R256 % modulus
        self.r2 = R256 * R256 % modulus
        self.r_inv = pow(R256, -1, modulus)
        self.n_prime = (-pow(modulus, -1, R256)) % R256

    def __repr__(self):
        return f"Field({self.name})"

    def mont(self, x: int) -> int:
        """Canonical int -> its Montgomery representative (an int)."""
        return int(x) % self.modulus * self.one_mont % self.modulus

    def unmont(self, x: int) -> int:
        return int(x) * self.r_inv % self.modulus


FR = Field("fr", R)
FQ = Field("fq", P)


# ---------------------------------------------------------------------------
# constants on a device
# ---------------------------------------------------------------------------


def _w16_of_int(x: int) -> list[int]:
    return [(x >> (16 * i)) & MASK16 for i in range(NW)]


@lru_cache(maxsize=None)
def _consts(device: str, name: str):
    f = FR if name == "fr" else FQ
    dev = torch.device(device)
    i = torch.arange(NW, device=dev)
    ij = (i[:, None] + i[None, :]).reshape(-1)
    p = _w16_of_int(f.modulus)
    npr = _w16_of_int(f.n_prime)
    # products by the constants n' and p as float64 matrices (Toeplitz
    # bands): row i of `np2` takes 16-bit digit i of the low columns, row
    # 16 + i the carry (< 2^20) above it, one limb higher
    np2 = torch.zeros((2 * NW, NW), dtype=torch.float64)
    pt = torch.zeros((NW, 2 * NW), dtype=torch.float64)
    for i in range(NW):
        for k in range(NW):
            pt[i, i + k] = p[k]
            if i + k < NW:
                np2[i, i + k] = npr[k]
            if i + k + 1 < NW:
                np2[NW + i, i + k + 1] = npr[k]
    return {
        "p": torch.tensor(p, dtype=torch.int64, device=dev),
        # product column of limb pair (i, j)
        "ij": ij,
        "np2": np2.to(dev),
        "pt": pt.to(dev),
        # weight 2^(16 k - 256) of low column k
        "lo_scale": torch.tensor([2.0 ** (16 * k - R_BITS) for k in range(NW)],
                                 dtype=torch.float64, device=dev),
    }


@lru_cache(maxsize=None)
def _pow2(device: str, n: int) -> torch.Tensor:
    return torch.tensor([1 << k for k in range(n)], dtype=torch.int64,
                        device=torch.device(device))


@lru_cache(maxsize=None)
def _upper(device: str, n: int) -> torch.Tensor:
    return torch.triu(torch.ones((n, n), dtype=torch.float64,
                                 device=torch.device(device)))


def _signed_prefix(x: torch.Tensor, y) -> torch.Tensor:
    """Running sums along the limbs of sign(x - y) * 2^k.  A float64
    product with an upper-triangular ones matrix: every partial sum is an
    integer below 2^33, so it is exact whatever the summation order, and
    much faster than an int64 cumsum over 16 or 32 limbs."""
    n = x.shape[-1]
    dev = str(x.device)
    v = (torch.sign(x - y) * _pow2(dev, n)).to(torch.float64)
    return (v @ _upper(dev, n)).to(torch.int64)


def _c(field: Field, t: torch.Tensor):
    return _consts(str(t.device), field.name)


# ---------------------------------------------------------------------------
# storage <-> w16
# ---------------------------------------------------------------------------


def to_w16(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 storage -> (..., 16) int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((v & MASK16, v >> 16), dim=-1).reshape(
        *x.shape[:-1], NW)


def from_w16(w: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 normalized limbs -> (..., 8) int32 storage."""
    v = w[..., 0::2] | (w[..., 1::2] << 16)
    v = torch.where(v >= (1 << 31), v - (1 << 32), v)
    return v.to(torch.int32)


# ---------------------------------------------------------------------------
# carries without data-dependent loops
# ---------------------------------------------------------------------------


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    c = x >> 16
    x = x & MASK16
    x[..., 1:] += c[..., :-1]       # the top limb's carry is dropped
    return x


def _lookahead(x: torch.Tensor) -> torch.Tensor:
    """Limbs in [0, 2^16] -> normalized limbs (top carry dropped).  The
    carry into limb k is 1 iff the highest limb below k that differs from
    0xFFFF exceeds it."""
    key = _signed_prefix(x, MASK16)
    cin = torch.zeros_like(x)
    cin[..., 1:] = (key[..., :-1] > 0).to(torch.int64)
    return (x + cin) & MASK16


def normalize(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Non-negative limbs below 2^(16 + 16 * (passes - 1)) -> normalized
    16-bit limbs of the same value modulo 2^(16 * width)."""
    x = x.clone()
    for _ in range(passes):
        x = _carry_pass(x)
    return _lookahead(x)


def _cmp_key(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sign of (x - y) for normalized limb vectors: > 0, == 0 or < 0."""
    return _signed_prefix(x, y)[..., -1]


def _borrow_sub(x: torch.Tensor, y: torch.Tensor, key: torch.Tensor):
    """(x - y) mod 2^(16 width) for normalized limbs, given the running
    comparison key of (x, y): the borrow into limb k is set iff x < y on
    the limbs below k."""
    bin_ = torch.zeros_like(x)
    bin_[..., 1:] = (key[..., :-1] < 0).to(torch.int64)
    bout = torch.zeros_like(x)
    bout[..., :-1] = bin_[..., 1:]
    return x - y - bin_ + (bout << 16)


def _exact_sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y for normalized limbs with x >= y (borrow lookahead)."""
    return _borrow_sub(x, y, _signed_prefix(x, y))


def _cond_sub(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x in [0, 2p) -> x mod p (normalized limbs)."""
    p = p.expand_as(x)
    key = _signed_prefix(x, p)
    return torch.where((key[..., -1:] >= 0), _borrow_sub(x, p, key), x)


# ---------------------------------------------------------------------------
# w16 arithmetic (canonical in, canonical out)
# ---------------------------------------------------------------------------


def w_add(a, b, field: Field):
    c = _c(field, a)
    s = _lookahead(_carry_pass(a + b))
    return _cond_sub(s, c["p"])


def w_sub(a, b, field: Field):
    c = _c(field, a)
    a, b = torch.broadcast_tensors(a, b)
    lt = (_cmp_key(a, b) < 0).to(torch.int64).unsqueeze(-1)
    ap = _lookahead(_carry_pass(a + c["p"] * lt))     # a + p < 2^255
    return _exact_sub(ap, b)


def w_neg(a, field: Field):
    c = _c(field, a)
    p = c["p"]
    out = _exact_sub(p.expand_as(a), a)
    zero = (a == 0).all(-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(out), out)


# rows per w_mul pass, which bounds the (rows, 256) int64 product
# temporaries: on a CPU small enough that they stay in cache, on a GPU
# large, so that a product is few launches
MUL_CHUNK = {"cpu": 1 << 14}
MUL_CHUNK_DEFAULT = 1 << 20


def w_mul(a, b, field: Field):
    """Montgomery product a * b / 2^256 mod p of canonical w16 operands."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    rows = a.numel() // NW
    chunk = MUL_CHUNK.get(a.device.type, MUL_CHUNK_DEFAULT)
    if rows <= chunk:
        return _w_mul(a, b, field)
    a = a.reshape(rows, NW)
    b = b.reshape(rows, NW)
    out = torch.cat([_w_mul(a[i:i + chunk], b[i:i + chunk], field)
                     for i in range(0, rows, chunk)], 0)
    return out.reshape(*lead, NW)


def _w_mul(a, b, field: Field):
    """Products by n' and p are float64 matrix products: every column sum
    is an integer below 2^53, so they are exact in any summation order."""
    c = _c(field, a)
    lead = a.shape[:-1]
    f64 = torch.float64
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(*lead, NW * NW)
    t = torch.zeros(*lead, 2 * NW, dtype=torch.int64, device=a.device)
    t.index_add_(-1, c["ij"], prod)                      # columns < 2^36
    lo = t[..., :NW]
    digits = torch.cat((lo & MASK16, lo >> 16), -1).to(f64)
    m = (digits @ c["np2"]).to(torch.int64)              # columns < 2^41
    m = normalize(m, passes=3)                           # T n' mod 2^256
    t = t + (m.to(f64) @ c["pt"]).to(torch.int64)        # columns < 2^37
    # the low half of T + m p is 0 mod 2^256: its carry into the high half
    # is exactly sum_k t_k 2^(16 k - 256), an integer below 2^23, which
    # float64 rounding (error < 2^-26 here) cannot move off
    carry = torch.round(t[..., :NW].to(f64) @ c["lo_scale"])
    hi = t[..., NW:].clone()
    hi[..., 0] += carry.to(torch.int64)
    return _cond_sub(normalize(hi, passes=3), c["p"])    # < 2p -> < p


def w_const(x: int, field: Field, device, montgomery: bool = True):
    """A field constant as a (16,) w16 tensor (Montgomery form by default)."""
    v = field.mont(x) if montgomery else int(x) % field.modulus
    return torch.tensor(_w16_of_int(v), dtype=torch.int64,
                        device=torch.device(device))


# ---------------------------------------------------------------------------
# storage-level API: (n, 8) int32 Montgomery tensors
# ---------------------------------------------------------------------------


def add(a, b, field: Field = FR):
    return from_w16(w_add(to_w16(a), to_w16(b), field))


def sub(a, b, field: Field = FR):
    return from_w16(w_sub(to_w16(a), to_w16(b), field))


def neg(a, field: Field = FR):
    return from_w16(w_neg(to_w16(a), field))


def mul(a, b, field: Field = FR):
    return from_w16(w_mul(to_w16(a), to_w16(b), field))


def mont_words(x: int, field: Field = FR) -> list[int]:
    """A field element's Montgomery form as NLIMB uint32 words, low first
    (a kernel argument passed by value)."""
    v = field.mont(x)
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NLIMB)]


def const(x: int, field: Field, device, montgomery: bool = True):
    """A constant as an (8,) int32 storage row."""
    return from_w16(w_const(x, field, device, montgomery))


def add_scalar(a, c: int, field: Field = FR):
    return from_w16(w_add(to_w16(a), w_const(c, field, a.device), field))


def mul_scalar(a, c: int, field: Field = FR):
    return from_w16(w_mul(to_w16(a), w_const(c, field, a.device), field))


def powers(x: int, n: int, field: Field = FR, device="cpu") -> torch.Tensor:
    """(n, 8) Montgomery tensor of x^j for j < n, by doubling: the block
    [L, 2L) is the block [0, L) times x^L."""
    cur = w_const(1, field, device).unsqueeze(0)
    step = int(x) % field.modulus
    while cur.shape[0] < n:
        cur = torch.cat((cur, w_mul(cur, w_const(step, field, device),
                                    field)), 0)
        step = step * step % field.modulus
    return from_w16(cur[:n])


def to_mont(a, field: Field = FR):
    """Canonical values -> Montgomery form (multiply by R^2 / R)."""
    r2 = torch.tensor(_w16_of_int(field.r2), dtype=torch.int64,
                      device=a.device)
    return from_w16(w_mul(to_w16(a), r2, field))


def from_mont(a, field: Field = FR):
    """Montgomery form -> canonical values (multiply by 1 / R)."""
    one = torch.tensor(_w16_of_int(1), dtype=torch.int64, device=a.device)
    return from_w16(w_mul(to_w16(a), one, field))


def vsum(a, field: Field = FR) -> int:
    """Sum of a Montgomery vector, as a canonical int: int64 column sums of
    the uint32 limbs (exact below 2^31 rows), finished on the host."""
    if a.shape[0] == 0:
        return 0
    sums = (a.to(torch.int64) & 0xFFFFFFFF).sum(0).cpu().tolist()
    total = sum(int(v) << (32 * i) for i, v in enumerate(sums))
    return field.unmont(total % field.modulus)


def batch_inverse(t: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """Elementwise inverses by a product tree: pair products up to the
    root, one host inversion, then back down (inverse of a child = inverse
    of its parent times its sibling).  A zero raises ZeroDivisionError,
    like `HostEngine.batch_inverse`."""
    n = t.shape[0]
    if n == 0:
        return t.clone()
    if bool((t == 0).all(-1).any()):
        raise ZeroDivisionError("inverse of zero field element in batch")
    one = w_const(1, field, t.device).unsqueeze(0)
    levels = []
    cur = to_w16(t)
    while True:
        if cur.shape[0] % 2 and cur.shape[0] > 1:
            cur = torch.cat((cur, one), 0)
        levels.append(cur)
        if cur.shape[0] == 1:
            break
        cur = w_mul(cur[0::2], cur[1::2], field)
    root = field.unmont(tensor_to_ints(from_w16(levels[-1]))[0])
    acc = w_const(inv(root, field.modulus), field, t.device).unsqueeze(0)
    for level in reversed(levels[:-1]):
        left, right = level[0::2], level[1::2]
        acc = acc[:left.shape[0]]
        both = w_mul(torch.stack((right, left), 1), acc.unsqueeze(1), field)
        acc = both.reshape(-1, NW)
    return from_w16(acc[:n])


# ---------------------------------------------------------------------------
# Python ints <-> tensors
# ---------------------------------------------------------------------------


# values converted from Python ints by each path, over the process: `bulk`
# one C call over the list (`native/pyints.c`), `python` int by int
CONVERSIONS = {"bulk": 0, "python": 0}

_BULK: dict = {}


def _bulk_fn():
    """`quill_ints_to_words` of `native/pyints.c`, built at first use and
    checked against the Python path once; None where it cannot be built."""
    if "fn" not in _BULK:
        import ctypes

        from ..kernels import build

        fn = None
        try:
            lib = ctypes.PyDLL(str(build.native_lib("pyints")))
            fn = lib.quill_ints_to_words
            fn.argtypes = [ctypes.py_object, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_ssize_t
            probe = [0, 1, (1 << 64) - 1, 1 << 64, R - 1, R, (1 << 256) - 1,
                     3 << 200]
            out = torch.empty((len(probe), NLIMB), dtype=torch.int32)
            mod = _mod_words(R)
            if (fn(probe, out.data_ptr(), mod.data_ptr()) != len(probe)
                    or _limbs_python([x % R for x in probe]).tolist()
                    != out.tolist()):
                raise RuntimeError("native pyints self-check failed")
        except Exception:
            fn = None
        _BULK["fn"] = fn
    return _BULK["fn"]


@lru_cache(maxsize=None)
def _mod_words(modulus: int) -> torch.Tensor:
    return torch.tensor(np.frombuffer(modulus.to_bytes(32, "little"),
                                      dtype="<u4").view(np.int32))


def _limbs_python(xs: list) -> torch.Tensor:
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(-1, NLIMB)
    return torch.from_numpy(arr.copy())


def _limbs_bulk(xs: list, modulus: int | None) -> torch.Tensor | None:
    """(n, 8) int32 host limbs of a list of exact ints in [0, 2^256),
    reduced below `modulus` if given, in one C call; None where the list
    holds anything else or the library is missing."""
    fn = _bulk_fn()
    if fn is None:
        return None
    out = torch.empty((len(xs), NLIMB), dtype=torch.int32)
    mod = None if modulus is None else _mod_words(modulus).data_ptr()
    if fn(xs, out.data_ptr(), mod) != len(xs):
        return None
    return out


def _limbs(xs, modulus: int | None) -> torch.Tensor:
    """(n, 8) int32 host limbs of `xs`, reduced below `modulus` if given:
    in one C call where `xs` is a list of exact ints in [0, 2^256), else
    value by value (`CONVERSIONS` counts each path)."""
    xs = xs if type(xs) is list else list(xs)
    limbs = _limbs_bulk(xs, modulus)
    if limbs is not None:
        CONVERSIONS["bulk"] += len(xs)
        return limbs
    CONVERSIONS["python"] += len(xs)
    if modulus is not None:
        xs = [int(x) % modulus for x in xs]
    return _limbs_python(xs)


def ints_to_tensor(xs, device="cpu") -> torch.Tensor:
    """Ints in [0, 2^256) -> (n, 8) int32 limbs (no Montgomery)."""
    return _limbs(xs, None).to(torch.device(device))


def tensor_to_ints(t: torch.Tensor) -> list[int]:
    """(n, 8) int32 limbs -> list of ints (no Montgomery)."""
    data = t.detach().to("cpu").contiguous().numpy().astype("<i4").tobytes()
    return [int.from_bytes(data[32 * i:32 * i + 32], "little")
            for i in range(t.shape[0])]


def from_ints(xs, field: Field = FR, device="cpu") -> torch.Tensor:
    """Ints (any range) -> (n, 8) Montgomery tensor on `device`."""
    return to_mont(_limbs(xs, field.modulus).to(torch.device(device)),
                   field)


def to_ints(t: torch.Tensor, field: Field = FR) -> list[int]:
    """Montgomery tensor -> canonical ints."""
    return tensor_to_ints(from_mont(t, field))
