"""ctypes binding for the native C G1 backend (`native/ec_g1.c`).

Host-side counterpart of arkworks' compiled curve code
(`quill-zkvm/pcs/src/kzg.rs:61-73`): Pippenger MSM, batch
normalization, and batched fixed-base scalar multiplication over BN254 G1.
`curve.py` routes its host paths here when the library is present (built by
`kernels/build.py: native_lib` into the port's build directory at first
use); everything falls back to the pure-Python implementation otherwise.
The library is self-checked against the Python oracle once at load time,
like the blake3 backend (`hashing/blake3.py`).

All buffers cross the ABI as canonical (non-Montgomery) little-endian
4x-uint64 words; conversions to/from the internal Montgomery form happen in
C.  QUILL_NATIVE_EC=0 disables the backend.
"""

from __future__ import annotations

import ctypes
import os

_LIB = None

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _words(x: int, out, off: int) -> None:
    for i in range(4):
        out[off + i] = (x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF


def _unwords(buf, off: int) -> int:
    return (int(buf[off]) | (int(buf[off + 1]) << 64)
            | (int(buf[off + 2]) << 128) | (int(buf[off + 3]) << 192))


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if os.environ.get("QUILL_NATIVE_EC", "1") == "0":
        _LIB = False
        return _LIB
    from ..kernels import build

    path = str(build.native_lib("ec_g1"))
    # The self-check oracle routes through curve.msm_host/batch_to_affine,
    # which call back into available() -> _load(): pin the in-progress
    # sentinel FIRST so the oracle runs pure-Python instead of recursing.
    _LIB = False
    try:
        lib = ctypes.CDLL(path)
        lib.quill_g1_msm.argtypes = [_U64P, _U8P, ctypes.c_size_t, _U64P,
                                     _U64P]
        lib.quill_g1_msm.restype = None
        lib.quill_g1_msm_jac.argtypes = [_U64P, ctypes.c_size_t, _U64P, _U64P]
        lib.quill_g1_msm_jac.restype = None
        lib.quill_g1_batch_normalize.argtypes = [_U64P, ctypes.c_size_t,
                                                 _U64P, _U8P]
        lib.quill_g1_batch_normalize.restype = None
        lib.quill_g1_scalar_mul_many.argtypes = [_U64P, ctypes.c_uint8,
                                                 _U64P, ctypes.c_size_t,
                                                 _U64P]
        lib.quill_g1_scalar_mul_many.restype = None
        if hasattr(lib, "quill_g1_gen_series"):
            lib.quill_g1_gen_series.argtypes = [ctypes.c_size_t, _U64P, _U8P]
            lib.quill_g1_gen_series.restype = None
        if not _self_check(lib):
            raise RuntimeError("native ec_g1 self-check failed")
        _LIB = lib
    except Exception as e:
        # the .so exists but is broken: warn once (a silent fallback would
        # show up only as an unexplained host-EC slowdown), keep _LIB=False
        import warnings

        warnings.warn(f"native ec_g1 backend disabled ({e!r}); "
                      "falling back to pure Python", RuntimeWarning)
    return _LIB


def _self_check(lib) -> bool:
    """Small MSM + normalize against the pure-Python oracle."""
    from ..fields.bn254 import R
    from . import curve

    g = curve.g1_generator()
    pts = [g, g.double(), g.double().add(g), g.scalar_mul(7)]
    affs = curve.batch_to_affine(pts)
    scalars = [3, R - 1, 0, 123456789]
    expect = curve.msm_host(affs, scalars)

    n = len(affs)
    pbuf = (ctypes.c_uint64 * (8 * n))()
    ibuf = (ctypes.c_uint8 * n)()
    sbuf = (ctypes.c_uint64 * (4 * n))()
    for i, (a, s) in enumerate(zip(affs, scalars)):
        _words(a.x.v, pbuf, 8 * i)
        _words(a.y.v, pbuf, 8 * i + 4)
        ibuf[i] = 1 if a.infinity else 0
        _words(s % R, sbuf, 4 * i)
    out = (ctypes.c_uint64 * 12)()
    lib.quill_g1_msm(pbuf, ibuf, n, sbuf, out)
    got = curve.Jacobian(curve.Fq(_unwords(out, 0)), curve.Fq(_unwords(out, 4)),
                         curve.Fq(_unwords(out, 8)))
    if not (got == expect):
        return False

    jbuf = (ctypes.c_uint64 * (12 * n))()
    for i, p in enumerate(pts):
        _words(p.X.v, jbuf, 12 * i)
        _words(p.Y.v, jbuf, 12 * i + 4)
        _words(p.Z.v, jbuf, 12 * i + 8)
    abuf = (ctypes.c_uint64 * (8 * n))()
    ninf = (ctypes.c_uint8 * n)()
    lib.quill_g1_batch_normalize(jbuf, n, abuf, ninf)
    for i, a in enumerate(affs):
        if bool(ninf[i]) != a.infinity:
            return False
        if not a.infinity and (_unwords(abuf, 8 * i) != a.x.v
                               or _unwords(abuf, 8 * i + 4) != a.y.v):
            return False
    return True


def available() -> bool:
    return bool(_load())


def msm(affines: list, scalars: list) -> "object":
    """Pippenger MSM over host affine points; returns a curve.Jacobian.
    Caller guarantees G1 points (Fq coords) and canonical int scalars."""
    from . import curve

    lib = _load()
    n = min(len(affines), len(scalars))
    pbuf = (ctypes.c_uint64 * (8 * n))()
    ibuf = (ctypes.c_uint8 * n)()
    sbuf = (ctypes.c_uint64 * (4 * n))()
    for i in range(n):
        a = affines[i]
        if a.infinity:
            ibuf[i] = 1
        else:
            _words(a.x.v, pbuf, 8 * i)
            _words(a.y.v, pbuf, 8 * i + 4)
        _words(int(scalars[i]), sbuf, 4 * i)
    out = (ctypes.c_uint64 * 12)()
    lib.quill_g1_msm(pbuf, ibuf, n, sbuf, out)
    return curve.Jacobian(curve.Fq(_unwords(out, 0)),
                          curve.Fq(_unwords(out, 4)),
                          curve.Fq(_unwords(out, 8)))


def batch_to_affine(points: list) -> list:
    """Batch Jacobian -> Affine for G1 points via the C backend."""
    from . import curve

    lib = _load()
    n = len(points)
    if n == 0:
        return []
    jbuf = (ctypes.c_uint64 * (12 * n))()
    for i, p in enumerate(points):
        _words(p.X.v, jbuf, 12 * i)
        _words(p.Y.v, jbuf, 12 * i + 4)
        _words(p.Z.v, jbuf, 12 * i + 8)
    abuf = (ctypes.c_uint64 * (8 * n))()
    ninf = (ctypes.c_uint8 * n)()
    lib.quill_g1_batch_normalize(jbuf, n, abuf, ninf)
    out = []
    for i in range(n):
        if ninf[i]:
            out.append(curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True))
        else:
            out.append(curve.Affine(curve.Fq(_unwords(abuf, 8 * i)),
                                    curve.Fq(_unwords(abuf, 8 * i + 4))))
    return out


def bench_msm_cpu(log2n: int = 20, seed: int = 0) -> float | None:
    """Measured host-CPU single-thread Pippenger throughput (points/s) at
    2^log2n random-ish scalars over distinct points -- the arkworks-CPU
    stand-in denominator for the headline `vs_baseline` ratio (the C MSM
    uses arkworks' windowing heuristic and CIOS Montgomery arithmetic; the
    reference repo publishes no numbers of its own, BASELINE.md).  Returns
    None when the native backend or the series generator is unavailable."""
    import time

    import numpy as np

    lib = _load()
    if not lib or not hasattr(lib, "quill_g1_gen_series"):
        return None
    n = 1 << log2n
    pbuf = (ctypes.c_uint64 * (8 * n))()
    ibuf = (ctypes.c_uint8 * n)()
    lib.quill_g1_gen_series(n, pbuf, ibuf)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    words[:, 3] >>= 3  # < 2^61 < r: canonical without per-scalar Python mod
    sbuf = (ctypes.c_uint64 * (4 * n))()
    ctypes.memmove(sbuf, words.ctypes.data, 32 * n)
    out = (ctypes.c_uint64 * 12)()
    t0 = time.time()
    lib.quill_g1_msm(pbuf, ibuf, n, sbuf, out)
    dt = time.time() - t0
    return n / dt


def scalar_mul_many(base, scalars: list) -> list:
    """[s * base for s in scalars] as Jacobians (base: G1 Affine)."""
    from . import curve

    lib = _load()
    n = len(scalars)
    bbuf = (ctypes.c_uint64 * 8)()
    binf = 0
    if base.infinity:
        binf = 1
    else:
        _words(base.x.v, bbuf, 0)
        _words(base.y.v, bbuf, 4)
    sbuf = (ctypes.c_uint64 * (4 * n))()
    for i, s in enumerate(scalars):
        _words(int(s), sbuf, 4 * i)
    out = (ctypes.c_uint64 * (12 * n))()
    lib.quill_g1_scalar_mul_many(bbuf, binf, sbuf, n, out)
    return [curve.Jacobian(curve.Fq(_unwords(out, 12 * i)),
                           curve.Fq(_unwords(out, 12 * i + 4)),
                           curve.Fq(_unwords(out, 12 * i + 8)))
            for i in range(n)]
