"""Kernel A's pieces on the CPU: `csrc/sumcheck.cuh` (the program run from
shared-memory slots with its top in registers, the pair loads and the
fold, the NT accumulators) run by the host emulation
`q_sumcheck_round_blocked` (`csrc/bn254_host.cpp`, built with g++) over
emulated blocks, warps and the partials pass, against the plain twin
`sumcheck.round_plain`.

The launch arguments are the wrapper's own (`sumcheck.prepare(expr)
.params()`, the layout of `ScParams`), so the tests check their packing
too.  Expressions: two of the prove's kind (7 and 5 tables, degree 3),
the deepest stack the limits allow (16 tables nested to depth 16), 64
constants, and a single input; degrees 1
to 7; rounds with and without the fold; grids of 1 to 5 blocks of 32 to
128 threads, each striding over several pairs.  Inputs come from a numpy
seed.  Skips only without g++.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from quill_tpu_torch.engine import sumcheck
from quill_tpu_torch.engine.expr import const_tensor
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.kernels import build
from quill_tpu_torch.piops.virtual_poly import Const, Input

torch.set_num_threads(1)

N = 1 << 9          # table rows


def _exprs():
    x = [Input(i) for i in range(16)]
    deep = x[15]
    for i in reversed(range(15)):
        deep = x[i] + deep if i % 2 else x[i] * deep
    many = Const(1)
    for i in range(63):
        many = many * x[i % 3] + Const(i + 5)
    return {
        "zerocheck": ((x[0] * x[1] - x[2]) * x[3]
                      + (x[4] - x[5]) * x[6] * Const(9) + Const(R - 3)),
        "permutation": (x[0] * x[1] - x[2]) * x[3] + x[4] * Const(5),
        "deepest": deep,
        "consts": many,
        "one": x[0],
    }


EXPRS = _exprs()


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(build.build_host()))
    lib.q_sumcheck_round_blocked.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p]
    lib.q_sumcheck_round_blocked.restype = ctypes.c_int
    lib.q_sumcheck_params_size.restype = ctypes.c_long
    assert lib.q_sumcheck_params_size() == ctypes.sizeof(sumcheck.Params)
    return lib


@functools.lru_cache(maxsize=None)
def _tables(k):
    rng = np.random.default_rng(40 + k)
    out = []
    for _ in range(k):
        ints = [int.from_bytes(rng.bytes(32), "little") % R
                for _ in range(N)]
        ints[:3] = [0, 1, R - 1]
        out.append(fd.from_ints(ints))
    return out


def _emulate(lib, tables, expr, degree, r, blocks, block):
    prep = sumcheck.prepare(expr)
    p = prep.params()
    n = tables[0].shape[0]
    folded = []
    for i, t in enumerate(tables):
        p.tables_in[i] = t.data_ptr()
    if r is not None:
        folded = [torch.empty((n // 2, fd.NLIMB), dtype=torch.int32)
                  for _ in tables]
        for i, t in enumerate(folded):
            p.tables_out[i] = t.data_ptr()
        p.r[:] = fd.mont_words(r)
    p.n_pairs = n // 4 if r is not None else n // 2
    p.fold = int(r is not None)
    out = torch.empty((degree + 1, fd.NLIMB), dtype=torch.int32)
    rc = lib.q_sumcheck_round_blocked(ctypes.addressof(p), degree + 1,
                                      prep.slots, blocks, block,
                                      out.data_ptr())
    assert rc == 0
    msgs = [fd.FR.unmont(v) for v in fd.tensor_to_ints(out)]
    return msgs, folded


@pytest.mark.parametrize("fold", [False, True], ids=["round0", "fold"])
@pytest.mark.parametrize("name,degree,blocks,block", [
    ("zerocheck", 3, 2, 32), ("permutation", 3, 1, 64),
    ("deepest", 1, 3, 32), ("deepest", 7, 1, 128),
    ("consts", 2, 5, 32), ("one", 4, 2, 64), ("zerocheck", 5, 1, 32),
    ("permutation", 6, 4, 32)])
def test_round_matches_plain(lib, name, degree, blocks, block, fold):
    expr = EXPRS[name]
    prep = sumcheck.prepare(expr)
    tables = _tables(len(prep.prog.used))
    r = 0xC0FFEE * (degree + 11) % R if fold else None
    got, gf = _emulate(lib, tables, expr, degree, r, blocks, block)
    want, wf = sumcheck.round_plain(tables, prep.prog,
                                    const_tensor(expr, "cpu"), degree, r)
    assert got == want
    for a, b in zip(gf, wf or []):
        assert torch.equal(a, b)


def test_limits_and_slots():
    """The deepest expression fills the stack and table limits (47 slots);
    one constant past the limit raises; an expression object is prepared
    once."""
    deep = sumcheck.prepare(EXPRS["deepest"])
    assert deep.prog.depth == sumcheck.MAX_STACK
    assert len(deep.prog.used) == sumcheck.MAX_TABLES
    assert deep.slots == 2 * 16 + 15
    assert len(sumcheck.prepare(EXPRS["consts"]).consts) == 64
    too_many = EXPRS["consts"] + Const(3)
    with pytest.raises(ValueError):
        sumcheck.prepare(too_many).params()
    assert sumcheck.prepare(EXPRS["one"]) is sumcheck.prepare(EXPRS["one"])
