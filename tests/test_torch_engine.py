"""TorchEngine against `quill_tpu.engine.host.HostEngine`, the exact oracle
the JAX package holds its own device engine to (modelled on
`tests/test_device_engine.py`).

The engine runs on the CPU with `min_device_size=1`, so every method takes
its device path: plain torch ops here, the same code that runs on the GPU
around kernels A to D.  Sizes 2^10 to 2^12.

The engine contract (`engine/contract.py`): the port's HostEngine and
TorchEngine define each of its methods with its parameter names, and the
protocol layers above the engine reach the device only through it.
"""

import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from quill_tpu.engine.host import HostEngine
from quill_tpu.fields.bn254 import R
from quill_tpu.piops import virtual_poly as jax_vp

from quill_tpu_torch.engine import contract
from quill_tpu_torch.engine import host as port_host
from quill_tpu_torch.engine.device import TVec, TorchEngine
from quill_tpu_torch.piops import virtual_poly as port_vp

torch.set_num_threads(1)

N = 1 << 10


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for row in rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64):
        out.append(sum(int(w) << (32 * i) for i, w in enumerate(row)) % R)
    return out


@pytest.fixture(scope="module")
def engines():
    return TorchEngine("cpu", min_device_size=1), HostEngine()


@pytest.fixture(scope="module")
def data():
    a, b = _ints(1, N), _ints(2, N)
    a[:4] = [0, 1, R - 1, R - 2]
    return a, b


def _eq(eng, dv, hv):
    assert [int(x) for x in eng.vec_to_ints(dv)] == [int(x) for x in hv]


def test_vectors(engines, data):
    eng, host = engines
    a, _ = data
    da, ha = eng.vec_from_ints(a), host.vec_from_ints(a)
    assert isinstance(da, TVec) and eng.is_vec(da) and eng.vec_len(da) == N
    assert not hasattr(da, "chunks")
    _eq(eng, da, ha)
    _eq(eng, eng.pad(da, N + 37), host.pad(ha, N + 37))
    _eq(eng, eng.reverse(da), host.reverse(ha))
    _eq(eng, eng.slice(da, 5, 300), host.slice(ha, 5, 300))
    _eq(eng, eng.slice(da, 900, 2000), host.slice(ha, 900, 2000))
    _eq(eng, eng.concat([da, eng.slice(da, 0, 7)]),
        host.concat([ha, host.slice(ha, 0, 7)]))


def test_elementwise_and_scalars(engines, data):
    eng, host = engines
    a, b = data
    da, db = eng.vec_from_ints(a), eng.vec_from_ints(b)
    ha, hb = host.vec_from_ints(a), host.vec_from_ints(b)
    _eq(eng, eng.add(da, db), host.add(ha, hb))
    _eq(eng, eng.sub(da, db), host.sub(ha, hb))
    _eq(eng, eng.mul(da, db), host.mul(ha, hb))
    c = 987654321987654321 % R
    _eq(eng, eng.add_scalar(da, c), host.add_scalar(ha, c))
    _eq(eng, eng.mul_scalar(da, R - 1), host.mul_scalar(ha, R - 1))


def test_reductions(engines, data):
    eng, host = engines
    a, b = data
    da, db = eng.vec_from_ints(a), eng.vec_from_ints(b)
    ha, hb = host.vec_from_ints(a), host.vec_from_ints(b)
    assert eng.vsum(da) == host.vsum(ha)
    assert eng.inner(da, db) == host.inner(ha, hb)
    # inner runs over the shorter length
    short = eng.slice(db, 0, 333)
    assert eng.inner(da, short) == host.inner(ha, host.slice(hb, 0, 333))
    assert eng.inner(da, eng.slice(db, 0, 0)) == 0


def test_batch_inverse(engines, data):
    eng, host = engines
    _, b = data
    vals = [x or 7 for x in b[:N - 3]]            # odd length
    _eq(eng, eng.batch_inverse(eng.vec_from_ints(vals)),
        host.batch_inverse(host.vec_from_ints(vals)))
    with pytest.raises(ZeroDivisionError):
        eng.batch_inverse(eng.vec_from_ints([3, 0, 5]))


def test_eq_table_eval_expr_fold(engines, data):
    eng, host = engines
    a, b = data
    point = _ints(3, 10)
    point[1] = 0
    _eq(eng, eng.eq_table(point), host.eq_table(point))
    expr, jax_expr = [
        (vp.Input(0) * vp.Input(1) - vp.Input(2)) * vp.Input(0)
        + vp.Const(R - 3) for vp in (port_vp, jax_vp)]
    c = _ints(4, N)
    dts = [eng.vec_from_ints(x) for x in (a, b, c)]
    hts = [host.vec_from_ints(x) for x in (a, b, c)]
    _eq(eng, eng.eval_expr(dts, expr, N), host.eval_expr(hts, jax_expr, N))
    r = 424242424242424242
    _eq(eng, eng.fold(dts[0], r), host.fold(hts[0], r))


def test_poly_eval_and_quotient(engines, data):
    eng, host = engines
    a, _ = data
    da, ha = eng.vec_from_ints(a), host.vec_from_ints(a)
    for x in (0, 1, 123456789, R - 1):
        assert eng.poly_eval(da, x) == host.poly_eval(ha, x)
        y, q = eng.quotient_by_linear(da, x)
        hy, hq = host.quotient_by_linear(ha, x)
        assert y == hy
        _eq(eng, q, hq)


def test_handoff_by_size(data):
    eng = TorchEngine("cpu", min_device_size=64)
    host = HostEngine()
    a, _ = data
    assert not isinstance(eng.vec_from_ints(a[:63]), TVec)
    da = eng.vec_from_ints(a[:128])
    assert isinstance(da, TVec)
    f = eng.fold(da, 5)                      # 64 elements: still device
    assert isinstance(f, TVec)
    ff = eng.fold(f, 7)                      # 32: handed to the host
    assert not isinstance(ff, TVec)
    assert [int(x) for x in ff] == [int(x) for x in host.fold(
        host.fold(host.vec_from_ints(a[:128]), 5), 7)]
    assert not isinstance(eng.eq_table([1, 2, 3]), TVec)


def _params(fn) -> list[str]:
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("engine", [port_host.HostEngine(),
                                    TorchEngine("cpu")],
                         ids=["host", "torch"])
def test_engines_define_the_contract(engine):
    methods = [n for n, f in vars(contract.Engine).items()
               if inspect.isfunction(f) and not n.startswith("_")]
    assert len(methods) >= 34
    for name in methods:
        assert callable(getattr(type(engine), name, None)), name
        assert (_params(getattr(type(engine), name))
                == _params(getattr(contract.Engine, name))), name


PROTOCOL = ("piops", "pcs", "proof", "frontend", "transcript")
FORBIDDEN = re.compile(
    r"import torch|TVec|\.rows\(\)|engine\.(device|quotient)\b"
    r"|(getattr|hasattr)\(engine\b")


def test_protocol_layers_know_only_the_contract():
    """No module above the engine imports torch, names a device vector or
    the device engine's modules, or probes an engine for a method."""
    pkg = pathlib.Path(contract.__file__).parents[1]
    found = [f"{path.relative_to(pkg)}:{i}: {line.strip()}"
             for layer in PROTOCOL
             for path in sorted((pkg / layer).glob("*.py"))
             for i, line in enumerate(path.read_text().splitlines(), 1)
             if FORBIDDEN.search(line)]
    assert found == []
    engine_dir = pkg / "engine"
    assert not [p for p in engine_dir.glob("*.py")
                if re.search(r"from \.\.pcs\b", p.read_text())]


def test_first_nonzero_matches_host(engines, data):
    """Vectors with their first non-zero at 0, in the middle and nowhere,
    and state pairs (a, b) with their first a[i] != b[i + 1] at 0, in the
    middle and nowhere, on both engines."""
    eng, _ = engines
    host = port_host.HostEngine()
    a, _ = data
    zero = [0] * N
    mid = list(zero)
    mid[N // 2 + 3] = a[7] or 1
    shifted = [0] + a[:-1]                  # shifted[i + 1] == a[i]
    broken = list(shifted)
    broken[N // 3 + 1] = (broken[N // 3 + 1] + 1) % R
    vecs = [a, mid, zero]
    pairs = [(a, a), (a, broken), (a, shifted)]
    got = eng.first_nonzero([eng.vec_from_ints(v) for v in vecs],
                            [(eng.vec_from_ints(x), eng.vec_from_ints(y))
                             for x, y in pairs])
    want = host.first_nonzero([host.vec_from_ints(v) for v in vecs],
                              [(host.vec_from_ints(x), host.vec_from_ints(y))
                               for x, y in pairs])
    assert got == want
    assert want[1:3] == [N // 2 + 3, None]
    assert want[4:] == [N // 3, None]
