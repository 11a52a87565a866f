"""NTT products through TorchEngine (kernel B's plain twins on the CPU)
against HostEngine, at unequal lengths, and the transforms' round trip.
The forward transform's order is internal (bit-reversed), so only
products and round trips are compared here (tests/test_torch_ntt_blocked.py
checks the order)."""

import numpy as np
import pytest
import torch

from quill_tpu.engine.host import HostEngine
from quill_tpu.fields.bn254 import R
from quill_tpu.pcs.ipa import s_polynomial_generic

from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.poly import ntt

torch.set_num_threads(1)


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R
            for row in rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)]


@pytest.fixture(scope="module")
def engines():
    return TorchEngine("cpu", min_device_size=1), HostEngine()


@pytest.mark.parametrize("la,lb", [(1, 1), (1, 9), (300, 1000), (1024, 1024),
                                   (2047, 2)])
def test_poly_mul(engines, la, lb):
    eng, host = engines
    a, b = _ints(la, la), _ints(lb + 7, lb)
    a[0] = R - 1
    got = eng.poly_mul(eng.vec_from_ints(a), eng.vec_from_ints(b))
    want = host.poly_mul(host.vec_from_ints(a), host.vec_from_ints(b))
    assert eng.vec_len(got) == la + lb - 1
    assert [int(x) for x in eng.vec_to_ints(got)] == [int(x) for x in want]


@pytest.mark.parametrize("la,lb", [(1024, 1024), (700, 1024), (1024, 3)])
def test_s_polynomial(engines, la, lb):
    eng, host = engines
    a, b = _ints(2 * la, la), _ints(3 * lb, lb)
    got = eng.s_polynomial(eng.vec_from_ints(a), eng.vec_from_ints(b))
    want = s_polynomial_generic(host, host.vec_from_ints(a),
                                host.vec_from_ints(b))
    assert [int(x) for x in eng.vec_to_ints(got)] == [int(x) for x in want]


def test_ntt_roundtrip_and_twiddles():
    xs = _ints(5, 256)
    t = fd.from_ints(xs)
    assert fd.to_ints(ntt.ntt(ntt.ntt(t), inverse=True)) == xs
    w = ntt.root_of_unity(256)
    assert pow(w, 256, R) == 1 and pow(w, 128, R) != 1
    # row b = 2 of the table: the powers of the 8th root, j = 0 .. 4
    row = ntt.twiddle_table(3, "cpu")[ntt.tw_rows(2):ntt.tw_rows(3)]
    assert fd.to_ints(row) == [
        pow(ntt.root_of_unity(8), k, R) for k in range(5)]
