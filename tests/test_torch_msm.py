"""MSMs through TorchEngine (kernels C and D's plain twins on the CPU)
against `ec/curve.py: msm_host`.

Cases from `scripts/check_msm7.py`: a general basis with a point at
infinity, scalars 0, 1 and r - 1, a batch with short and empty members,
and the tau CRS; plus skewed scalars whose long bucket runs span several
kernel C threads.  Sizes 2^8 to 2^10.
"""

import random

import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import R

from quill_tpu_torch.ec import msm as M
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.pcs.setup import setup

torch.set_num_threads(1)

RNG = random.Random(7)


@pytest.fixture(scope="module")
def general_points():
    g = curve.g1_generator()
    pts, acc = [], g
    for _ in range(64):
        acc = acc.double().add(g)
        pts.append(acc.to_affine())
    pts[5] = curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True)
    return pts * 16                                   # 2^10 points


@pytest.fixture(scope="module")
def engine():
    """Every MSM on kernels C and D: the small route is
    `tests/test_torch_msm5.py`'s."""
    return TorchEngine("cpu", min_device_size=1, msm_small_chunks=0)


@pytest.mark.parametrize("n", [256, 1024])
def test_general_basis_edge_scalars(engine, general_points, n):
    pts = general_points[:n]
    scalars = [RNG.randrange(R) for _ in range(n)]
    scalars[:4] = [0, 1, R - 1, R - 2]
    basis = engine.load_points(pts)
    got = engine.msm(basis, engine.vec_from_ints(scalars))
    assert got == curve.msm_host(pts, scalars)


def test_skewed_scalars_take_extra_levels(engine, general_points):
    pts = general_points[:512]
    scalars = [RNG.randrange(3) for _ in range(512)]   # runs of ~170 points
    basis = engine.load_points(pts)
    s = engine.vec_from_ints(scalars)
    digits = M.signed_digits(fd.from_mont(s.rows()))
    keys, _ = M.sorted_entries(digits, basis.inf)
    _, counts = keys.unique_consecutive(return_counts=True)
    k = M.entries_a_thread(keys.numel())
    assert int(counts.max()) > 4 * k           # over 4+ kernel C threads
    assert engine.msm(basis, s) == curve.msm_host(pts, scalars)


@pytest.mark.parametrize("n,k", [(0, 16), (491_516, 16), (2_097_108, 64),
                                 (4_194_198, 128), (67_107_362, 128)])
def test_entries_a_thread(n, k):
    """Kernel C's K at the entry counts of an empty MSM, the 2^18-point id
    column and uniform 2^17-, 2^18- and 2^22-point MSMs."""
    assert M.entries_a_thread(n) == k


def test_msm_many_short_and_empty(engine, general_points):
    pts = general_points[:256]
    basis = engine.load_points(pts)
    jobs = []
    for n in (256, 100, 1, 0):
        scalars = [RNG.randrange(R) for _ in range(n)]
        jobs.append((engine.basis_slice(basis, n),
                     engine.host.vec_from_ints(scalars)))
    got = engine.msm_many(jobs)
    for (b, s), out in zip(jobs, got):
        n = len(s)
        assert out == curve.msm_host(pts[:n], [int(x) for x in s])
    assert got[-1].is_identity()


def test_tau_crs(engine):
    """The setup's CRS is made on the engine's device and keeps no host
    points; the JAX package's host setup with the same seed gives them."""
    from quill_tpu.engine.host import HostEngine
    from quill_tpu.pcs.kzg import KZG as JaxKZG

    kzg = setup(engine, 255)
    assert kzg.g1_points is None
    scalars = [RNG.randrange(R) for _ in range(256)]
    scalars[:3] = [0, 1, R - 1]
    got = engine.msm(engine.basis_slice(kzg._basis, 256),
                     engine.vec_from_ints(scalars))
    host = JaxKZG.trusted_setup(HostEngine(), 255)
    assert got == curve.msm_host(host.g1_points, scalars)
