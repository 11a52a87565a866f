"""The device CRS of quill_tpu_torch (`ec/fixed_base.py`, kernel J's plain
twin on the CPU, and `KZG.device_setup`) against the JAX package.

- the port's 4-bit signed table (rows |d| 2^(4k) G, 1 <= |d| <= 8) equals
  the nonzero entries d <= 8 of `quill_tpu.ec.fixed_base._build_table`;
- kernel J's twin (plain sums, then `to_affine`) on 16 scalars gives the
  points of `_k_fixed_base_chunk` (plain XLA on the CPU), over the 4-bit
  table and over a 5-bit one; a zero scalar, the identity there, raises;
- `KZG.device_setup` gives the G1 and G2 points of the JAX package's
  `KZG.trusted_setup` with the same seed, and reads its disk cache back;
  on the port's HostEngine (`tau_basis` from the host) the same points;
- `convert.from_device_basis` carries a JAX basis with `affines=None` and
  lazy limbs (as `device_tau_powers` leaves them) into a `TorchBasis`.

Exactness is `==` on canonical integers.
"""

import numpy as np
import pytest
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import P, R
from quill_tpu.fields.limbs import int_to_limbs, ints_to_limbs

from quill_tpu_torch import convert
from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import fixed_base as fb
from quill_tpu_torch.ec import msm as port_msm
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields import device as fd
from quill_tpu_torch.pcs.kzg import KZG

torch.set_num_threads(1)

# scalars at the edges of the 4-bit windows, then random ones
EDGES = [0, 1, 15, 16, R - 1, (1 << 252) - 1, 1 << 200, R - 16]


def _coords12(arrs):
    """JAX (22, ...) Montgomery limb arrays of X, Y, Z -> canonical
    (X, Y, Z) tuples."""
    cols = [convert.limbs12_to_ints(np.asarray(a).reshape(22, -1), True, P)
            for a in arrs]
    return list(zip(*cols))


def test_table_matches_jax():
    from quill_tpu.ec.fixed_base import _build_table

    want = _coords12(_build_table(curve.g1_generator()))   # (64 x 16) rows
    got = fb.boot_table()
    half = 1 << (fb.BOOT_W - 1)
    assert got.shape == (fb.windows(fb.BOOT_W), half, 2, fd.NLIMB) == (
        64, 8, 2, 8)
    xy = fd.to_ints(got.reshape(-1, fd.NLIMB), fd.FQ)
    for k in range(64):
        for d in range(1, half + 1):
            x, y, z = want[16 * k + d]
            assert z == 1
            row = 2 * (k * half + d - 1)
            assert (xy[row], xy[row + 1]) == (x, y)


def test_kernel_j_twin_matches_jax_chunk():
    import jax.numpy as jnp

    from quill_tpu.ec.fixed_base import _build_table, _k_fixed_base_chunk

    rng = np.random.default_rng(12)
    scalars = EDGES + [int(v) % R for v in rng.integers(1, 1 << 62, 8)]
    tx, ty, tz = _build_table(curve.g1_generator())
    out = _k_fixed_base_chunk(jnp.asarray(ints_to_limbs(scalars)),
                              jnp.asarray(tx), jnp.asarray(ty),
                              jnp.asarray(tz))
    want = []
    for x, y, z in _coords12(out):
        zi = pow(z, -1, P) if z else None
        want.append(None if z == 0 else (x * zi % P, y * zi % P))
    assert want[0] is None and scalars[0] == 0
    nz = scalars[1:]
    g = curve.g1_generator()
    for w, table in ((fb.BOOT_W, fb.boot_table()), (5, fb.make_table(5))):
        got = fb.fixed_base(fd.ints_to_tensor(nz), table, w)
        xy = fd.to_ints(got.reshape(-1, fd.NLIMB), fd.FQ)
        assert [(xy[2 * i], xy[2 * i + 1]) for i in range(len(nz))] == \
            want[1:]
        with pytest.raises(ValueError):
            fb.fixed_base(fd.ints_to_tensor(scalars[:2]), table, w)
    for s, p in zip(nz[:3], ed.proj_to_jacobians(
            fb.fixed_base_plain(fd.ints_to_tensor(nz[:3]), fb.boot_table(),
                                fb.BOOT_W))):
        assert _g1(p) == _g1(g.scalar_mul(s))


def _g1(p):
    a = p.to_affine()
    return None if a.infinity else (a.x.v, a.y.v)


def _g2(p):
    a = p.to_affine()
    return (int(a.x.c0), int(a.x.c1), int(a.y.c0), int(a.y.c1))


def test_device_setup_matches_jax_trusted_setup(tmp_path, monkeypatch):
    from quill_tpu.engine.host import HostEngine
    from quill_tpu.pcs.kzg import KZG as JaxKZG

    monkeypatch.setenv("QUILL_CRS_CACHE_DIR", str(tmp_path))
    n = 1 << 6
    want = JaxKZG.trusted_setup(HostEngine(), n)
    eng = TorchEngine("cpu")
    for _ in range(2):      # made, then read back from the disk cache
        kzg = KZG.device_setup(eng, n)
        assert kzg.g1_points is None and kzg.max_degree == n
        assert kzg._basis.length == n + 1
        assert not bool(kzg._basis.inf.any())
        xy = fd.to_ints(kzg._basis.xy.reshape(-1, fd.NLIMB), fd.FQ)
        assert xy == [c for p in want.g1_points for c in (p.x.v, p.y.v)]
        assert [_g2(q) for q in kzg.g2_points] == \
            [_g2(q) for q in want.g2_points]
    assert len(list(tmp_path.iterdir())) == 1


def test_device_setup_on_the_host_engine_matches_jax(tmp_path, monkeypatch):
    from quill_tpu.engine.host import HostEngine
    from quill_tpu.pcs.kzg import KZG as JaxKZG

    from quill_tpu_torch.engine.host import HostEngine as PortHost

    monkeypatch.setenv("QUILL_CRS_CACHE_DIR", str(tmp_path))
    n = 1 << 6
    want = JaxKZG.trusted_setup(HostEngine(), n)
    kzg = KZG.device_setup(PortHost(), n)
    assert kzg.g1_points is None and kzg.max_degree == n
    assert [(p.x.v, p.y.v) for p in kzg._basis] == \
        [(p.x.v, p.y.v) for p in want.g1_points]
    assert [_g2(q) for q in kzg.g2_points] == [_g2(q) for q in want.g2_points]
    assert list(tmp_path.iterdir()) == []


def test_from_device_basis_lazy_chunks():
    """A basis from `quill_tpu.ec.msm.load_basis`, rebuilt as a device-made
    CRS is: no affines, and limbs made lazy (one limb over 12 bits, one
    negative, the value raised by p) without changing the points."""
    from quill_tpu.ec import msm as jax_msm

    g = curve.g1_generator()
    pts = [g.scalar_mul(k).to_affine() for k in (1, 2, 3, 99, 12345, 7)]
    pts.insert(2, curve.Affine(curve.Fq(0), curve.Fq(0), infinity=True))
    src = jax_msm.load_basis(pts)

    def lazy(chunk):
        a = np.asarray(chunk).astype(np.int64)
        a = a + int_to_limbs(P)[:, None]            # value + p
        a[0] += 4096                                # limb 0 over 12 bits
        a[1] -= 1 + 8192                            # limb 1 negative
        a[2] += 2
        assert (a[0] >= 4096).all() and (a[1] < 0).all()
        return a.astype(np.int32)

    basis = jax_msm.DeviceBasis(
        affines=None, x_chunks=[lazy(c) for c in src.x_chunks],
        y_chunks=[lazy(c) for c in src.y_chunks],
        inf_chunks=src.inf_chunks, length=src.length)
    got = convert.from_device_basis(basis)
    want = port_msm.load_basis(pts, "cpu")
    assert got.length == want.length == len(pts)
    assert torch.equal(got.xy, want.xy)
    assert torch.equal(got.inf, want.inf)
