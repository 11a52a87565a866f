"""Kernel I's plain twin (`quill_tpu_torch/ec/msm8.py: seg_scan`) against
the Pallas kernel it replaces, `quill_tpu.fields.pallas8.seg_scan`, run in
interpret mode on the CPU.

One call at the smallest shape, S = 8 steps x M = 128 lanes, sub = 1:
~80 s on one CPU core, nearly all of it tracing and compiling the
interpreted kernel, which is why this file holds nothing else.  Random
projective points (some the identity) and random flags come from a numpy
seed; the JAX layout is (S, 3L, M) f32 8-bit limbs with the Montgomery
radix 2^264, the port's (M, S, 3, 8) uint32 limbs with radix 2^256, so both
sides are compared as canonical integers.  Both use the same complete
addition formula, so every (X, Y, Z) triple is equal, not only the points.
"""

import numpy as np
import torch

from quill_tpu.ec import curve
from quill_tpu.fields.bn254 import P

from quill_tpu_torch.ec import device as ed
from quill_tpu_torch.ec import msm8
from quill_tpu_torch.fields import device as fd

torch.set_num_threads(1)

S, M = 8, 128
JAX_R = 1 << 264


def test_seg_scan_twin_matches_pallas():
    import jax.numpy as jnp

    from quill_tpu.fields import device8 as f8
    from quill_tpu.fields import pallas8

    rng = np.random.default_rng(11)
    g = curve.g1_generator()
    pts = [g.scalar_mul(int(k)) for k in rng.integers(1, 1 << 40, S * M)]
    for i in rng.choice(S * M, 40, replace=False):
        pts[i] = curve.Jacobian.identity(curve.Fq(1))
    flags = rng.random((M, S)) < 0.3
    xs = ed.jacobians_to_proj(pts).reshape(M, S, 3, fd.NLIMB)
    vals = np.array(fd.to_ints(xs.reshape(-1, fd.NLIMB), fd.FQ),
                    dtype=object).reshape(M, S, 3)

    lim = f8.L
    jx = np.zeros((S, 3 * lim, M), np.float32)
    for c in range(3):
        mont = [int(v) * JAX_R % P for v in vals[:, :, c].T.reshape(-1)]
        jx[:, c * lim:(c + 1) * lim] = f8.ints_to_limbs8(mont).reshape(
            lim, S, M).transpose(1, 0, 2)
    jf = flags.T.astype(np.float32)[:, None, :]
    ys = np.asarray(pallas8.seg_scan(jnp.asarray(jx), jnp.asarray(jf), sub=1))

    r_inv = pow(JAX_R, -1, P)
    weights = [1 << (8 * i) for i in range(lim)]
    want = np.empty((M, S, 3), dtype=object)
    for s in range(S):
        for c in range(3):
            limbs = ys[s, c * lim:(c + 1) * lim].astype(np.int64)
            for m in range(M):
                v = sum(int(a) * w for a, w in zip(limbs[:, m], weights))
                want[m, s, c] = v % P * r_inv % P

    got = msm8.seg_scan(xs.contiguous(), torch.from_numpy(flags))
    got = np.array(fd.to_ints(got.reshape(-1, fd.NLIMB), fd.FQ),
                   dtype=object).reshape(M, S, 3)
    assert (got == want).all()
