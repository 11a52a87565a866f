"""KZG setup for the port.

Counterpart of `quill_tpu/pcs/kzg.py:106 KZG.device_setup`, which builds
the CRS with the TPU fixed-base kernel.  The port takes the host setup of
its own `pcs/kzg.py` instead: `cached_trusted_setup` derives tau from the
seed exactly as `device_setup` does, so the CRS points, and with them the
proof bytes, are the same.  The G1 powers are computed by the native C
backend (`native/ec_g1.c`, built by `kernels/build.py: native_lib` at first
use) and cached on disk (`build/crs/`, or `QUILL_CRS_CACHE_DIR`).
`KZG.__init__` then loads the points onto the engine's device
(`TorchEngine.load_points`).
"""

from __future__ import annotations

from .kzg import KZG, cached_trusted_setup


def setup(engine, max_degree: int, seed: int = 0) -> KZG:
    return cached_trusted_setup(engine, max_degree, seed)
