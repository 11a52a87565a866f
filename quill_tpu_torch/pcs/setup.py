"""KZG setup for the port, as `scripts/prove_tpu.py:68` sets up the JAX
prover: `KZG.device_setup` (`pcs/kzg.py`), the CRS made on the engine's
device by fixed-base tau powers (kernel J), cached on disk (`build/crs/`;
`QUILL_CRS_CACHE_DIR` moves it, `QUILL_CRS_CACHE=0` turns it off).  Tau
comes from the seed as in `KZG.trusted_setup`, so the CRS points, and with
them the proof bytes, are those of the host setup.
"""

from __future__ import annotations

from .kzg import KZG


def setup(engine, max_degree: int, seed: int = 0) -> KZG:
    return KZG.device_setup(engine, max_degree, seed=seed)
