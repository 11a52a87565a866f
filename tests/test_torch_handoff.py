"""A whole proof across the port's host/device handoff.

A 2^9-row Fibonacci proof with `min_device_size=64` (tables and folds on
both sides of the handoff, MSMs on kernels C and D) is byte-identical to
the JAX package's HostEngine proof.  It sits in a file of its own so that
a run that spreads test files over workers runs it beside
`tests/test_torch_proof.py`.  The circuits are built twice, from the
port's modules and from the JAX package's, by the same code.
"""

import torch

from quill_tpu_torch.engine.device import TorchEngine
from tests.test_torch_proof import fibonacci, port_prove_bytes

torch.set_num_threads(1)


def jax_package():
    from quill_tpu.frontend import transition_circuit
    from quill_tpu.piops import virtual_poly
    from quill_tpu.proof import hyperplonk

    return transition_circuit, virtual_poly, hyperplonk


def host_prove_bytes(circuit, trace) -> bytes:
    from quill_tpu.engine.host import HostEngine
    from quill_tpu.pcs.kzg import cached_trusted_setup
    from quill_tpu.pcs.mlpcs import MultilinearPCS as JaxPCS
    from quill_tpu.proof import hyperplonk
    from quill_tpu.utils import proof_io as jax_io

    pcs = JaxPCS(cached_trusted_setup(
        HostEngine(), circuit.num_cols() * circuit.num_rows()))
    hp = hyperplonk.HyperPlonk.preprocess([circuit], pcs)
    proof = hp.prove([trace])
    hyperplonk.verify(proof, hp.to_vk(), pcs, batch_pairings=True)
    return jax_io.serialize_proof(proof)


def test_handoff_proof_matches_host():
    """Its MSMs take kernels C and D: the small route's plain twins, at
    2^11-point bases, would take minutes on a CPU."""
    port = port_prove_bytes(
        TorchEngine("cpu", min_device_size=64, msm_small_chunks=0),
        *fibonacci(1 << 9))
    host = host_prove_bytes(*fibonacci(1 << 9, jax_package()))
    assert port == host
