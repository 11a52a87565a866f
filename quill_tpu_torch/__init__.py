"""quill_tpu_torch: the HyperPlonk prover of `quill_tpu` on PyTorch and CUDA.

The host protocol modules (`transcript/`, `hashing/`, `piops/`, `proof/`,
`frontend/`, `pcs/`, `ec/{curve,pairing,tower,native_ec}.py`,
`fields/{bn254,scalar,limbs}.py`, `engine/host.py`, `utils/`) are the port's
own copies of the JAX package's modules; the port imports nothing of
`quill_tpu`.  Paths written `quill-zkvm/...` in their docstrings name files
of the Rust project gio54321/quill-zkvm that both packages follow.
"""
