"""Whole proofs through quill_tpu_torch: the slice end to end.

- The 8-row Fibonacci proofs of `tests/test_golden_proof_bytes.py`, proved
  with `TorchEngine(min_device_size=1)` so every engine call takes its
  device path, match the pinned sha256.  The first one runs in a fresh
  interpreter that imports neither jax nor any module of `quill_tpu`, and
  takes the default MSM routes (the small route, at this size); the second
  sends every MSM through kernels C and D.

`fibonacci` and `modified_fibonacci` build a circuit from the port's
modules or, given them, from the JAX package's, by the same code; the
other test files of whole proofs take them from here.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.fields.bn254 import R
from quill_tpu_torch.frontend import transition_circuit as port_tc
from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
from quill_tpu_torch.pcs.setup import setup
from quill_tpu_torch.piops import virtual_poly as port_vp
from quill_tpu_torch.proof import hyperplonk as port_hp
from quill_tpu_torch.utils import proof_io

# This module loads nothing of jax or quill_tpu when it is imported: the
# subprocess below imports `fibonacci` from it.

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = (port_tc, port_vp, port_hp)


def golden(name: str):
    from tests.test_golden_proof_bytes import GOLDEN

    return GOLDEN[name]


def fibonacci(rows: int, pkg=PORT):
    """The circuit and witness of scripts/prove_tpu.py at `rows` rows."""
    tc, vp, hp = pkg
    circuit = tc.TransitionCircuit.new(rows)
    s1 = circuit.allocate_state_cell()
    s2 = circuit.allocate_state_cell()
    circuit.enforce_boundary_constraint(0, s1.current.to_expr())
    circuit.enforce_boundary_constraint(0, s2.current.to_expr() - vp.Const(1))
    circuit.enforce_constraint(
        s2.next.to_expr() - (s1.current.to_expr() + s2.current.to_expr()))
    circuit.enforce_constraint(s1.next.to_expr() - s2.current.to_expr())
    witness = [[0] * rows for _ in range(circuit.num_cols())]
    a, b = 0, 1
    for row in range(rows):
        witness[s1.current.col][row] = a
        witness[s2.current.col][row] = b
        witness[s1.next.col][row] = b
        witness[s2.next.col][row] = (a + b) % R
        a, b = b, (a + b) % R
    return circuit, hp.TraceWitness(columns=witness)


def modified_fibonacci(pkg=PORT):
    """`tests/test_hyperplonk.py: get_modified_fibonacci_circuit_and_trace`:
    f(n) = f(n-1) + f(n-1) f(n-2), with a mul gate through a tmp column."""
    tc, vp, hp = pkg
    circuit = tc.TransitionCircuit.new(8)
    s1 = circuit.allocate_state_cell()
    s2 = circuit.allocate_state_cell()
    tmp = circuit.allocate_witness_cell()
    circuit.enforce_boundary_constraint(0, s1.current.to_expr() - vp.Const(1))
    circuit.enforce_boundary_constraint(0, s2.current.to_expr() - vp.Const(1))
    circuit.enforce_constraint(
        tmp.to_expr() - s1.current.to_expr() * s2.current.to_expr())
    circuit.enforce_constraint(
        s2.next.to_expr() - (s1.current.to_expr() + tmp.to_expr()))
    circuit.enforce_constraint(s1.next.to_expr() - s2.current.to_expr())
    witness = [[0] * 8 for _ in range(circuit.num_cols())]
    a, b = 1, 1
    for row in range(8):
        witness[s1.current.col][row] = a
        witness[s2.current.col][row] = b
        witness[s1.next.col][row] = b
        witness[tmp.col][row] = a * b % R
        witness[s2.next.col][row] = (a + a * b) % R
        a, b = b, (a + a * b) % R
    return circuit, hp.TraceWitness(columns=witness)


# proves and verifies the 8-row Fibonacci circuit through the port, then
# reports the proof hash and which packages were ever imported
PORT_PROVE = r"""
import hashlib, json, sys
import torch
torch.set_num_threads(1)
from quill_tpu_torch.engine.device import TorchEngine
from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
from quill_tpu_torch.pcs.setup import setup
from quill_tpu_torch.proof import hyperplonk
from quill_tpu_torch.utils import proof_io
from tests.test_torch_proof import fibonacci

engine = TorchEngine("cpu", min_device_size=1)
circuit, trace = fibonacci(8)
pcs = MultilinearPCS(setup(engine, circuit.num_cols() * circuit.num_rows()))
hp = hyperplonk.HyperPlonk.preprocess([circuit], pcs)
proof = hp.prove([trace])
hyperplonk.verify(proof, hp.to_vk(), pcs, batch_pairings=True)
data = proof_io.serialize_proof(proof)
print(json.dumps({"sha256": hashlib.sha256(data).hexdigest(),
                  "len": len(data), "routes": engine.msm_counts,
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")),
                  "quill_tpu": sorted(m for m in sys.modules
                                      if m == "quill_tpu"
                                      or m.startswith("quill_tpu."))}))
"""


def port_prove_bytes(engine, circuit, trace) -> bytes:
    pcs = MultilinearPCS(setup(engine,
                               circuit.num_cols() * circuit.num_rows()))
    hp = port_hp.HyperPlonk.preprocess([circuit], pcs)
    proof = hp.prove([trace])
    port_hp.verify(proof, hp.to_vk(), pcs, batch_pairings=True)
    return proof_io.serialize_proof(proof)


@pytest.fixture(scope="module")
def port_run():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", PORT_PROVE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_fibonacci_proof_bytes_golden(port_run):
    """Every MSM of the 8-row proof takes the small route."""
    want_hash, want_len = golden("fib")
    assert port_run["len"] == want_len
    assert port_run["sha256"] == want_hash
    assert port_run["routes"]["cd"] == 0 and port_run["routes"]["small"] > 0


def test_port_prove_never_imports_jax(port_run):
    assert port_run["jax"] == []
    assert port_run["quill_tpu"] == []


def test_modified_fibonacci_proof_bytes_golden():
    circuit, trace = modified_fibonacci()
    data = port_prove_bytes(
        TorchEngine("cpu", min_device_size=1, msm_small_chunks=0),
        circuit, trace)
    want_hash, want_len = golden("fib2")
    assert len(data) == want_len
    assert hashlib.sha256(data).hexdigest() == want_hash
