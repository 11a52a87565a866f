"""Host multilinear-extension helpers (independent test oracle).

Counterpart of arkworks `DenseMultilinearExtension::evaluate` as used in the
reference's cross-validation tests (e.g.
`quill-zkvm/pcs/src/mlpcs.rs:283-285`).  Index bit j corresponds to
variable j (LSB = variable 0), matching the sumcheck binding order.
"""

from __future__ import annotations

from ..fields.bn254 import R


def mle_evaluate(evals, point: list[int]) -> int:
    """Evaluate the MLE of `evals` (length 2^n) at `point` (n coordinates)."""
    cur = [int(e) % R for e in evals]
    for r in point:
        r = r % R
        cur = [(cur[2 * p] + r * (cur[2 * p + 1] - cur[2 * p])) % R
               for p in range(len(cur) // 2)]
    assert len(cur) == 1
    return cur[0]
