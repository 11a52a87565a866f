"""Faults planted in the program's timed path.  The control and the tests
run a cell with one of them and require `correct` to come out false.

- msm_altered: an answer altered where it is produced: every batched MSM's
  first result plus the generator (the witness and S commitments, the
  openings).
- msm_half: half of the batch left out: every MSM's scalars past the first
  half set to zero.
- sumcheck_stale: a step that returns its state unchanged: each fused
  sumcheck round computes its messages but hands back the tables unfolded.
- sumcheck_altered: an answer altered where it is produced: each
  sumcheck's first message plus one.
"""

from __future__ import annotations


def msm_altered(cell) -> None:
    from quill_tpu_torch.ec import curve

    eng = cell.engine
    orig = eng.msm_many

    def msm_many(jobs):
        out = orig(jobs)
        if out:
            out[0] = out[0].add(curve.g1_generator())
        return out

    eng.msm_many = msm_many


def msm_half(cell) -> None:
    eng = cell.engine
    orig = eng._scalars

    def scalars(s):
        t = orig(s).clone()
        t[(t.shape[0] + 1) // 2:] = 0
        return t

    eng._scalars = scalars


def sumcheck_stale(cell) -> None:
    eng = cell.engine
    orig = eng.sumcheck_round_fused

    def round_fused(tables, expr, degree, r_prev):
        _, msgs = orig(tables, expr, degree, r_prev)
        return tables, msgs

    eng.sumcheck_round_fused = round_fused


def sumcheck_altered(cell) -> None:
    from quill_tpu_torch.fields.bn254 import R

    eng = cell.engine
    orig = eng.sumcheck_begin

    def begin(tables, expr, degree):
        tables, msgs = orig(tables, expr, degree)
        msgs = list(msgs)
        msgs[0] = (msgs[0] + 1) % R
        return tables, msgs

    eng.sumcheck_begin = begin


FAULTS = {f.__name__: f for f in (msm_altered, msm_half, sumcheck_stale,
                                  sumcheck_altered)}


def plant(name: str, cell) -> None:
    FAULTS[name](cell)
