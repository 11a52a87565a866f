"""Sumcheck rounds through TorchEngine (kernel A's plain twin on the CPU)
against HostEngine.

The three expressions of `tests/test_sumcheck8.py` at 2^12 rows, every
round: `sumcheck_begin` for round 0, then `sumcheck_round_fused` until the
tables are two elements long (min_device_size=1) or until they are handed
to the host (min_device_size=2^9).  Each expression is built twice, from
the port's `piops/virtual_poly.py` and from the JAX package's.
"""

import random

import pytest
import torch

from quill_tpu.engine.host import HostEngine
from quill_tpu.fields.bn254 import R
from quill_tpu.piops import virtual_poly as jax_vp

from quill_tpu_torch.engine import sumcheck
from quill_tpu_torch.engine.device import TVec, TorchEngine
from quill_tpu_torch.piops import virtual_poly as port_vp

torch.set_num_threads(1)

LOG2N = 12
RNG = random.Random(8)


class JaxHost(HostEngine):
    """The JAX package's HostEngine with the port's round 0 (`engine/
    contract.py`): the tables as they are, and their messages."""

    def sumcheck_begin(self, tables, expr, degree):
        return tables, self.sumcheck_messages(tables, expr, degree)


def _exprs(vp):
    Input, Const = vp.Input, vp.Const
    return [
        Input(0) * Input(1),
        Input(0) * Input(1) + Const(7) * Input(2),
        (Input(0) * Input(1) - Input(2)) * Input(0) + Const(R - 3),
    ]


# (port expression, JAX expression)
EXPRS = list(zip(_exprs(port_vp), _exprs(jax_vp)))


@pytest.fixture(scope="module")
def tables():
    out = [[RNG.randrange(R) for _ in range(1 << LOG2N)] for _ in range(3)]
    out[0][:4] = [0, 1, R - 1, R - 2]
    return out


def _run(eng, tabs, expr, challenges):
    degree = expr.degree()
    used = sorted(expr.used_inputs())
    vecs = [eng.vec_from_ints(t) if i in used else None
            for i, t in enumerate(tabs)]
    vecs, msgs = eng.sumcheck_begin(vecs, expr, degree)
    out = [msgs]
    for r in challenges:
        vecs, msgs = eng.sumcheck_round_fused(vecs, expr, degree, r)
        out.append(msgs)
    finals = [[int(x) for x in eng.vec_to_ints(vecs[i])] for i in used]
    return out, finals, vecs


@pytest.mark.parametrize("expr", EXPRS, ids=["mul", "affine", "deg3"])
def test_all_rounds_match_host(tables, expr):
    challenges = [RNG.randrange(R) for _ in range(LOG2N - 1)]
    eng = TorchEngine("cpu", min_device_size=1)
    got, gfin, vecs = _run(eng, tables, expr[0], challenges)
    want, wfin, _ = _run(JaxHost(), tables, expr[1], challenges)
    assert got == want
    assert gfin == wfin
    assert all(isinstance(v, TVec) for v in vecs if v is not None)


def test_rounds_across_the_handoff(tables, monkeypatch):
    expr = EXPRS[2]
    challenges = [RNG.randrange(R) for _ in range(6)]
    eng = TorchEngine("cpu", min_device_size=1 << 9)
    folds = []
    round_messages = sumcheck.round_messages

    def counted(ts, *args):
        folds.append(len(args) > 2 and args[2] is not None)
        return round_messages(ts, *args)

    monkeypatch.setattr(sumcheck, "round_messages", counted)
    got, gfin, vecs = _run(eng, tables, expr[0], challenges)
    want, wfin, _ = _run(JaxHost(), tables, expr[1], challenges)
    assert got == want and gfin == wfin
    # round 0, then the folds of 2^12, 2^11, 2^10 and 2^9 (the handoff:
    # its 2^8 results move to the host) all go through the kernel's
    # wrapper; the last two rounds run on the host
    assert folds == [False, True, True, True, True]
    assert not any(isinstance(v, TVec) for v in vecs)


def test_round_messages_plain_and_program(tables):
    """The wrapper's CPU path is the plain twin; the fold it returns is
    the host fold."""
    from quill_tpu_torch.fields import device as fd

    expr, jax_expr = EXPRS[1]
    host = HostEngine()
    ts = [fd.from_ints(t[:256]) for t in tables]
    r = 31337
    msgs, folded = sumcheck.round_messages(ts, expr, expr.degree(), r)
    h = [host.vec_from_ints(t[:256]) for t in tables]
    h_new, h_msgs = host.sumcheck_round_fused(h, jax_expr, expr.degree(), r)
    assert msgs == h_msgs
    for f, hf in zip(folded, h_new):
        assert fd.to_ints(f) == [int(x) for x in hf]
    with pytest.raises(ValueError):
        sumcheck.round_messages([ts[0][:6]] * 3, expr, 1, r)
