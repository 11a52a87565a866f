"""Compile a `piops/virtual_poly.py` Expr into a small postfix program.

Counterpart of `quill_tpu/engine/device.py:_get_eval_kernel` and the
`_emit8` code generation in `quill_tpu/engine/sumcheck8.py`, which traced
one XLA/Pallas program per expression structure.  Here an expression
becomes a list of int32 opcodes that kernel A (`csrc/sumcheck_round.cu`)
and the plain evaluator below both interpret, so one build serves every
expression.  Constants are slotted out in `expr.key()` order and passed at
run time, so new challenges never change the program.

Opcode = (arg << 2) | code, code 0: push input slot `arg` (index into the
sorted used inputs), 1: push constant `arg`, 2: add, 3: multiply.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import device as fd
from ..fields.device import FR
from ..piops import virtual_poly as vp

OP_IN, OP_CONST, OP_ADD, OP_MUL = 0, 1, 2, 3


@dataclass(frozen=True)
class Program:
    ops: tuple
    used: tuple      # input indices, in slot order
    depth: int       # largest stack depth the program reaches


_CACHE: dict = {}


def compile_expr(expr) -> Program:
    structure, consts = expr.key()
    used = tuple(sorted(expr.used_inputs()))
    key = (structure, used)
    prog = _CACHE.get(key)
    if prog is None:
        slot = {idx: s for s, idx in enumerate(used)}
        ops: list[int] = []
        counter = [0]
        depth = [0, 0]   # current, max

        def push():
            depth[0] += 1
            depth[1] = max(depth[1], depth[0])

        def emit(e):
            if isinstance(e, vp.Input):
                ops.append((slot[e.index] << 2) | OP_IN)
                push()
            elif isinstance(e, vp.Const):
                ops.append((counter[0] << 2) | OP_CONST)
                counter[0] += 1
                push()
            elif isinstance(e, (vp.Add, vp.Mul)):
                emit(e.left)
                emit(e.right)
                ops.append(OP_ADD if isinstance(e, vp.Add) else OP_MUL)
                depth[0] -= 1
            else:
                raise TypeError(f"unknown expr node {e!r}")

        emit(expr)
        assert counter[0] == len(consts)
        prog = Program(ops=tuple(ops), used=used, depth=depth[1])
        _CACHE[key] = prog
    return prog


def const_tensor(expr, device):
    """The expression's constants as a (k, 8) Montgomery tensor."""
    _, consts = expr.key()
    return fd.from_ints(consts, FR, device)


def eval_program_w(prog: Program, inputs: list, consts_w):
    """Plain evaluation on w16 tensors: `inputs[s]` is the value of slot s
    (all of one shape (..., 16)), `consts_w` a (k, 16) tensor."""
    stack: list = []
    shape = inputs[0].shape
    for op in prog.ops:
        code, arg = op & 3, op >> 2
        if code == OP_IN:
            stack.append(inputs[arg])
        elif code == OP_CONST:
            stack.append(consts_w[arg].expand(shape))
        else:
            b = stack.pop()
            a = stack.pop()
            stack.append(fd.w_add(a, b, FR) if code == OP_ADD
                         else fd.w_mul(a, b, FR))
    return stack[0]
