"""Fused sumcheck round: kernel A (`csrc/sumcheck_round.cu`) and its plain
PyTorch twin.

Counterpart of `quill_tpu/engine/sumcheck8.py` (`begin8`, `messages8`,
`round_fused8` over the stacked 8-bit state).  The port keeps each table
as its natural-order `(n, 8)` Montgomery tensor; a round reads pairs
straight from it (LSB binding, `engine/sumcheck8.py:30-34`).

`round_messages(tables, expr, degree, r)`:
- `r is None`: messages of the tables as they are (round 0);
- otherwise: fold every table at r first, return the folded tables too.
The messages are the canonical sums at t = 0..degree.

On the card a round copies nothing to the device: the tables' pointers,
r, the program and its constants go into the launch itself (`Params`,
the layout of `csrc/sumcheck.cuh: ScParams`), and the one copy back is
the messages.  Each expression's program, constants and filled `Params`
are made once and kept while the expression lives (`prepare`).
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch

from ..fields import device as fd
from ..fields.device import FR
from ..kernels import build
from .expr import Program, compile_expr, const_tensor, eval_program_w

# csrc/sumcheck.cuh and csrc/sumcheck_round.cu
MAX_TABLES, MAX_T, MAX_STACK, MAX_OPS, MAX_CONSTS = 16, 8, 16, 512, 64
MAX_GRID = 2048          # SC_MAX_GRID: blocks of one round, at most


class Params(ctypes.Structure):
    """csrc/sumcheck.cuh: ScParams."""
    _fields_ = [
        ("tables_in", ctypes.c_void_p * MAX_TABLES),
        ("tables_out", ctypes.c_void_p * MAX_TABLES),
        ("r", ctypes.c_uint32 * 8),
        ("consts", ctypes.c_uint32 * (8 * MAX_CONSTS)),
        ("ops", ctypes.c_uint8 * MAX_OPS),
        ("n_pairs", ctypes.c_longlong),
        ("k", ctypes.c_int),
        ("prog_len", ctypes.c_int),
        ("fold", ctypes.c_int),
        ("unused", ctypes.c_int),
    ]


_FN = {}


def _fn():
    if "round" not in _FN:
        lib = build.lib("sumcheck")
        limits = (ctypes.c_int * 7)()
        build.bind(lib, "quill_sumcheck_limits", [build.VP])(
            ctypes.addressof(limits))
        want = (MAX_TABLES, MAX_T, MAX_STACK, MAX_OPS, MAX_CONSTS, MAX_GRID,
                ctypes.sizeof(Params))
        if tuple(limits) != want:
            raise RuntimeError(f"kernel A's limits {tuple(limits)} differ "
                               f"from engine/sumcheck.py's {want}")
        _FN["round"] = build.bind(lib, "quill_sumcheck_round", [
            build.VP, build.I32, build.I32, build.VP, build.VP, build.VP])
    return _FN["round"]


class Prepared:
    """An expression's program, constants and kernel arguments."""

    __slots__ = ("expr", "prog", "consts", "slots", "_params")

    def __init__(self, expr):
        self.expr = expr                 # held: keeps id(expr) unique
        self.prog = compile_expr(expr)
        self.consts = expr.key()[1]
        k = len(self.prog.used)
        self.slots = 2 * k + max(self.prog.depth - 1, 0)
        self._params = None

    def params(self) -> Params:
        """The launch arguments but tables, r and size (filled per round);
        raises outside kernel A's limits."""
        if self._params is None:
            prog, k = self.prog, len(self.prog.used)
            if (k > MAX_TABLES or prog.depth > MAX_STACK
                    or len(prog.ops) > MAX_OPS
                    or len(self.consts) > MAX_CONSTS):
                raise ValueError(
                    f"expression outside kernel A's limits: {k} tables, "
                    f"stack depth {prog.depth}, {len(prog.ops)} ops, "
                    f"{len(self.consts)} constants (limits {MAX_TABLES}, "
                    f"{MAX_STACK}, {MAX_OPS}, {MAX_CONSTS})")
            p = Params()
            p.ops[:len(prog.ops)] = prog.ops
            p.prog_len = len(prog.ops)
            p.k = k
            words = [w for c in self.consts for w in fd.mont_words(c)]
            p.consts[:len(words)] = words
            self._params = p
        return self._params


_PREPARED: OrderedDict = OrderedDict()
_PREPARED_MAX = 64


def prepare(expr) -> Prepared:
    """The Prepared of an expression object, made at its first round."""
    hit = _PREPARED.get(id(expr))
    if hit is not None and hit.expr is expr:
        _PREPARED.move_to_end(id(expr))
        return hit
    hit = Prepared(expr)
    _PREPARED[id(expr)] = hit
    if len(_PREPARED) > _PREPARED_MAX:
        _PREPARED.popitem(last=False)
    return hit


def round_messages(tables: list, expr, degree: int, r: int | None = None,
                   plain: bool = False):
    """tables: the used tables' (n, 8) Montgomery tensors in slot order
    (sorted input index).  Returns (messages as ints, folded tables or
    None).  `plain` runs the plain twin whatever the device."""
    prep = prepare(expr)
    assert len(tables) == len(prep.prog.used) > 0
    n = tables[0].shape[0]
    for t in tables:
        if t.shape != (n, fd.NLIMB) or t.dtype != torch.int32:
            raise ValueError("sumcheck tables must be (n, 8) int32 of one n")
    if n % (4 if r is not None else 2):
        raise ValueError(f"table length {n} does not split into pairs")
    if tables[0].is_cuda and not plain:
        return round_cuda(tables, prep, degree, r)
    consts = const_tensor(expr, tables[0].device)
    return round_plain(tables, prep.prog, consts, degree, r)


def round_cuda(tables, prep: Prepared, degree: int, r):
    fn = _fn()
    nt = degree + 1
    if nt > MAX_T:
        raise ValueError(f"degree {degree} above kernel A's {MAX_T - 1}")
    p = prep.params()
    dev = tables[0].device
    tables = [t.contiguous() for t in tables]
    n = tables[0].shape[0]
    fold = r is not None
    folded = None
    for i, t in enumerate(tables):
        p.tables_in[i] = t.data_ptr()
    if fold:
        folded = list(torch.empty((len(tables), n // 2, fd.NLIMB),
                                  dtype=torch.int32, device=dev))
        for i, t in enumerate(folded):
            p.tables_out[i] = t.data_ptr()
        p.r[:] = fd.mont_words(r)
    p.n_pairs = n // 4 if fold else n // 2
    p.fold = int(fold)
    # the blocks' partial sums, then the messages
    scratch = torch.empty((MAX_GRID + 1, nt, fd.NLIMB), dtype=torch.int32,
                          device=dev)
    out = scratch[MAX_GRID]
    rc = fn(ctypes.addressof(p), nt, prep.slots, scratch.data_ptr(),
            out.data_ptr(), build.stream_ptr())
    build.check(rc, "sumcheck_round")
    build.count("sumcheck_round")
    msgs = [FR.unmont(v) for v in fd.tensor_to_ints(out)]
    return msgs, folded


def fold_w(t_w, r_w):
    """Plain fold of a w16 table (n, 16) -> (n/2, 16) at r (w16 const)."""
    lo, hi = t_w[0::2], t_w[1::2]
    return fd.w_add(lo, fd.w_mul(fd.w_sub(hi, lo, FR), r_w, FR), FR)


def round_plain(tables, prog: Program, consts, degree: int, r):
    """The same round in plain PyTorch ops."""
    dev = tables[0].device
    stacked = fd.to_w16(torch.stack(tables, 0))          # (k, n, 16)
    folded = None
    if r is not None:
        stacked = fold_w(stacked.transpose(0, 1),
                         fd.w_const(r, FR, dev)).transpose(0, 1)
        folded = [fd.from_w16(s) for s in stacked]
    lo, hi = stacked[:, 0::2], stacked[:, 1::2]
    d = fd.w_sub(hi, lo, FR)
    consts_w = fd.to_w16(consts)
    msgs = []
    v = lo
    for t in range(degree + 1):
        h = eval_program_w(prog, list(v), consts_w)
        msgs.append(fd.vsum(fd.from_w16(h), FR))
        if t < degree:
            v = fd.w_add(v, d, FR)
    return msgs, folded
