"""Batched KZG quotients: the openings of an `open_many` batch through kernel M
(`csrc/quotient.cu`), with one host readback for the whole batch.

Counterpart of `quill_tpu/engine/quotient.py: quotient_many_device`, which
`TorchEngine.quotient_many` calls for a batch's device vectors with x != 0
(the JAX copy groups them by chunk count; the port sends them all, in input
order).  For each opening (c, x), by Ruffini's recurrence:

    H_k = c_k + x H_(k+1) from H_n = 0,   q_(k-1) = H_k,   y = H_0

The JAX route runs 2 x nch XLA passes over 2^16-coefficient chunks, carrying
the chunk offsets on the device; kernel M runs three launches for up to
MAX_JOBS openings of any lengths (tiles of 128 runs of r coefficients,
each run's affine map H_top -> H_bottom scanned from the top, then q), with
x and x^r in the launch parameters, and the host reads the y values back
once.  The quotient keeps the port's length, n - 1 coefficients (the JAX
route's DVec keeps n, the last one 0).  On a CPU tensor the plain twin
runs.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import device as fd
from ..fields.bn254 import R
from ..fields.device import FR
from ..fields.scalar import inv
from ..kernels import build
from .device import TVec

MAX_JOBS = 16     # openings a launch (QUOT_MAX_JOBS)
BLOCK = 128       # runs a tile (QUOT_BLOCK)
RUNS = (128, 64, 32)   # coefficients a run, the longest first
MIN_RUNS = 1 << 15     # runs (threads) a batch keeps where it can

_FN = {}


def _fn():
    if not _FN:
        pp = ctypes.POINTER(ctypes.c_void_p)
        u32 = ctypes.POINTER(ctypes.c_uint32)
        _FN["f"] = build.bind(
            build.lib("quotient"), "quill_quotient",
            [pp, pp, ctypes.POINTER(ctypes.c_longlong), u32, u32, build.I32,
             build.I64, build.I64, build.VP, build.VP, build.VP, build.VP])
    return _FN["f"]


def _words(vals: list[int]):
    """Field elements' Montgomery words, one C array."""
    words = [w for v in vals for w in fd.mont_words(v)]
    return (ctypes.c_uint32 * len(words))(*words)


def run_for(lengths: list[int]) -> int:
    """Coefficients a run for a batch of jobs of these lengths: the longest
    of RUNS that leaves MIN_RUNS runs, else the shortest.  A longer run
    spends less on the scans (~18 products a run), a shorter one keeps
    more threads: on an H100 4 x 2^22 coefficients were fastest at 128,
    8 x 2^18 at 64 and 8 x 2^16 at 32 (PERF.md)."""
    for r in RUNS:
        if sum(-(-n // r) for n in lengths) >= MIN_RUNS:
            return r
    return RUNS[-1]


def launch(cs: list[torch.Tensor], xs: list[int], run: int | None = None):
    """Kernel M's three launches for (n_j, 8) Montgomery coefficient
    tensors on the card and points x_j != 0 (at most MAX_JOBS, n_j >= 1),
    in runs of `run` coefficients (default `run_for` the batch), nothing
    read back -> ((B, 8) Montgomery y_j on the card, the (n_j, 8) tensors
    of q_0 .. q_{n_j - 2} and a zero row)."""
    if run is None:
        run = run_for([c.shape[0] for c in cs])
    xs = [int(x) % R for x in xs]
    if not 0 < len(cs) == len(xs) <= MAX_JOBS or 0 in xs or run < 1:
        raise ValueError(f"kernel M takes 1 to {MAX_JOBS} jobs with x != 0")
    for c in cs:
        if not (c.is_cuda and c.dtype == torch.int32 and c.is_contiguous()
                and c.dim() == 2 and c.shape[1] == fd.NLIMB
                and c.shape[0] > 0 and c.data_ptr() % 16 == 0):
            raise ValueError("coefficients must be contiguous, 16-byte "
                             "aligned (n, 8) int32 CUDA tensors, n >= 1")
    dev = cs[0].device
    nb = len(cs)
    outs = [torch.empty_like(c) for c in cs]
    ys = torch.empty((nb, fd.NLIMB), dtype=torch.int32, device=dev)
    tiles = sum(-(-c.shape[0] // (BLOCK * run)) for c in cs)
    runc = torch.empty((tiles * BLOCK, 2, fd.NLIMB), dtype=torch.int32,
                       device=dev)
    tilet = torch.empty((tiles, 2, fd.NLIMB), dtype=torch.int32, device=dev)
    rc = _fn()((ctypes.c_void_p * nb)(*[c.data_ptr() for c in cs]),
               (ctypes.c_void_p * nb)(*[o.data_ptr() for o in outs]),
               (ctypes.c_longlong * nb)(*[c.shape[0] for c in cs]),
               _words(xs), _words([pow(x, run, R) for x in xs]), nb, run,
               tiles, runc.data_ptr(), tilet.data_ptr(), ys.data_ptr(),
               build.stream_ptr())
    build.check(rc, "quotient")
    build.count("quotient")
    return ys, outs


def scan(cs: list[torch.Tensor], xs: list[int], run: int | None = None):
    """Kernel M: `launch`, then the y_j read back as canonical ints -> (ys,
    the (n_j, 8) tensors of q_0 .. q_{n_j - 2} and a zero row).  One count
    a batch: its three phase launches.  The plain twin for CPU tensors."""
    if not cs[0].is_cuda:
        return scan_plain(cs, xs)
    ys, outs = launch(cs, xs, run)
    return [FR.unmont(v) for v in fd.tensor_to_ints(ys)], outs


def scan_plain(cs: list[torch.Tensor], xs: list[int]):
    """The plain twin of `scan`, one job at a time: power tables by
    doubling, products, a Hillis-Steele prefix sum, one readback a job."""
    ys, outs = [], []
    for c, x in zip(cs, xs):
        n, dev = c.shape[0], c.device
        x = int(x) % R
        pre = prefix_sum(fd.mul(c, fd.powers(x, n, FR, dev), FR))
        y = FR.unmont(fd.tensor_to_ints(pre[n - 1:n])[0])
        diff = fd.sub(fd.const(y, FR, dev).expand(n, fd.NLIMB), pre, FR)
        ys.append(y)
        outs.append(fd.mul(diff, fd.powers(inv(x, R), n + 1, FR, dev)[1:],
                           FR))
    return ys, outs


def prefix_sum(t: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of an (n, 8) Montgomery tensor: log2(n)
    full-width modular adds (Hillis-Steele)."""
    w = fd.to_w16(t)
    n = w.shape[0]
    step = 1
    while step < n:
        w = torch.cat((w[:step], fd.w_add(w[step:], w[:-step], FR)), 0)
        step *= 2
    return fd.from_w16(w)


def quotient_many_device(engine, jobs: list) -> list:
    """jobs: [(TVec poly, x)] with x != 0 -> [(y, q)] in input order, q the
    n - 1 coefficients of (p - y) / (X - x) as the engine wraps a result of
    that length.  Kernel M on the card, MAX_JOBS jobs a launch, of any
    lengths; the plain twin for CPU tensors.  Each batch is counted in
    `engine.quotient_batches` by its jobs' lengths."""
    out = []
    for i in range(0, len(jobs), MAX_JOBS):
        part = jobs[i:i + MAX_JOBS]
        key = tuple(p.length for p, _ in part)
        engine.quotient_batches[key] = engine.quotient_batches.get(key, 0) + 1
        ys, qs = scan([p.rows().contiguous() for p, _ in part],
                      [x for _, x in part])
        out += [(y, engine._wrap(q, p.length - 1))
                for (p, _), y, q in zip(part, ys, qs)]
    return out


def quotient_many_plain(jobs: list) -> list:
    """`quotient_many_device`'s contract by the plain twin, q a TVec."""
    ys, qs = scan_plain([p.rows() for p, _ in jobs], [x for _, x in jobs])
    return [(y, TVec(q, p.length - 1)) for (p, _), y, q in zip(jobs, ys, qs)]
