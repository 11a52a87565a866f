"""PyTorch execution engine: the engine contract (`engine/contract.py`) on
the GPU.

Counterpart of `quill_tpu/engine/device.py: TpuEngine`.  Everything
above the engine (`piops/`, `pcs/`, `proof/`, `frontend/`,
`transcript/`) calls only the contract's methods; this class is what it
runs on.

- A device vector (`TVec`) is an `(n, 8)` int32 tensor of Fr elements in
  Montgomery form (`fields/device.py`) plus a logical length; rows past the
  length are zero.  `quotient_many` sends a batch's device vectors with
  x != 0 through `engine/quotient.py` (kernel M), all of them in input
  order (the JAX copy groups its DVecs by their count of 2^16-element
  chunks, for its fixed XLA shapes).
- Vectors shorter than `min_device_size` stay `HostEngine` object arrays,
  as `engine/device.py:418-422` keeps sub-chunk vectors on the host.  The
  handoff is by size only.
- Elementwise ops, `eq_table`, `eval_expr` and `batch_inverse` are plain
  torch ops; the sumcheck rounds, the NTT products, the quotients and the
  MSMs run the hand-written kernels: A, B and M; C and D,
  E to H on the small-MSM route, K, G and E on the v6 route, I and E on the
  v8 route (`msm_route`, chosen by `msm_impl` as `QUILL_MSM_IMPL` chooses
  in the JAX engine).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ec import msm as msm_mod
from ..ec import msm5, msm6, msm8
from ..ec.fixed_base import device_tau_powers
from ..fields import device as fd
from ..fields.bn254 import R
from ..fields.device import FR
from ..kernels import build
from ..poly import ntt
from ..utils.profiling import phase
from . import sumcheck
from .expr import compile_expr, const_tensor, eval_program_w
from .host import HostEngine


# routes each msm_impl can take (`TorchEngine.msm_route`)
MSM_ROUTES = {
    "5": ("small", "v8"),
    "6": ("small", "v6", "v8"),
    "7": ("small", "cd", "v8"),
    "8": ("v8",),
}


class TVec:
    """Device vector: (cap, 8) int32 Montgomery rows, logical `length`."""

    __slots__ = ("data", "length")

    def __init__(self, data: torch.Tensor, length: int | None = None):
        self.data = data
        self.length = data.shape[0] if length is None else length

    def rows(self) -> torch.Tensor:
        return self.data[:self.length]

    def __repr__(self):
        return f"TVec(length={self.length}, device={self.data.device})"


class TorchEngine:
    name = "torch"

    def __init__(self, device="cuda", min_device_size: int = 1 << 11,
                 msm_impl: str = "7", msm_small_chunks: int = 2,
                 msm_batch: int = 4, msm_shift_max: int | None = None):
        self.device = torch.device(device)
        self.min_device_size = max(1, int(min_device_size))
        # QUILL_MSM_IMPL, QUILL_MSM_SMALL_CHUNKS, QUILL_MSM_BATCH and
        # QUILL_MSM_SHIFT_MAX of the JAX engine (`engine/device.py:929-954`)
        self.msm_impl = str(msm_impl)
        if self.msm_impl not in MSM_ROUTES:
            raise ValueError(
                f"msm_impl {self.msm_impl!r}: the port has the MSM routes of "
                f"impls {sorted(MSM_ROUTES)} (1 and 3 are not ported)")
        self.msm_small_chunks = int(msm_small_chunks)
        self.msm_batch = max(1, int(msm_batch))
        if msm_shift_max is None:
            msm_shift_max = 1 << (20 if self.msm_impl in ("6", "7") else 21)
        self.msm_shift_max = int(msm_shift_max)
        # MSMs by route (the routes this impl can take), and the batched
        # small-route runs they took
        self.msm_counts = dict.fromkeys(MSM_ROUTES[self.msm_impl], 0)
        if "small" in self.msm_counts:
            self.msm_counts["small_batches"] = 0
        # kernel M's batches (`engine/quotient.py`): the openings' lengths
        # -> batches of those lengths
        self.quotient_batches: dict = {}
        self.host = HostEngine()

    # -- representation -------------------------------------------------------

    def is_vec(self, v) -> bool:
        return isinstance(v, TVec) or self.host.is_vec(v)

    @staticmethod
    def _dev(v) -> bool:
        return isinstance(v, TVec)

    def _tensor(self, v) -> torch.Tensor:
        """Rows of any vector as a device tensor."""
        if isinstance(v, TVec):
            return v.rows()
        return fd.from_ints([int(x) for x in v], FR, self.device)

    def _wrap(self, t: torch.Tensor, length: int | None = None):
        """A result tensor as a vector on the side its length picks."""
        n = t.shape[0] if length is None else length
        if n < self.min_device_size:
            return self.host.vec_from_ints(fd.to_ints(t[:n], FR))
        return TVec(t, n)

    def vec_from_ints(self, xs):
        xs = xs if type(xs) is list else list(xs)
        if len(xs) < self.min_device_size:
            return self.host.vec_from_ints(xs)
        return TVec(fd.from_ints(xs, FR, self.device))

    def vec_to_ints(self, v):
        if isinstance(v, TVec):
            return self.host.vec_from_ints(fd.to_ints(v.rows(), FR))
        return self.host.vec_to_ints(v)

    def vec_len(self, v) -> int:
        if isinstance(v, TVec):
            return v.length
        return self.host.vec_len(v)

    def pad(self, v, n: int):
        length = self.vec_len(v)
        if length >= n:
            return v
        if not self._dev(v) and n < self.min_device_size:
            return self.host.pad(v, n)
        out = torch.zeros((n, fd.NLIMB), dtype=torch.int32,
                          device=self.device)
        out[:length] = self._tensor(v)
        return TVec(out)

    def view(self, v, start: int, stop: int):
        """Rows [start, stop) of a device vector as a vector that shares
        its storage, or None where `v` is a host vector or the slice is
        below the device size.  Nothing downstream writes into its inputs,
        so readers can share one upload."""
        if not self._dev(v) or stop - start < self.min_device_size:
            return None
        return TVec(v.rows()[start:stop])

    def reverse(self, v):
        if not self._dev(v):
            return self.host.reverse(v)
        return TVec(torch.flip(v.rows(), [0]))

    def slice(self, v, start: int, stop: int):
        if not self._dev(v):
            return self.host.slice(v, start, stop)
        return self._wrap(v.rows()[start:stop].clone())

    def concat(self, vs):
        if not any(self._dev(v) for v in vs):
            return self.host.concat(vs)
        return self._wrap(torch.cat([self._tensor(v) for v in vs], 0))

    # -- elementwise ----------------------------------------------------------

    def _pair(self, a, b):
        ta, tb = self._tensor(a), self._tensor(b)
        if ta.shape[0] != tb.shape[0]:
            raise ValueError(f"length mismatch {ta.shape[0]} != "
                             f"{tb.shape[0]}")
        return ta, tb

    def add(self, a, b):
        if not (self._dev(a) or self._dev(b)):
            return self.host.add(a, b)
        return TVec(fd.add(*self._pair(a, b), FR))

    def sub(self, a, b):
        if not (self._dev(a) or self._dev(b)):
            return self.host.sub(a, b)
        return TVec(fd.sub(*self._pair(a, b), FR))

    def mul(self, a, b):
        if not (self._dev(a) or self._dev(b)):
            return self.host.mul(a, b)
        return TVec(fd.mul(*self._pair(a, b), FR))

    def add_scalar(self, v, c: int):
        if not self._dev(v):
            return self.host.add_scalar(v, c)
        return TVec(fd.add_scalar(v.rows(), c, FR))

    def mul_scalar(self, v, c: int):
        if not self._dev(v):
            return self.host.mul_scalar(v, c)
        return TVec(fd.mul_scalar(v.rows(), c, FR))

    # -- reductions -----------------------------------------------------------

    def vsum(self, v) -> int:
        if not self._dev(v):
            return self.host.vsum(v)
        return fd.vsum(v.rows(), FR)

    def inner(self, a, b) -> int:
        if not (self._dev(a) or self._dev(b)):
            return self.host.inner(a, b)
        n = min(self.vec_len(a), self.vec_len(b))
        if n == 0:
            return 0
        ta, tb = self._tensor(a)[:n], self._tensor(b)[:n]
        return fd.vsum(fd.mul(ta, tb, FR), FR)

    def batch_inverse(self, v):
        if not self._dev(v):
            return self.host.batch_inverse(v)
        return TVec(fd.batch_inverse(v.rows(), FR))

    def first_nonzero(self, vecs: list, pairs: list) -> list:
        """The first non-zero row of each vector, then for each pair
        (a, b) the first row i with a[i] != b[i + 1] (a compare of the
        canonical Montgomery limbs); None where there is none.  One
        readback where no row is found."""
        if not any(self._dev(v) for v in vecs + [v for p in pairs
                                                  for v in p]):
            return self.host.first_nonzero(vecs, pairs)
        masks = [(self._tensor(v) != 0).any(-1) for v in vecs]
        masks += [(self._tensor(a)[:-1] != self._tensor(b)[1:]).any(-1)
                  for a, b in pairs]
        if not masks:
            return []
        found = torch.stack([m.any() for m in masks]).tolist()
        return [int(m.nonzero()[0]) if f else None
                for m, f in zip(masks, found)]

    # -- multilinear ----------------------------------------------------------

    def eq_table(self, point: list[int]):
        """eq(x, point) with the LSB of x bound to point[0]: the outer
        product of the host tables of the low and high halves."""
        n = len(point)
        if (1 << n) < self.min_device_size:
            return self.host.eq_table(point)
        k = n // 2
        lo = fd.to_w16(self._tensor(self.host.eq_table(point[:k])))
        hi = fd.to_w16(self._tensor(self.host.eq_table(point[k:])))
        t = fd.w_mul(hi.unsqueeze(1), lo.unsqueeze(0), FR)
        return TVec(fd.from_w16(t.reshape(1 << n, fd.NW)))

    def eval_expr(self, tables, expr, size: int):
        prog = compile_expr(expr)
        if not any(self._dev(tables[i]) for i in prog.used):
            return self.host.eval_expr(tables, expr, size)
        ins = [fd.to_w16(self._tensor(tables[i])) for i in prog.used]
        consts = fd.to_w16(const_tensor(expr, self.device))
        return TVec(fd.from_w16(eval_program_w(prog, ins, consts)))

    def fold(self, v, r: int):
        if not self._dev(v):
            return self.host.fold(v, r)
        w = fd.to_w16(v.rows())
        out = sumcheck.fold_w(w, fd.w_const(r, FR, self.device))
        return self._wrap(fd.from_w16(out))

    def sumcheck_messages(self, tables, expr, degree: int) -> list[int]:
        used = sumcheck.prepare(expr).prog.used
        if not any(self._dev(tables[i]) for i in used):
            return self.host.sumcheck_messages(tables, expr, degree)
        ins = [self._tensor(tables[i]) for i in used]
        msgs, _ = sumcheck.round_messages(ins, expr, degree)
        return msgs

    def sumcheck_begin(self, tables, expr, degree: int):
        """Round 0: the tables stay as they are (no stacked state)."""
        return tables, self.sumcheck_messages(tables, expr, degree)

    def sumcheck_round_fused(self, tables, expr, degree: int, r_prev: int):
        """Fold every used table at r_prev and compute this round's
        messages in one kernel A launch; folded tables below the device
        size move to the host."""
        used = sumcheck.prepare(expr).prog.used
        new_tables = list(tables)
        if (any(self._dev(tables[i]) for i in used)
                and self.vec_len(tables[used[0]]) % 4 == 0):
            ins = [self._tensor(tables[i]) for i in used]
            msgs, folded = sumcheck.round_messages(ins, expr, degree, r_prev)
            for i, t in zip(used, folded):
                new_tables[i] = self._wrap(t)
            return new_tables, msgs
        for i in used:
            new_tables[i] = self.fold(tables[i], r_prev)
        return new_tables, self.sumcheck_messages(new_tables, expr, degree)

    # -- univariate -----------------------------------------------------------

    def poly_eval(self, coeffs, x: int) -> int:
        if not self._dev(coeffs):
            return self.host.poly_eval(coeffs, x)
        n = coeffs.length
        return fd.vsum(fd.mul(coeffs.rows(),
                              fd.powers(x, n, FR, self.device), FR), FR)

    def poly_mul(self, a, b):
        if not (self._dev(a) or self._dev(b)):
            return self.host.poly_mul(a, b)
        la, lb = self.vec_len(a), self.vec_len(b)
        if la == 0 or lb == 0:
            return self.host.vec_from_ints([])
        prod = ntt.poly_mul(self._tensor(a), self._tensor(b))
        return self._wrap(prod, la + lb - 1)

    def quotient_by_linear(self, coeffs, x: int):
        """(y, q) with y = p(x), q = (p - y) / (X - x), n - 1 coefficients:
        x = 0 is a shift; a device vector otherwise takes kernel M as a
        batch of one (`engine/quotient.py`)."""
        if not self._dev(coeffs):
            return self.host.quotient_by_linear(coeffs, x)
        x = x % R
        if x == 0:
            c = coeffs.rows()
            y = FR.unmont(fd.tensor_to_ints(c[:1])[0])
            return y, self._wrap(c[1:].clone())
        from .quotient import quotient_many_device

        return quotient_many_device(self, [(coeffs, x)])[0]

    def quotient_many(self, jobs: list) -> list:
        """(y, q) per job, in input order.  Device vectors with x != 0 go,
        in input order, through `engine/quotient.py: quotient_many_device`
        (kernel M on the card, which takes mixed lengths in one launch and
        splits at MAX_JOBS); every other job takes `quotient_by_linear`
        (identical results)."""
        from . import quotient

        results: list = [None] * len(jobs)
        idxs = []
        for i, (poly, x) in enumerate(jobs):
            if self._dev(poly) and int(x) % R != 0:
                idxs.append(i)
            else:
                results[i] = self.quotient_by_linear(poly, x)
        if idxs:
            outs = quotient.quotient_many_device(self,
                                                 [jobs[i] for i in idxs])
            for i, out in zip(idxs, outs):
                results[i] = out
        return results

    def s_polynomial(self, p1, p2):
        """IPA S polynomial with ONE product (`engine/device.py:864-885`):
        h = f * rev(g), S[k] = h[n + k] + h[n - 2 - k], k < n - 1."""
        if not (self._dev(p1) or self._dev(p2)):
            return self.host.s_polynomial(p1, p2)
        n = max(self.vec_len(p1), self.vec_len(p2))
        f = self._tensor(self.pad(p1, n))
        g = self._tensor(self.pad(p2, n))
        return self._wrap(ntt.s_polynomial(f, g))

    # -- curve ----------------------------------------------------------------

    def load_points(self, affines: list):
        return msm_mod.load_basis(affines, self.device)

    def tau_basis(self, tau: int, count: int):
        """[G, tau G, ..., tau^(count - 1) G] made on the device by
        fixed-base products (`ec/fixed_base.py`, kernel J), the points of
        the host setup.  The (count, 2, 8) affine tensor is cached on disk
        (`build.crs_cache_dir`)."""
        path = _crs_cache_path(tau, count)
        if path is not None and path.exists():
            xy = torch.from_numpy(np.load(path)).to(self.device)
        else:
            xy = device_tau_powers(tau, count, self.device)
            if path is not None:
                try:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                    with open(tmp, "wb") as f:
                        np.save(f, xy.cpu().numpy())
                    tmp.replace(path)
                except OSError:
                    pass
        return msm_mod.TorchBasis(
            xy=xy, inf=torch.zeros(count, dtype=torch.bool,
                                   device=self.device), length=count)

    def basis_slice(self, basis, n: int):
        return msm_mod.slice_basis(basis, n)

    def msm_route(self, basis) -> str:
        """`engine/device.py:929 TpuEngine._msm_impl`.  Under impl 8 every
        MSM takes the v8 route (`ec/msm8.py`, kernels I and E: no shifted
        basis, nothing held across chunks but the bucket accumulators).
        Under 5, 6 and 7 a basis whose chunks of 2^16 points hold more than
        `msm_shift_max` points takes v8 as well; under 5 every other MSM
        the small route (shifted basis + prefix tree, kernels E to H); under
        6 and 7 one of at most `msm_small_chunks` chunks the small route
        (the fixed cost of 2^15 to 2^16 bucket queries loses below ~3
        chunks), every other MSM v6 (`ec/msm6.py`, kernels K, G and E)
        under 6 and kernels C and D under 7."""
        if self.msm_impl == "8":
            return "v8"
        nch = -(-basis.length // msm5.CHUNK)
        if nch * msm5.CHUNK > self.msm_shift_max:
            return "v8"
        if self.msm_impl == "5" or 0 < nch <= self.msm_small_chunks:
            return "small"
        return "v6" if self.msm_impl == "6" else "cd"

    def _scalars(self, scalars) -> torch.Tensor:
        if isinstance(scalars, TVec):
            return scalars.rows()
        return fd.from_ints([int(x) for x in scalars], FR, self.device)

    def msm(self, basis, scalars):
        """One MSM by the route its basis picks; host scalar vectors are
        loaded to the device first."""
        route = self.msm_route(basis)
        self.msm_counts[route] += 1
        with phase(f"msm/{route}"):
            s = self._scalars(scalars)
            if route == "small":
                self.msm_counts["small_batches"] += 1
                return msm5.msm_batch(basis, [s])[0]
            if route == "v8":
                return msm8.msm(basis, s)
            if route == "v6":
                return msm6.msm(basis, s)
            return msm_mod.msm(basis, s)

    def msm_many(self, jobs: list) -> list:
        """`engine/device.py:993 TpuEngine.msm_many`: jobs over one CRS
        whose widest basis takes the small route run as batched MSMs of
        `msm_batch` jobs (a short group padded with empty MSMs, so every
        batch has one width); everything else (the C + D, v6 and v8
        routes) one job at a time, each by its own basis's route (v6 has
        no work to share across MSMs: `msm6.py:467-482` loops as well).
        Each job uses its own basis's length; the batch runs over the
        widest."""
        if len(jobs) <= 1:
            return [self.msm(b, s) for b, s in jobs]
        widest = max((b for b, _ in jobs), key=lambda b: b.length)
        roots = {id(b.root or b) for b, _ in jobs}
        if len(roots) != 1 or self.msm_route(widest) != "small":
            return [self.msm(b, s) for b, s in jobs]
        with phase("msm/small"):
            scalars = [self._scalars(s)[:b.length] for b, s in jobs]
            empty = scalars[0][:0]
            out = []
            for i in range(0, len(scalars), self.msm_batch):
                part = scalars[i:i + self.msm_batch]
                real = len(part)
                if real > 1:
                    part += [empty] * (self.msm_batch - real)
                self.msm_counts["small"] += real
                self.msm_counts["small_batches"] += 1
                out.extend(msm5.msm_batch(widest, part)[:real])
        return out


def _crs_cache_path(tau: int, count: int):
    """On-disk cache path for a device-made CRS (deterministic in (tau,
    count)); the port's own file name, since it stores its own layout."""
    import hashlib

    base = build.crs_cache_dir()
    if base is None:
        return None
    tag = hashlib.sha256(
        b"crs" + tau.to_bytes(32, "little") + count.to_bytes(8, "little")
    ).hexdigest()[:24]
    return base / f"crs_{tag}_{count}_torch.npy"
