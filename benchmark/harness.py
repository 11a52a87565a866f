"""One cell of the benchmark: the program set up from the seed, proves back
to back in a measured window, an optional traced window, and the proofs
judged by the plain reference.

The program is `quill_tpu_torch`: `KZG.device_setup` (the CRS on the card,
as large as the largest trace), `HyperPlonk.preprocess` of the statement's
traces and cross-table lookups, then `HyperPlonk.prove` and
`serialize_proof`, one proof in flight.  The benchmark makes tau, the
statement and the witnesses from the seed and hands the same to the program
and the reference.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import sys
import time
import traceback

from reference.verify import traces_of
from registry import Registry


def tau_from_seed(seed: int) -> int:
    """The CRS's trapdoor: sha256 of a tag and the seed's 8 bytes, mod R
    (the derivation of the program's `trusted_setup`, so seed 0 gives the
    CRS of the repository's pinned proofs)."""
    from reference.curve import R

    data = b"quill-tpu-trusted-setup" + (seed % (1 << 64)).to_bytes(8,
                                                                    "little")
    return int.from_bytes(hashlib.sha256(data).digest(), "little") % R


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


class Timer:
    """Seconds, calls and host intervals (ns) of engine methods,
    synchronised on both sides, counting only the outermost of nested
    calls."""

    def __init__(self, device: str):
        self.device = device
        self.seconds = 0.0
        self.calls = 0
        self.items: list = []
        self.intervals: list = []
        self.depth = 0

    def wrap(self, fn, items=None):
        def timed(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            self.depth += 1
            _sync(self.device)
            t0 = time.perf_counter()
            n0 = time.time_ns()
            try:
                return fn(*args, **kw)
            finally:
                _sync(self.device)
                self.intervals.append((n0, time.time_ns()))
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                if items is not None:
                    self.items.extend(items(*args, **kw))
                self.depth -= 1
        return timed


class Cell:
    def __init__(self, name: str, seed: int, device: str = "cuda",
                 registry: Registry | None = None):
        self.reg = registry or Registry()
        self.name = name
        self.seed = int(seed)
        self.device = device
        self.workload = self.reg.workload(name)
        self.config = self.reg.config(self.workload["config"])
        self.traffic = self.reg.traffic(self.workload["traffic"])
        circuit = self.reg.circuit(self.config["circuit"])
        self.statement = circuit.Statement.from_seed(
            self.config["log2_rows"], self.seed,
            **self.config.get("circuit_args", {}))
        self.tau = tau_from_seed(self.seed)
        self.setup: dict = {}
        self.proofs: dict = {}     # sha256 -> [bytes, count]
        self.failed = 0

    # -- set-up ---------------------------------------------------------------

    def build(self) -> None:
        """Every kernel library of the program built (or found built in
        the checkout) and loaded, so nothing compiles later."""
        from quill_tpu_torch.kernels import build

        if self.device == "cuda":
            for name in build.LIBS:
                build.lib(name)
        for name in build.NATIVE_LIBS:
            build.native_lib(name)

    def set_up(self) -> None:
        import torch

        from quill_tpu_torch.engine.device import TorchEngine
        from quill_tpu_torch.pcs.kzg import KZG
        from quill_tpu_torch.pcs.mlpcs import MultilinearPCS
        from quill_tpu_torch.proof.hyperplonk import HyperPlonk, TraceWitness
        from quill_tpu_torch.utils.proof_io import serialize_proof

        self._serialize = serialize_proof
        s = self.setup
        t = time.perf_counter()
        self.build()
        s["build_s"] = time.perf_counter() - t

        # the witnesses handed to every prove, made once: a prove adds no
        # host work of the benchmark's to the window
        t = time.perf_counter()
        traces = traces_of(self.statement)
        self.witnesses = [TraceWitness(columns=tr.witness())
                          for tr in traces]
        self.circuits = [tr.program_circuit() for tr in traces]
        lookups = (self.statement.program_lookups()
                   if hasattr(self.statement, "program_lookups") else None)
        s["witness_s"] = time.perf_counter() - t

        # the cells' configurations pass no options: the engine's defaults
        self.engine = TorchEngine(self.device,
                                  **self.config.get("engine", {}))
        degree = max(tr.columns * tr.rows for tr in traces)
        _sync(self.device)
        t = time.perf_counter()
        self.kzg = KZG.device_setup(self.engine, degree, tau=self.tau)
        _sync(self.device)
        s["crs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.hp = HyperPlonk.preprocess(self.circuits,
                                        MultilinearPCS(self.kzg),
                                        lookups=lookups)
        _sync(self.device)
        s["preprocess_s"] = time.perf_counter() - t

        t = time.perf_counter()
        for _ in range(int(self.workload.get("warmup_proves", 0))):
            self.keep(self.prove())
        _sync(self.device)
        s["warmup_s"] = time.perf_counter() - t
        s["warmup_proves"] = int(self.workload.get("warmup_proves", 0))
        if self.device == "cuda":
            s["setup_peak_bytes"] = torch.cuda.max_memory_allocated()

    # -- proving --------------------------------------------------------------

    def prove(self) -> bytes:
        proof = self.hp.prove(self.witnesses)
        return self._serialize(proof)

    def keep(self, data: bytes) -> None:
        key = hashlib.sha256(data).hexdigest()
        if key in self.proofs:
            self.proofs[key][1] += 1
        else:
            self.proofs[key] = [data, 1]

    def _one(self, spans=None) -> bool:
        t0 = time.time_ns()
        try:
            data = self.prove()
        except Exception:
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            return False
        finally:
            if spans is not None:
                spans.append(("prove", t0, time.time_ns()))
        self.keep(data)
        return True

    def window(self, seconds: float) -> dict:
        """Proves back to back, one in flight, started while less than
        `seconds` have passed (at least one); the window closes when the
        last ends."""
        import torch

        from quill_tpu_torch.utils.profiling import metrics

        spans0 = dict(metrics.times)
        routes0 = dict(self.engine.msm_counts)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times = []
        _sync(self.device)
        t0 = time.perf_counter()
        while not times or time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self._one()
            times.append(time.perf_counter() - t)
        _sync(self.device)
        secs = time.perf_counter() - t0
        out = {"proves": len(times), "seconds": secs, "prove_times": times,
               "spans": {k: v - spans0.get(k, 0.0)
                         for k, v in metrics.times.items()},
               "routes": {k: v - routes0.get(k, 0)
                          for k, v in self.engine.msm_counts.items()}}
        if self.device == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    def _profiled(self, proves: int) -> dict:
        """`proves` proves under the profiler (CUDA activity), with the
        program's `phase` spans recorded on the host's clock; -> the
        device's events in the window and the spans."""
        from torch.profiler import ProfilerActivity, profile

        import devtrace
        from quill_tpu_torch.utils import profiling

        spans: list = []
        orig_phase = profiling.phase

        @contextlib.contextmanager
        def phase(name):
            t = time.time_ns()
            try:
                with orig_phase(name):
                    yield
            finally:
                spans.append((name, t, time.time_ns()))

        patched = [m for m in list(sys.modules.values())
                   if getattr(m, "__name__", "").startswith("quill_tpu_torch")
                   and getattr(m, "phase", None) is orig_phase]
        for m in patched:
            m.phase = phase
        acts = [ProfilerActivity.CUDA if self.device == "cuda"
                else ProfilerActivity.CPU]
        try:
            with profile(activities=acts) as prof:
                _sync(self.device)
                t0 = time.time_ns()
                for _ in range(proves):
                    self._one(spans)
                _sync(self.device)
                t1 = time.time_ns()
        finally:
            for m in patched:
                m.phase = orig_phase
        t = time.perf_counter()
        events, seen = devtrace.device_events(
            prof.profiler.kineto_results.events(), t0, t1)
        return {"proves": proves, "seconds": (t1 - t0) / 1e9, "t0": t0,
                "t1": t1, "events": events, "seen": seen, "spans": spans,
                "merged": devtrace.union(events),
                "reduce_s": time.perf_counter() - t}

    def traced_window(self, proves: int) -> dict:
        """`proves` proves under the profiler, as the window runs them (no
        wrapper, no synchronise added): the device's busy time, its idle
        time by host span, and device time by kernel name."""
        import devtrace

        p = self._profiled(proves)
        merged = p["merged"]
        return {
            "proves": proves, "seconds": p["seconds"],
            "device_events": len(p["events"]), "trace_events": p["seen"],
            "device_s_by_name": devtrace.by_name(p["events"]),
            "busy_s": sum(e - s for s, e in merged) / 1e9,
            "idle_by_span": devtrace.idle_by_span(merged, p["spans"], p["t0"],
                                                  p["t1"], "between proves"),
            "reduce_s": p["reduce_s"],
        }

    def timed_window(self, proves: int) -> dict:
        """`proves` more proves under the profiler with the engine's
        sumchecks and MSMs each between two device synchronises: their host
        time, and the device's busy time inside the MSM calls."""
        import devtrace

        eng = self.engine
        sumcheck = Timer(self.device)
        msm = Timer(self.device)
        saved = {k: getattr(eng, k) for k in
                 ("sumcheck_begin", "sumcheck_round_fused", "msm",
                  "msm_many")}
        eng.sumcheck_begin = sumcheck.wrap(saved["sumcheck_begin"])
        eng.sumcheck_round_fused = sumcheck.wrap(
            saved["sumcheck_round_fused"])
        eng.msm = msm.wrap(saved["msm"], lambda basis, s: [basis.length])
        eng.msm_many = msm.wrap(saved["msm_many"],
                                lambda jobs: [b.length for b, _ in jobs])
        routes0 = dict(eng.msm_counts)
        try:
            p = self._profiled(proves)
        finally:
            for k, v in saved.items():
                setattr(eng, k, v)
        routes = {k: v - routes0.get(k, 0) for k, v in eng.msm_counts.items()}
        return {
            "proves": proves, "seconds": p["seconds"],
            "sumcheck_s": sumcheck.seconds, "sumcheck_calls": sumcheck.calls,
            "msm_s": msm.seconds, "msm_points": msm.items,
            "msm_routes": routes,
            "msm_device_s": devtrace.busy_within(p["merged"], msm.intervals),
            "reduce_s": p["reduce_s"],
        }

    def release(self) -> None:
        """The program's state freed before the reference runs."""
        for k in ("hp", "kzg", "engine", "circuits", "witnesses"):
            if hasattr(self, k):
                delattr(self, k)
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def judge(self) -> dict:
        """Every distinct proof the run produced, checked by the reference;
        -> the numbers compared, each with its limit."""
        from reference.verify import Verifier

        t = time.perf_counter()
        verifier = Verifier(self.statement, self.tau)
        rejected = checks = 0
        for key, (data, count) in self.proofs.items():
            failed = verifier.check(data)
            if failed:
                print(f"proof {key[:16]} ({count}x): {len(failed)} failed "
                      f"checks: {failed[:8]}", file=sys.stderr)
                rejected += count
                checks += len(failed)
        self.reference_s = time.perf_counter() - t
        return {"proofs_rejected": {"value": rejected, "limit": 0},
                "checks_failed": {"value": checks, "limit": 0}}
