"""Build the port's hand-written kernels and count their launches.

Role of `quill_tpu/utils/aotcache.py` in the TPU build: compile once, reuse.
Each CUDA source in `quill_tpu_torch/csrc/` becomes one shared library with
a plain C interface, built by `nvcc` for `sm_90a` at first use and loaded
with ctypes.  The host C libraries of `native/` (G1 arithmetic for the CRS
and the host MSMs, BLAKE3 for the transcript) are built the same way with
`gcc` (`native_lib`).  Outputs go to `build/quill_tpu_torch/<hash>/` at the
root of the checkout, keyed by the sources and flags, under a file lock so
that concurrent processes build once.  Nothing outside the repository's own
sources is compiled.

`LAUNCHES` holds one plain integer per kernel.  A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through every kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
NATIVE = PKG.parent / "native"
BUILD_ROOT = PKG.parent / "build" / "quill_tpu_torch"

# library -> CUDA source; every library also depends on the shared headers
LIBS = {
    "sumcheck": "sumcheck_round.cu",
    "ntt": "ntt.cu",
    "msm": "msm.cu",
    "msm5": "msm5.cu",
    "msm8": "msm8.cu",
    "fixed_base": "fixed_base.cu",
    "msm6": "msm6.cu",
    "field": "field.cu",
}
HEADERS = ["bn254.cuh", "seg_scan.cuh"]
HOST_SOURCE = "bn254_host.cpp"
# host library -> C source under native/
NATIVE_LIBS = {
    "ec_g1": "ec_g1.c",
    "blake3": "blake3.c",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC"]
GCC_FLAGS = ["-O3", "-fPIC", "-shared"]

# kernel name -> launches since the last reset
LAUNCHES = {
    "sumcheck_round": 0,     # kernel A
    "ntt_stage": 0,          # kernel B
    "msm_bucket_sum": 0,     # kernel C
    "msm_bucket_reduce": 0,  # kernel D
    "msm5_pt_add": 0,        # kernel E
    "msm5_tree_up0": 0,      # kernel F
    "msm5_tree_up": 0,       # kernel G
    "msm5_tree_down": 0,     # kernel H
    "msm8_seg_scan": 0,      # kernel I
    "fixed_base": 0,         # kernel J
    "msm6_level0": 0,        # kernel K
    "field_mul": 0,          # kernel L
}

_LOADED: dict = {}


def count(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _hash(files: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256()
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    files = [CSRC / n for n in HEADERS + [HOST_SOURCE] + sorted(LIBS.values())]
    files += [NATIVE / n for n in sorted(NATIVE_LIBS.values())]
    return BUILD_ROOT / _hash(files, NVCC_FLAGS + GCC_FLAGS)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class _Lock:
    def __init__(self, directory: Path):
        directory.mkdir(parents=True, exist_ok=True)
        self._f = open(directory / "lock", "w")

    def __enter__(self):
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def build(names=None) -> dict:
    """Compile the named CUDA libraries (default: all) that are not built
    yet, in parallel.  Returns {name: path}.  Raises on any failure."""
    names = list(LIBS) if names is None else list(names)
    out_dir = build_dir()
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    with _Lock(out_dir):
        todo = [n for n in names if not paths[n].exists()]
        if todo:
            nvcc = _nvcc()
            procs = {}
            for n in todo:
                tmp = out_dir / f"lib{n}.so.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / LIBS[n])]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True), tmp)
            errors = []
            for n, (proc, tmp) in procs.items():
                log, _ = proc.communicate()
                (out_dir / f"lib{n}.log").write_text(log)
                if proc.returncode != 0:
                    errors.append(f"{LIBS[n]}:\n{log}")
                else:
                    tmp.replace(paths[n])
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded CUDA library `name`, built at first use."""
    if name not in _LOADED:
        path = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]


def _host_build(name: str, compiler: str, flags: list[str],
                source: Path) -> Path:
    """One host shared library, built at first use under the lock."""
    out_dir = build_dir()
    path = out_dir / f"lib{name}.so"
    with _Lock(out_dir):
        if not path.exists():
            cc = shutil.which(compiler)
            if cc is None:
                raise RuntimeError(f"{compiler} not found: cannot build "
                                   f"{source.name}")
            tmp = out_dir / f"lib{name}.so.tmp"
            res = subprocess.run([cc, *flags, "-o", str(tmp), str(source)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{compiler} failed:\n" + res.stderr)
            tmp.replace(path)
    return path


def build_host() -> Path:
    """The shared header compiled for the CPU with g++ (tests only)."""
    return _host_build("bn254_host", "g++", GXX_FLAGS + ["-I", str(CSRC)],
                       CSRC / HOST_SOURCE)


def native_lib(name: str) -> Path:
    """The host C library `name` of NATIVE_LIBS, built at first use."""
    return _host_build(name, "gcc", GCC_FLAGS, NATIVE / NATIVE_LIBS[name])


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong


def bind(library: ctypes.CDLL, fn: str, argtypes: list):
    f = getattr(library, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
