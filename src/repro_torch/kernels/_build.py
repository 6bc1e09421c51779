"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library, then loaded with
:mod:`ctypes`.  The libraries go to ``$REPRO_TORCH_BUILD`` when that is
set, else to ``build/torch_kernels/`` at the root of the source checkout
the package runs from, else (an installed copy) to
``~/.cache/repro_torch/kernels``.  Nothing is built at import: the first launch builds every
source, one ``nvcc`` process per source, all started together.  A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()`` right after its launch, and
:func:`check` raises on a non-zero code: a refused launch never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")


def _build_dir() -> Path:
    if os.environ.get("REPRO_TORCH_BUILD"):
        return Path(os.environ["REPRO_TORCH_BUILD"])
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").exists() and (root / "src").is_dir():
        return root / "build" / "torch_kernels"
    return Path.home() / ".cache" / "repro_torch" / "kernels"


BUILD_DIR = _build_dir()
SOURCES = ("event_synapse", "lif_update", "c2c_matmul", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the entry points: (argtypes, restype) per symbol.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "event_synapse": {
        "event_synapse_f32": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
        "event_synapse_packed_i8": [_P, _L, _P, _L, _F, _P, _I, _P, _I, _I,
                                    _I, _P],
    },
    "lif_update": {
        "lif_scan_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _P],
        "empty_launch": [_L, _I, _P],
    },
    "c2c_matmul": {
        "c2c_matmul_f32_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "ssd_scan": {
        "ssd_scan_f32": [_P] * 8 + [_L] * 9 + [_I] * 6 + [_P],
    },
}

# Launches per kernel, bumped by each wrapper where it launches its kernel;
# the packed kernel's launches also by weight bit-width.
launches = {"event_synapse": 0, "event_synapse_packed": 0, "lif_update": 0,
            "c2c_matmul": 0, "ssd_scan": 0}
packed_launches_by_bits = {8: 0, 4: 0, 2: 0}

# nvcc's report per source (registers, shared memory, spills from -Xptxas -v)
build_log: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for counts in (launches, packed_launches_by_bits):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns the seconds
    spent.  Raises with nvcc's output if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if not _libs:
            build_all()
            for src in SOURCES:
                lib = ctypes.CDLL(str(_target(src)))
                for sym, argtypes in SIGNATURES[src].items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.error_string.argtypes = [ctypes.c_int]
                lib.error_string.restype = ctypes.c_char_p
                _libs[src] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
