"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries land in ``repro_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The
build happens at the first launch, never at import: a machine without
``nvcc`` imports every module and runs the plain versions on the CPU.

Every wrapper adds one to :data:`LAUNCHES` under its kernel's name where it
launches that kernel, and nowhere else, so a run can show which kernels
carried it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each source: name → argtypes (every one returns the
# cudaError_t of its launch as an int)
SIGNATURES = {
    "counting": {
        "vertical_count": (_P, _I, _P, _I, _I, _P, _P),
        "support_count": (_P, _P, _I, _I, _I, _P, _P),
        "support_count_matmul": (_P, _P, _P, _I, _I, _I, _P, _P),
        "vertical_count_matmul": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    },
    "delta_count": {
        "delta_count": (_P, _P, _P, _I, _I, _I, _P, _P),
        "delta_count_matmul": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    },
    "rule_match": {
        "rule_scores": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _P),
        "rule_scores_matmul": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P,
                               _P),
    },
}

_SOURCE_OF = {fn: src for src, fns in SIGNATURES.items() for fn in fns}
LAUNCHES: dict[str, int] = {fn: 0 for fn in _SOURCE_OF}
BUILD_LOGS: dict[str, str] = {}     # source → nvcc's -Xptxas -v report

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _compile(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    # the shared headers are part of every source's text
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    BUILD_LOGS[name] = proc.stderr
    os.replace(tmp, lib)        # atomic: a concurrent build sees all or none
    return lib


def build_all() -> dict[str, Path]:
    """Compile every source, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futs = {name: pool.submit(_compile, name) for name in SIGNATURES}
        return {name: fut.result() for name, fut in futs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def launch(fn: str, *args) -> None:
    """Call C entry point ``fn`` on torch's current stream; raise on a
    non-zero cudaError_t and count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(_SOURCE_OF[fn]), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[fn] += 1
