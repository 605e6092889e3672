"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, loaded through ctypes: no PyTorch headers to compile.  The
build happens at the first CUDA call, never at import, into
<checkout>/build/opv_tpu_torch/, keyed by a hash of the sources and flags.
A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "opv_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what the last load did: library path, build seconds (0 when cached),
#: and the compiler's resource report (registers, shared memory, spills)
BUILD_INFO: dict = {}
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libopv_kernels_{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            *map(str, srcs)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log.write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.opv_viterbi.argtypes = [p, p, p, i, i, p]
    lib.opv_viterbi.restype = i
    lib.opv_symbol_soft.argtypes = [p, ll, i, p, p, p, p, i, i, i, p]
    lib.opv_symbol_soft.restype = i
    lib.opv_error_string.argtypes = [i]
    lib.opv_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=str(so), seconds=seconds,
                      ptxas=log.read_text() if log.exists() else "")
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        name = lib.opv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {name} ({err})")


def stream_ptr(t) -> int:
    """The current stream of tensor t's device, as an integer handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
