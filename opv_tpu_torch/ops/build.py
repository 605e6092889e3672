"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles every source (one nvcc process per source, all started
together) and links them into one shared library with a plain C interface,
loaded through ctypes: no PyTorch headers to compile.  The build happens at
the first CUDA call, never at import, into <checkout>/build/opv_tpu_torch/,
keyed by a hash of the sources and flags.  A failed build raises; nothing
falls back.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


#: the C functions the library exports: (argument types, return type)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "opv_viterbi": ([_P, _P, _P, _I, _I, _P], _I),
    "opv_symbol_soft": ([_P, ctypes.c_longlong, _I, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "opv_symbol_soft_config": ([_I, ctypes.POINTER(_I)], _I),
    "opv_phase_track": ([_P, ctypes.c_double, ctypes.c_double, _I,
                         ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_longlong,
                         _P], _I),
    "opv_track_symbols": ([_P, ctypes.c_longlong, _P, _P, _I, _I,
                           ctypes.POINTER(ctypes.c_double), _P, _P, _P, _P,
                           _P], _I),
    "opv_track_symbols_f32": ([_P, ctypes.c_longlong, ctypes.c_longlong, _P,
                               _P, _I, _I, ctypes.POINTER(ctypes.c_double),
                               _P, _P, _P, _P, _P], _I),
    "opv_sync_scan": ([_P, _P, _P, _I, _I, ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(_I), _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P], _I),
    "opv_sync_correlate_scan": ([_P, ctypes.c_longlong, _P, _I, _I,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(_I), ctypes.c_uint,
                                 *[_P] * 12], _I),
    "opv_sync_scan_f32": ([_P, _P, _P, _I, _I, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(_I), _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P], _I),
    "opv_sync_correlate_scan_f32": ([_P, ctypes.c_longlong, _P, _I, _I,
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.POINTER(_I), ctypes.c_uint,
                                     *[_P] * 12], _I),
    "opv_channelize": ([_P, _I, _I, ctypes.c_longlong, _P, _P, _P, _P], _I),
    "opv_error_string": ([_I], ctypes.c_char_p),
}


def library_path(srcs) -> pathlib.Path:
    """Where the library of `srcs` lives (a hash of sources and flags)."""
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libopv_kernels_{digest.hexdigest()[:16]}.so"


def compile_shared(srcs, so: pathlib.Path) -> float:
    """nvcc each source to an object (all at once), link them into `so`
    and write the compiler's output beside it (`so` with .log).  Returns
    the seconds taken; raises on any failure."""
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{p.stem}.{tag}.o") for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p, o in zip(srcs, objs)]
    outs = [p.communicate() for p in procs]
    log = "".join(out + err for out, err in outs)
    bad = [p.returncode for p in procs if p.returncode != 0]
    tmp = so.with_suffix(f".{tag}")
    if not bad:
        r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                            *map(str, objs)],
                           capture_output=True, text=True)
        log += r.stdout + r.stderr
        bad = [r.returncode] if r.returncode != 0 else []
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    if bad:
        raise RuntimeError(f"nvcc failed ({bad[0]}):\n{log}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def load(so: pathlib.Path) -> ctypes.CDLL:
    """Load a kernel library and declare the C signatures it exports."""
    lib = ctypes.CDLL(str(so))
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    so = library_path(srcs)
    seconds = 0.0 if so.exists() else compile_shared(srcs, so)
    log = so.with_suffix(".log")
    BUILD_INFO.update(path=str(so), seconds=seconds,
                      ptxas=log.read_text() if log.exists() else "")
    _lib = load(so)
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        name = lib.opv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {name} ({err})")


def stream_ptr(t) -> int:
    """The current stream of tensor t's device, as an integer handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
