"""The locked-grid soft stage: hand-written CUDA kernel (csrc/symbol_soft.cu)
and its plain PyTorch twin, one contract:

    rows  (C, M, 80) float32, int8 or float64 window rows (row s = samples
          [40s, 40s+40) as interleaved I/Q; rows of a channel contiguous)
    kern  (C, 80, 8) float32 columns, int8 round(k*127) for int8 rows,
          float64 for float64 rows
    resc  (C,) rescale of the correlation (1 for float rows)
    phi   (C, 2, 2) e^{-j inc_k 40} per tone, as [tone][re, im]
    -> soft (C, nsym),
       |A_2(s) + phi_2 B_2(s+1)|^2 - |A_1(s) + phi_1 B_1(s+1)|^2

resc, phi and soft are float64 for float64 rows (the JAX package's
complex128 path) and float32 otherwise.
with ab = rows @ kern per channel (columns [ReA ReA ReB ReB ImA ImA ImB
ImB]).  Replaces opv_tpu/ops/pallas/correlate.py::symbol_corr_pallas
(_corr_kernel) together with _symbol_soft_batch's combine.  raw=True
returns the (C, nsym+1, 8) correlation instead (int32 for int8 rows), so
the int8 dot can be held exactly against the twin's integer contraction.
"""

from __future__ import annotations

import ctypes

import torch

from opv_tpu_torch.ops import build
from opv_tpu_torch.rx.fast import combine

_ROW = 80
#: the kernel's row types (opv_symbol_soft's row_type) and their real dtype
ROW_TYPES = {torch.float32: 0, torch.int8: 1, torch.float64: 2}
_NAMES = {torch.float32: "float32", torch.int8: "int8",
          torch.float64: "float64"}


def real_of(rows_dtype) -> torch.dtype:
    """The dtype of resc, phi and soft for rows of rows_dtype."""
    return torch.float64 if rows_dtype == torch.float64 else torch.float32


def correlate_reference(rows: torch.Tensor, kern: torch.Tensor,
                        nsym: int) -> torch.Tensor:
    """Plain (C, nsym+1, 8) correlation: float32 einsum for float rows
    (float64 for float64 rows); for int8 rows an exact int32 contraction
    (widened before the product, one channel at a time: integer matmuls
    are not available on every device)."""
    rows = rows[:, : nsym + 1]
    if rows.dtype == torch.int8:
        k = kern.to(torch.int32)
        return torch.stack([
            (rows[c].to(torch.int32)[:, :, None] * k[c]).sum(1, dtype=torch.int32)
            for c in range(rows.shape[0])])
    return torch.einsum("cst,cto->cso", rows.to(real_of(rows.dtype)), kern)


def combine_reference(ab: torch.Tensor, resc: torch.Tensor,
                      phi: torch.Tensor) -> torch.Tensor:
    """(C, nsym+1, 8) correlation -> (C, nsym) soft values, in resc's
    dtype."""
    return combine(ab.to(resc.dtype) * resc[:, None, None],
                   torch.view_as_complex(phi))


def symbol_soft_reference(rows, kern, resc, phi, nsym: int,
                          raw: bool = False) -> torch.Tensor:
    """The plain twin (any device)."""
    ab = correlate_reference(rows, kern, nsym)
    return ab if raw else combine_reference(ab, resc, phi)


def symbol_soft_cuda(rows: torch.Tensor, kern: torch.Tensor,
                     resc: torch.Tensor, phi: torch.Tensor, nsym: int,
                     raw: bool = False) -> torch.Tensor:
    """Launch the fused soft-stage kernel; same contract as the twin."""
    c = rows.shape[0]
    int8 = rows.dtype == torch.int8
    if not rows.is_cuda:
        raise ValueError("the CUDA soft-stage kernel needs CUDA tensors")
    if rows.dtype not in ROW_TYPES:
        raise ValueError(f"rows must be float32, int8 or float64, got "
                         f"{rows.dtype}")
    if rows.dim() != 3 or rows.shape[2] != _ROW or rows.stride(2) != 1 \
            or rows.stride(1) != _ROW:
        raise ValueError("rows must be (C, M, 80) with contiguous rows")
    if not 0 < nsym < rows.shape[1]:
        raise ValueError(f"nsym={nsym} needs 0 < nsym < M={rows.shape[1]}")
    if int8 and (rows.stride(0) % 4 or rows.data_ptr() % 4):
        raise ValueError("int8 rows need a 4-byte aligned channel stride")
    real = real_of(rows.dtype)
    want_k = torch.int8 if int8 else real
    for name, t, shape, dt in (("kern", kern, (c, _ROW, 8), want_k),
                               ("resc", resc, (c,), real),
                               ("phi", phi, (c, 2, 2), real)):
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous() \
                or t.device != rows.device:
            raise ValueError(f"{name} must be a contiguous {shape} {dt} "
                             f"tensor on {rows.device}")
    if raw:
        out = torch.empty((c, nsym + 1, 8),
                          dtype=torch.int32 if int8 else real,
                          device=rows.device)
    else:
        out = torch.empty((c, nsym), dtype=real, device=rows.device)
    launch(build.library(), rows, kern, resc, phi, out, nsym, raw)
    symbol_soft_cuda.launches[_NAMES[rows.dtype]] += 1
    return out


#: launches per row type (one kernel template, three instantiations)
symbol_soft_cuda.launches = {"float32": 0, "int8": 0, "float64": 0}


def launch(lib: ctypes.CDLL, rows, kern, resc, phi, out, nsym: int,
           raw: bool) -> None:
    """Launch `lib`'s opv_symbol_soft on checked operands (no counting:
    symbol_soft_cuda is the entry point; scripts/soft_sweep.py calls this
    with libraries built from copies of the source)."""
    err = lib.opv_symbol_soft(rows.data_ptr(), rows.stride(0),
                              ROW_TYPES[rows.dtype], kern.data_ptr(),
                              resc.data_ptr(), phi.data_ptr(), out.data_ptr(),
                              rows.shape[0], nsym, int(raw),
                              build.stream_ptr(rows))
    build.check(lib, err, "symbol_soft")


def moved_bytes(rows, kern, resc, phi, nsym: int) -> int:
    """The bytes the soft stage must move: each input read once (rows 0..
    nsym), the (C, nsym) soft stream written once (resc's element size)."""
    return (rows[:, : nsym + 1].numel() * rows.element_size()
            + sum(t.numel() * t.element_size() for t in (kern, resc, phi))
            + rows.shape[0] * nsym * resc.element_size())


def kernel_config(rows, lib: ctypes.CDLL | None = None) -> dict:
    """The kernel's launch configuration for one row type (a torch dtype
    of the rows, or a bool: int8 rows or float32 rows) on the current CUDA
    device: threads per block, rows per thread, ring stages, dynamic shared
    memory per block and the persistent grid (SMs x blocks/SM)."""
    lib = build.library() if lib is None else lib
    code = ROW_TYPES[rows] if isinstance(rows, torch.dtype) else int(rows)
    cfg = (ctypes.c_int * 5)()
    build.check(lib, lib.opv_symbol_soft_config(code, cfg),
                "symbol_soft config")
    return dict(zip(("threads", "rows_per_thread", "stages", "smem_bytes",
                     "grid"), cfg))
