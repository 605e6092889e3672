"""Batched Viterbi: the hand-written CUDA kernel (csrc/viterbi.cu) and its
plain PyTorch twin, one contract:

    (B, 2144) int32 soft symbols in 0..7 -> (bits (B, 1072) uint8,
                                             metrics (B,) int32)

Replaces opv_tpu/ops/pallas/viterbi.py::viterbi_pallas (radix 4 ->
_viterbi_kernel_r4, radix 2 -> _viterbi_kernel).  Each radix has its own
wrapper with an integer launch counter, bumped where the kernel launches.
"""

from __future__ import annotations

import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import build
from opv_tpu_torch.rx.viterbi import viterbi_decode_batch, viterbi_decode_r4_batch

_EB = CONFIG.encoded_bits
_FB = CONFIG.frame_bits


def viterbi_reference(soft: torch.Tensor, radix: int = 4):
    """The plain twin (any device): the radix's batched torch ACS loop."""
    if radix == 4:
        return viterbi_decode_r4_batch(soft)
    if radix == 2:
        return viterbi_decode_batch(soft)
    raise ValueError(f"radix must be 2 or 4, got {radix}")


def _launch(soft: torch.Tensor, radix: int):
    if not soft.is_cuda:
        raise ValueError("the CUDA Viterbi kernel needs a CUDA tensor")
    if soft.dtype != torch.int32 or soft.dim() != 2 or soft.shape[1] != _EB:
        raise ValueError(f"soft must be (B, {_EB}) int32, got "
                         f"{tuple(soft.shape)} {soft.dtype}")
    if not soft.is_contiguous():
        raise ValueError("soft must be contiguous")
    b = soft.shape[0]
    bits = torch.empty((b, _FB), dtype=torch.uint8, device=soft.device)
    metrics = torch.empty((b,), dtype=torch.int32, device=soft.device)
    if b:
        lib = build.library()
        err = lib.opv_viterbi(soft.data_ptr(), bits.data_ptr(),
                              metrics.data_ptr(), b, radix,
                              build.stream_ptr(soft))
        build.check(lib, err, f"viterbi radix {radix}")
        CUDA_KERNELS[radix].launches += 1
    return bits, metrics


def viterbi_r4_cuda(soft: torch.Tensor):
    """Radix-4 kernel (two trellis steps per ACS, the default)."""
    return _launch(soft, 4)


def viterbi_r2_cuda(soft: torch.Tensor):
    """Radix-2 kernel (one trellis step per ACS)."""
    return _launch(soft, 2)


viterbi_r4_cuda.launches = 0
viterbi_r2_cuda.launches = 0
CUDA_KERNELS = {4: viterbi_r4_cuda, 2: viterbi_r2_cuda}
