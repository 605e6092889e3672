"""The polyphase analysis channelizer: hand-written CUDA kernel
(csrc/channelize.cu) and its plain PyTorch twin, one contract:

    x     (N,) complex64 wideband samples at K x fs_ch, contiguous
    k     channels, any K >= 1; taps: taps per branch, any >= 1;
          N >= K * taps
    -> (K, M) complex64 channel basebands at fs_ch, contiguous,
       M = (N - K * taps) // K + 1

The twin is rx/channelizer.py's polyphase_legs and dft_columns with the
whole dft_kernel(K): float32 legs in a fixed order, a float64 DFT product
rounded to complex64 once.  The kernel computes the same legs bit for bit
and the same product, summed in float64 in another order.  The twin is the
CPU path and the kernel's yardstick on the card; complex128 input runs it on
any device, with float64 legs (the kernel's legs are float32).  The mesh
receiver calls polyphase_legs and dft_columns per shard and stays on the
twin.  Replaces no Pallas kernel (the JAX package channelizes with XLA ops).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opv_tpu_torch.ops import build
from opv_tpu_torch.rx.channelizer import (_on_device, _real_dtype,
                                          channelize_cols, dft_kernel)


def channelize_reference(x: torch.Tensor, k: int,
                         taps: int = 12) -> torch.Tensor:
    """The plain twin (any device, complex64 or complex128)."""
    kern = _on_device("dft", k, taps, x.device, _real_dtype(x))
    return channelize_cols(x, kern, k, taps)


@functools.lru_cache(maxsize=None)
def _dft_pairs(k: int, device: torch.device) -> torch.Tensor:
    """The kernel's DFT operand on `device`: (K, K, 2) float32, [r, c] =
    (wr, wi) = dft_kernel(k)[2r, c] rounded to float32 as the twin rounds
    it (the im leg's row, (-wi, wr), is its exact negation)."""
    pairs = np.ascontiguousarray(dft_kernel(k)[0::2])
    return torch.from_numpy(pairs).to(device, torch.float32)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def channelize_cuda(x: torch.Tensor, k: int, taps: int = 12) -> torch.Tensor:
    """Launch the fused channelizer kernel; same contract as the twin.
    Raises before the launch on what the kernel does not take."""
    if not _on_card(x):
        raise ValueError("the CUDA channelizer kernel needs a CUDA tensor")
    if x.dtype != torch.complex64:
        raise ValueError(f"the channelizer kernel takes complex64, got "
                         f"{x.dtype} (complex128 runs the twin)")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N,) tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    k, taps = int(k), int(taps)
    if k < 1 or taps < 1:
        raise ValueError(f"need k >= 1 and taps >= 1, got {k}, {taps}")
    m = (x.shape[0] - k * taps) // k + 1
    if m < 1:
        raise ValueError(f"{x.shape[0]} samples are fewer than k * taps = "
                         f"{k * taps}")
    g = _on_device("taps", k, taps, x.device, torch.float32)
    w = _dft_pairs(k, x.device)
    out = torch.empty((k, m), dtype=torch.complex64, device=x.device)
    lib = build.library()
    err = lib.opv_channelize(x.data_ptr(), k, taps, m, g.data_ptr(),
                             w.data_ptr(), out.data_ptr(),
                             build.stream_ptr(x))
    build.check(lib, err, "channelize")
    channelize_cuda.launches += 1
    return out


channelize_cuda.launches = 0
