"""The yardstick's table of peaks and the work of each measured kernel.

Published NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W
limit): HBM bytes/s, float32 outside the tensor cores and float64 on
them.  int32 issue is the card's own: 64 lanes per SM at its highest SM
clock (nvidia-smi).  A kernel's
bound is the larger of its bytes over the HBM rate and its operations over
their peak, counting each input byte read once and each output byte
written once."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64_tensor": 67e12}

#: int32 operations of the Viterbi per trellis state per step (two adds, a
#: compare and a select) and per step shared by the 64 states (the four
#: branch metrics of a rate-1/2 code)
VITERBI_OPS_PER_STATE_STEP = 4
VITERBI_OPS_PER_STEP = 4


def int32_ops_per_s() -> float:
    """64 lanes per SM at the card's highest SM clock."""
    import torch
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * float(out) * 1e6


def bound_s(nbytes: float, work) -> float:
    """Seconds the least a kernel could take: `work` is [(operations,
    their peak rate)], whose times add, against the bytes at HBM rate."""
    return max(nbytes / HBM_BYTES_PER_S, sum(n / r for n, r in work))


def channelize_work(n_in: int, k: int, m: int, taps: int):
    """(bytes, work) of one channelize call: the wideband input read once
    and the (K, M) complex64 output written once; the float32 polyphase legs
    (a multiply and an add per tap and real component) and the float64 DFT
    product (2 x M x 2K x 2K) on the tensor cores."""
    return (8 * n_in + 8 * k * m,
            [(m * k * 2 * taps * 2, PEAK_OPS_PER_S["f32"]),
             (2 * m * (2 * k) ** 2, PEAK_OPS_PER_S["f64_tensor"])])


def symbol_soft_bytes(channels: int, rows: int) -> int:
    """Bytes of one soft-stage launch over float32 window rows: the (C, M,
    80) rows and the (C, 80, 8) columns read, the (C, M - 1) soft values
    written."""
    return channels * (rows * 80 * 4 + 80 * 8 * 4 + (rows - 1) * 4)


def viterbi_work(frames: int, int32_rate: float):
    """(bytes, work) of the Viterbi over B frames: each int32 soft value
    read once, each bit and metric written once, and every state's
    add-compare-select at every trellis step."""
    eb, fb = 2144, 1072
    return (frames * (eb * 4 + fb + 4),
            [(frames * fb * (64 * VITERBI_OPS_PER_STATE_STEP
                             + VITERBI_OPS_PER_STEP), int32_rate)])
