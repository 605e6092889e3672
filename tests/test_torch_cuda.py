"""Card-only tests of the PyTorch port's hand-written CUDA kernels against
their plain twins.  They skip without a CUDA device (a CUDA kernel has no
CPU mode).  This file imports no jax, so on a GPU host without jax run it
alone, without the suite's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.convcode import conv_encode_bits
from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
from opv_tpu_torch.ops import registry
from opv_tpu_torch.ops import symbol_soft as ss
from opv_tpu_torch.ops import viterbi as vit
from opv_tpu_torch.rx.locked import (rx_locked, rx_locked_steady,
                                     soft_stage_operands, to_window_rows)
from opv_tpu_torch.tx.modulator import (iq_int16_to_complex, modulate_frames,
                                        tx_flush_zeros)

EB = CONFIG.encoded_bits
#: float32 soft values: |kernel - twin| <= 1e-5 * max|twin| (80-term sums in
#: another order, fused multiply-adds in the combine)
RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _signal(n_frames, delays, noise=0.0, seed=0):
    frames = torch.from_numpy(build_bert_frame("W5NYV", frame_num=np.arange(n_frames)))
    iq, _ = modulate_frames(encode_frame(frames))
    s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
    n = -(-(len(s) + max(delays)) // 40) * 40
    x = torch.zeros((len(delays), n), dtype=torch.complex64)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    if noise:
        g = torch.Generator().manual_seed(seed)
        x += noise * torch.complex(torch.randn(x.shape, generator=g),
                                   torch.randn(x.shape, generator=g))
    return x, frames


def _close(got, want):
    err = float((got.double() - want.double()).abs().max())
    assert err <= RTOL * float(want.abs().max()), err


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b", [1, 131, 1280])
def test_viterbi_kernel_matches_twin(cuda_dev, radix, b):
    rng = np.random.default_rng(b)
    u = torch.from_numpy(rng.integers(0, 2, (3, CONFIG.frame_bits)).astype(np.uint8))
    clean = torch.where(conv_encode_bits(u) == 1, 7, 0).to(torch.int32)
    tie = np.concatenate([rng.integers(0, 2, (4, EB)), np.zeros((2, EB)),
                          np.full((2, EB), 7), rng.integers(3, 5, (2, EB))])
    soft = torch.cat([clean, torch.from_numpy(np.concatenate(
        [tie, rng.integers(0, 8, (b, EB))]).astype(np.int32))])[:b]
    soft = soft.contiguous().to(cuda_dev)
    n0 = vit.CUDA_KERNELS[radix].launches
    bits, metrics = vit.CUDA_KERNELS[radix](soft)
    torch.cuda.synchronize()
    assert vit.CUDA_KERNELS[radix].launches == n0 + 1
    b_t, m_t = vit.viterbi_reference(soft, radix)
    assert torch.equal(bits, b_t) and torch.equal(metrics, m_t)
    k = min(3, b)
    assert torch.equal(bits[:k].cpu(), u[:k]) and int(metrics[:k].abs().sum()) == 0


def test_viterbi_kernel_rejects_bad_input(cuda_dev):
    with pytest.raises(ValueError):
        vit.viterbi_r4_cuda(torch.zeros((2, EB), dtype=torch.int64, device=cuda_dev))
    with pytest.raises(ValueError):
        vit.viterbi_r2_cuda(torch.zeros((2, EB + 1), dtype=torch.int32, device=cuda_dev))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_soft_kernel_matches_twin(cuda_dev, dtype):
    x, _ = _signal(1, (0, 13, 517), noise=1500.0)
    rng = np.random.default_rng(9)
    c = x.shape[0]
    r = torch.from_numpy(rng.integers(0, 40, c)).to(cuda_dev)
    foff = torch.from_numpy(rng.uniform(-400, 400, c).astype(np.float32)).to(cuda_dev)
    frac = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).to(cuda_dev)
    scale = torch.from_numpy(rng.uniform(110, 160, c).astype(np.float32)).to(cuda_dev)
    rows = to_window_rows(x.to(cuda_dev), torch.float32 if dtype == "f32" else torch.int8)
    nsym = rows.shape[1] - 1
    ops = soft_stage_operands(rows, r, foff, nsym,
                              scale if dtype == "int8" else None, frac)
    n0 = ss.symbol_soft_cuda.launches
    got = ss.symbol_soft_cuda(*ops, nsym)
    raw = ss.symbol_soft_cuda(*ops, nsym, raw=True)
    torch.cuda.synchronize()
    assert ss.symbol_soft_cuda.launches == n0 + 2
    _close(got, ss.symbol_soft_reference(*ops, nsym))
    want_raw = ss.symbol_soft_reference(*ops, nsym, raw=True)
    if dtype == "int8":
        assert raw.dtype == want_raw.dtype == torch.int32
        assert torch.equal(raw, want_raw)
    else:
        _close(raw, want_raw)
    # a shorter nsym reads only its rows; nsym a multiple of the tile too
    for k in (nsym - 1, 128, 1):
        _close(ss.symbol_soft_cuda(*ops, k), ss.symbol_soft_reference(*ops, k))
        raw_k = ss.symbol_soft_cuda(*ops, k, raw=True)
        raw_t = ss.symbol_soft_reference(*ops, k, raw=True)
        if dtype == "int8":
            assert torch.equal(raw_k, raw_t)
        else:
            _close(raw_k, raw_t)


def test_slice_on_card_matches_cpu_twins(cuda_dev):
    """rx_locked and rx_locked_steady through the kernels decode what the
    CPU twins decode, and every kernel of the path launched."""
    x, frames = _signal(3, (0, 13, 37), noise=2000.0, seed=1)
    cpu = rx_locked(x, n_frames=3)
    registry.reset_launch_counts()
    gpu = rx_locked(x.to(cuda_dev), n_frames=3)
    rows = to_window_rows(x.to(cuda_dev), torch.int8)
    steady = rx_locked_steady(rows, gpu["p0"], gpu["freq_offset"], 3, frac=gpu["frac"])
    registry.set_viterbi_radix(2)
    try:
        steady2 = rx_locked_steady(rows, gpu["p0"], gpu["freq_offset"], 3,
                                   frac=gpu["frac"])
    finally:
        registry.set_viterbi_radix(4)
    torch.cuda.synchronize()
    assert min(registry.launch_counts().values()) > 0
    for k in ("frames", "metrics", "frame_valid", "decode_ok", "p0"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
        assert torch.equal(steady2[k], steady[k]), k
    assert float((gpu["freq_offset"].cpu() - cpu["freq_offset"]).abs().max()) <= 1.0
    for c in range(2):
        assert torch.equal(steady["frames"][c].cpu(), frames)
