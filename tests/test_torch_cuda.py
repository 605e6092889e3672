"""Card-only tests of the PyTorch port's hand-written CUDA kernels against
their plain twins.  They skip without a CUDA device (a CUDA kernel has no
CPU mode).  This file imports no jax, so on a GPU host without jax run it
alone, without the suite's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import (MODES_WEAK_GAIN, hold_stream_kernels,  # noqa: E402
                        impaired_feed, same_stream, serve_eager, spy_kernels,
                        stream_twin_checks, viterbi_inputs)
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.core.framing import build_bert_frame, encode_frame  # noqa: E402
from opv_tpu_torch.ops import registry  # noqa: E402
from opv_tpu_torch.ops import symbol_soft as ss  # noqa: E402
from opv_tpu_torch.ops import viterbi as vit  # noqa: E402
from opv_tpu_torch.rx.locked import (rx_locked, rx_locked_steady,  # noqa: E402
                                     soft_stage_operands, to_window_rows)
from opv_tpu_torch.stream import LockedStreamDemodulator  # noqa: E402
from opv_tpu_torch.tx.modulator import (iq_int16_to_complex, modulate_frames,  # noqa: E402
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


def _viterbi_check(soft, radix):
    """The kernel of `radix` on `soft`, launched once, against its twin."""
    n0 = vit.CUDA_KERNELS[radix].launches
    bits, metrics = vit.CUDA_KERNELS[radix](soft)
    torch.cuda.synchronize()
    assert vit.CUDA_KERNELS[radix].launches == n0 + 1
    b_t, m_t = vit.viterbi_reference(soft, radix)
    assert torch.equal(bits, b_t) and torch.equal(metrics, m_t)
    return bits, metrics


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b", [1, 131, 1280])
def test_viterbi_kernel_matches_twin(cuda_dev, radix, b):
    """Clean encodes (metric 0), tie stress, wide values (best metrics
    beyond -2^25, final metrics straddling it) and random rows."""
    soft, u = viterbi_inputs(b, cuda_dev, np.random.default_rng(b))
    bits, metrics = _viterbi_check(soft, radix)
    k = min(3, b)
    assert torch.equal(bits[:k], u[:k]) and int(metrics[:k].abs().sum()) == 0


@pytest.mark.parametrize("radix", [2, 4])
def test_viterbi_kernel_takes_misaligned_view(cuda_dev, radix):
    """A contiguous soft view whose base sits 4 bytes past a 16-byte
    boundary: the kernel stages it with 4-byte loads."""
    rows, _ = viterbi_inputs(131, cuda_dev, np.random.default_rng(3))
    buf = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=cuda_dev)
    soft = buf[1:].view(rows.shape)
    soft.copy_(rows)
    assert soft.is_contiguous() and soft.data_ptr() % 16 == 4
    _viterbi_check(soft, radix)


def test_viterbi_kernel_rejects_bad_input(cuda_dev):
    with pytest.raises(ValueError):
        vit.viterbi_r4_cuda(torch.zeros((2, EB), dtype=torch.int64, device=cuda_dev))
    with pytest.raises(ValueError):
        vit.viterbi_r2_cuda(torch.zeros((2, EB + 1), dtype=torch.int32, device=cuda_dev))


def _soft_rows(case, dtype, dev, grid, tile):
    """Window rows on the card for one case of the soft-kernel test:
    signal      3 channels of a noisy burst (contiguous rows)
    one_channel 1 channel of it
    many        more channels than the kernel's persistent grid has
                blocks, each two tiles and two rows long
    odd_n       (3, N) complex64 with N odd: channel c of the float32 view
                starts at byte 8*N*c, so odd channels are 8-byte aligned only
    sliced      rows cut from a longer buffer at an offset of 4 bytes:
                channel bases 4, 8 or 12 bytes past a 16-byte boundary"""
    rows_dt = torch.float32 if dtype == "f32" else torch.int8
    g = torch.Generator().manual_seed(17)
    if case == "many":
        shape = (grid + 7, 2 * tile + 2, 80)
        if dtype == "int8":
            return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)
        return (3000.0 * torch.randn(shape, generator=g)).to(dev)
    x, _ = _signal(1, (0, 13, 517), noise=1500.0)
    if case == "one_channel":
        x = x[1:2]
    if case == "odd_n":
        x = torch.cat([x, torch.zeros((x.shape[0], 1), dtype=x.dtype)], 1).to(dev)
        assert x.shape[1] % 2 == 1 and x.is_contiguous()
        return x
    rows = to_window_rows(x.to(dev), rows_dt)
    if case == "sliced":
        # one float32 element, or four int8 ones (the kernel takes int8
        # channels on a 4-byte boundary)
        c, m, _ = rows.shape
        off = 1 if dtype == "f32" else 4
        buf = torch.zeros((c, m * 80 + off), dtype=rows_dt, device=dev)
        buf[:, off:] = rows.reshape(c, -1)
        rows = buf[:, off:].unflatten(1, (m, 80))
    return rows


@pytest.mark.parametrize("dtype,case", [
    ("f32", "signal"), ("int8", "signal"), ("f32", "one_channel"),
    ("int8", "one_channel"), ("f32", "many"), ("int8", "many"),
    ("f32", "odd_n"), ("f32", "sliced"), ("int8", "sliced")])
def test_soft_kernel_matches_twin(cuda_dev, dtype, case):
    cfg = ss.kernel_config(dtype == "int8")
    tile = cfg["threads"] * cfg["rows_per_thread"]
    samples = _soft_rows(case, dtype, cuda_dev, cfg["grid"], tile)
    c = samples.shape[0]
    rng = np.random.default_rng(9)
    r = torch.from_numpy(rng.integers(0, 40, c)).to(cuda_dev)
    foff = torch.from_numpy(rng.uniform(-400, 400, c).astype(np.float32)).to(cuda_dev)
    frac = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).to(cuda_dev)
    scale = torch.from_numpy(rng.uniform(110, 160, c).astype(np.float32)).to(cuda_dev)
    m = samples.shape[1] if samples.dim() == 3 else samples.shape[1] // 40
    nsym = m - 1
    ops = soft_stage_operands(samples, r, foff, nsym,
                              scale if dtype == "int8" else None, frac)
    if case in ("odd_n", "sliced"):   # the kernel reads the misaligned view
        assert ops[0].data_ptr() % 16 or ops[0].stride(0) * ops[0].element_size() % 16
    n0 = dict(ss.symbol_soft_cuda.launches)
    got = ss.symbol_soft_cuda(*ops, nsym)
    raw = ss.symbol_soft_cuda(*ops, nsym, raw=True)
    torch.cuda.synchronize()
    rows_type = "float32" if dtype == "f32" else "int8"
    assert ss.symbol_soft_cuda.launches == {**n0, rows_type: n0[rows_type] + 2}
    _close(got, ss.symbol_soft_reference(*ops, nsym))
    want_raw = ss.symbol_soft_reference(*ops, nsym, raw=True)
    if dtype == "int8":
        assert raw.dtype == want_raw.dtype == torch.int32
        assert torch.equal(raw, want_raw)
    else:
        _close(raw, want_raw)
    # shorter nsym: one symbol, a tile less one, one tile, one more, a
    # multiple of the tile (the tile's closing row comes from the ring or
    # from the block's own extra row)
    for k in sorted({1, tile - 1, tile, tile + 1, 2 * tile, nsym - 1}):
        if not 0 < k < nsym:
            continue
        _close(ss.symbol_soft_cuda(*ops, k), ss.symbol_soft_reference(*ops, k))
        raw_k = ss.symbol_soft_cuda(*ops, k, raw=True)
        raw_t = ss.symbol_soft_reference(*ops, k, raw=True)
        if dtype == "int8":
            assert torch.equal(raw_k, raw_t)
        else:
            _close(raw_k, raw_t)


@pytest.mark.parametrize("odd_n", [False, True])
def test_slice_on_card_matches_cpu_twins(cuda_dev, odd_n):
    """rx_locked and rx_locked_steady through the kernels decode what the
    CPU twins decode, and every kernel of the path launched.  With N odd,
    the soft kernel reads channels whose base is not 16-byte aligned."""
    x, frames = _signal(3, (0, 13, 37), noise=2000.0, seed=1)
    if odd_n:
        x = torch.cat([x, torch.zeros((x.shape[0], 1), dtype=x.dtype)], 1)
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
    assert min(registry.launch_counts()[k] for k in (
        "viterbi_r4", "viterbi_r2", "symbol_soft[float32]",
        "symbol_soft[int8]")) > 0
    for k in ("frames", "metrics", "frame_valid", "decode_ok", "p0"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
        assert torch.equal(steady2[k], steady[k]), k
    assert float((gpu["freq_offset"].cpu() - cpu["freq_offset"]).abs().max()) <= 1.0
    for c in range(2):
        assert torch.equal(steady["frames"][c].cpu(), frames)


@pytest.mark.parametrize("name,offsets", [("cfo500", (0, 17)), ("awgn8", (0, 29))])
def test_golden_captures_on_card_match_cpu_twins(cuda_dev, name, offsets):
    """rx_locked through the kernels on the golden captures decodes what the
    CPU twins decode, and so does the steady body on int8 rows."""
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    raw = np.fromfile(golden / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    s = torch.from_numpy((raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64))
    x = torch.stack([torch.cat([torch.zeros(o, dtype=s.dtype), s])[:len(s)]
                     for o in offsets])
    n_frames = len(s) // CONFIG.samples_per_frame - 1
    cpu = rx_locked(x, n_frames=n_frames)
    registry.reset_launch_counts()
    gpu = rx_locked(x.to(cuda_dev), n_frames=n_frames)
    rows = to_window_rows(x, torch.int8)
    st_cpu = rx_locked_steady(rows, cpu["p0"], cpu["freq_offset"], n_frames,
                              frac=cpu["frac"])
    st_gpu = rx_locked_steady(rows.to(cuda_dev), gpu["p0"], gpu["freq_offset"],
                              n_frames, frac=gpu["frac"])
    torch.cuda.synchronize()
    counts = registry.launch_counts()
    assert counts["viterbi_r4"] > 0 and counts["symbol_soft[float32]"] > 0
    assert counts["symbol_soft[int8]"] > 0
    for k in ("frames", "metrics", "frame_valid", "decode_ok", "p0"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
        assert torch.equal(st_gpu[k].cpu(), st_cpu[k]), k
    assert float((gpu["freq_offset"].cpu() - cpu["freq_offset"]).abs().max()) <= 1.0


def test_stream_engine_and_reacquire_on_card_match_cpu_twins(cuda_dev):
    """The streaming engine on the card against the engine on the CPU on a
    4-channel impaired feed (clean, two in AWGN 2000, the gap-burst
    pattern), float32 and int8 rows: identical tuple streams, sync quality
    within 1e-4.  rx_locked_reacquire (mixed keep) and rx_locked_retime on
    its first window: p0, frames, metrics, burst_only and the deltas equal,
    freq_offset within 1 Hz, frac within 1e-3."""
    x, _ = _signal(20, (0, 488, 976))
    feed, grid = impaired_feed(x.to(cuda_dev), cuda_dev)
    registry.reset_launch_counts()
    out = stream_twin_checks(feed, grid, cuda_dev)
    assert min(registry.launch_counts()[k] for k in (
        "viterbi_r4", "symbol_soft[float32]", "symbol_soft[int8]")) > 0
    p0 = out["reacquire_p0"]                  # channels 0 and 2 kept
    assert p0[0] == grid[0] and p0[2] == grid[2] and abs(p0[1] - grid[1]) <= 1
    assert out["tuples"]["float32"] > 0


def _windowed(sd, feed):
    """chip_smoke.drive_stream's feeding: one window, then advance-sized
    chunks (each completes one block), then flush()."""
    out = sd.feed(feed[:, :sd.window])
    for off in range(sd.window, feed.shape[1], sd.advance):
        out += sd.feed(feed[:, off:off + sd.advance])
    return out + sd.flush()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pipelined_engine_on_card_equals_synchronous(cuda_dev, dtype):
    """The pipelined engine on the card (event-gated fetches, pinned
    staging) emits the synchronous card engine's tuples on the 4-channel
    impaired feed, and matches the pipelined CPU engine.  int8 runs with
    AGC, fed as chip_smoke.py feeds: fed otherwise, an AGC update can read
    other statistics in the two engines (ROADMAP queue 3)."""
    x, _ = _signal(20, (0, 488, 976))
    feed, _ = impaired_feed(x.to(cuda_dev), cuda_dev)
    runs = []
    for pipe, dev in ((True, cuda_dev), (False, cuda_dev),
                      (True, torch.device("cpu"))):
        sd = LockedStreamDemodulator(4, block_frames=4, dtype=dtype,
                                     pipeline=pipe, device=dev)
        runs.append((_windowed(sd, feed.to(dev)), sd.reacquisitions))
    same_stream(runs[0][0], runs[1][0], "pipelined vs synchronous, card")
    same_stream(runs[0][0], runs[2][0], "pipelined card vs cpu")
    assert runs[0][1] == runs[1][1] == runs[2][1] >= 2


def test_int8_agc_soft_kernel_takes_per_channel_steps(cuda_dev):
    """An int8 AGC engine with a weak channel: its first steady K3 call,
    with the per-channel rescale scale/127, held against the twin on the
    engine's own operands (and the re-acquire block's float32 call)."""
    x, frames = _signal(12, (0, 488, 976))
    x[2] *= MODES_WEAK_GAIN
    sd = LockedStreamDemodulator(3, block_frames=4, dtype="int8",
                                 device=cuda_dev)
    held, remove = spy_kernels(sd)
    try:
        out = _windowed(sd, x.to(cuda_dev))
    finally:
        remove()
    assert sd._scale_np[2] < 1.0 < sd._scale_np[0]
    resc = held[("steady", "soft")][2]
    assert torch.allclose(resc.cpu(), torch.from_numpy(sd._scale_np) / 127.0)
    hold_stream_kernels(held, "int8 agc")
    for c in range(3):
        assert [r[1] for r in out if r[0] == c] == \
            [bytes(f) for f in frames.numpy()]


def test_eager_serving_on_card(cuda_dev):
    """opv-modem --fast's engine on the card (1 channel, block_frames 1,
    eager): the window-gated engine's tuples, one frame-sized feed ahead."""
    x, frames = _signal(8, (0, 123))
    runs = serve_eager(x.to(cuda_dev), cuda_dev)
    same_stream(runs[True][0], runs[False][0], "eager vs window-gated")
    assert [r[1] for r in runs[True][0]] == [bytes(f) for f in frames.numpy()]
    cb, ce = np.cumsum(runs[False][1]), np.cumsum(runs[True][1])
    first = int(np.argmax(ce > 0))
    assert (ce[first:] - cb[first:] == 1).all()


def test_phase_track_kernel_matches_twin(cuda_dev):
    """The exact modulator's phase recurrence on the card equals the twin
    bit for bit over 3 frames from a non-reset state (start phases near
    the wrap points, so the recurrence wraps on the first samples)."""
    from opv_tpu_torch.ops import phase_track as pt
    from opv_tpu_torch.tx.modulator import _INC1, _INC2
    ph0 = torch.tensor([-3.1, 3.14], dtype=torch.float64)
    n = 3 * CONFIG.samples_per_frame
    n0 = pt.phase_track_cuda.launches
    got, got_f = pt.phase_track_cuda(ph0.to(cuda_dev), (_INC1, _INC2), n)
    torch.cuda.synchronize()
    assert pt.phase_track_cuda.launches == n0 + 1
    ref, ref_f = pt.phase_track_reference(ph0, (_INC1, _INC2), n)
    assert torch.equal(got.cpu(), ref) and torch.equal(got_f.cpu(), ref_f)
    one, one_f = pt.phase_track_cuda(ph0[:1].to(cuda_dev), (_INC1,), 7)
    r1, r1_f = pt.phase_track_reference(ph0[:1], (_INC1,), 7)
    assert torch.equal(one.cpu(), r1) and torch.equal(one_f.cpu(), r1_f)


def test_exact_modulator_on_card_equals_reference_capture(cuda_dev):
    """modulate_frames(exact=True) on the card: tests/golden/bert3.iq byte
    for byte, and a stream carried across calls equals one call."""
    golden = pathlib.Path(__file__).resolve().parent / "golden"
    enc = encode_frame(torch.from_numpy(
        build_bert_frame("W5NYV", frame_num=np.arange(3))).to(cuda_dev))
    iq, st = modulate_frames(enc, exact=True)
    wire = torch.cat([iq.cpu(), tx_flush_zeros()]).numpy().astype("<i2")
    assert wire.tobytes() == (golden / "bert3.iq").read_bytes()
    a, st_a = modulate_frames(enc[:1], exact=True)
    b, st_b = modulate_frames(enc[1:], st_a, exact=True)
    assert torch.equal(torch.cat([a, b]), iq)
    assert float(st_b.phase_f1) == float(st.phase_f1)
