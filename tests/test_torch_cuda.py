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

from chip_smoke import (COHERENT_RTOL, COHERENT_SYMBOLS,  # noqa: E402
                        MODES_WEAK_GAIN, capture, dense_blocks, dense_host,
                        drive_wideband, golden, golden_frames,
                        hold_stream_kernels,
                        hold_sync, hold_sync_soft, hold_track,
                        impaired_feed, k4_chunks, same_dense,
                        same_dense_tuples, same_stream,
                        same_tracking, same_wideband, serve_eager,
                        soft_stress, spy_kernels, stream_twin_checks,
                        SYNC_EDGE_CASES, sync_edge_case, sync_stress,
                        TRACK_EDGE_CASES, TRACK_F32_EDGE_CASES,
                        PRECISION_Q_TOL, track_edge_case, track_inputs,
                        viterbi_inputs, wideband_k4)
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
#: float64 rows: the same, float64 sums in another order
F64_RTOL = 1e-12

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


def _close64(got, want):
    assert got.dtype == want.dtype == torch.float64
    err = float((got - want).abs().max())
    assert err <= F64_RTOL * float(want.abs().max()), err


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
                channel bases 4, 8 or 12 bytes past a 16-byte boundary
                (float64 rows: 8 bytes)
    f64 rows are float64 (the complex128 path) of the same samples."""
    rows_dt = {"f32": torch.float32, "int8": torch.int8,
               "f64": torch.float64}[dtype]
    g = torch.Generator().manual_seed(17)
    if case == "many":
        shape = (grid + 7, 2 * tile + 2, 80)
        if dtype == "int8":
            return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)
        return (3000.0 * torch.randn(shape, generator=g, dtype=rows_dt)
                if rows_dt == torch.float64
                else 3000.0 * torch.randn(shape, generator=g)).to(dev)
    x, _ = _signal(1, (0, 13, 517), noise=1500.0)
    if dtype == "f64":
        x = x.to(torch.complex128)
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
        off = 4 if dtype == "int8" else 1
        buf = torch.zeros((c, m * 80 + off), dtype=rows_dt, device=dev)
        buf[:, off:] = rows.reshape(c, -1)
        rows = buf[:, off:].unflatten(1, (m, 80))
    return rows


@pytest.mark.parametrize("dtype,case", [
    ("f32", "signal"), ("int8", "signal"), ("f32", "one_channel"),
    ("int8", "one_channel"), ("f32", "many"), ("int8", "many"),
    ("f32", "odd_n"), ("f32", "sliced"), ("int8", "sliced"),
    ("f64", "signal"), ("f64", "one_channel"), ("f64", "many"),
    ("f64", "sliced")])
def test_soft_kernel_matches_twin(cuda_dev, dtype, case):
    """Each row type's instantiation against its twin (float64 rows within
    F64_RTOL: float64 sums in another order)."""
    rows_dt = {"f32": torch.float32, "int8": torch.int8,
               "f64": torch.float64}[dtype]
    cfg = ss.kernel_config(rows_dt)
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
    rows_type = {"f32": "float32", "int8": "int8", "f64": "float64"}[dtype]
    assert ss.symbol_soft_cuda.launches == {**n0, rows_type: n0[rows_type] + 2}
    close = _close64 if dtype == "f64" else _close
    assert got.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    close(got, ss.symbol_soft_reference(*ops, nsym))
    want_raw = ss.symbol_soft_reference(*ops, nsym, raw=True)
    if dtype == "int8":
        assert raw.dtype == want_raw.dtype == torch.int32
        assert torch.equal(raw, want_raw)
    else:
        close(raw, want_raw)
    # shorter nsym: one symbol, a tile less one, one tile, one more, a
    # multiple of the tile (the tile's closing row comes from the ring or
    # from the block's own extra row)
    for k in sorted({1, tile - 1, tile, tile + 1, 2 * tile, nsym - 1}):
        if not 0 < k < nsym:
            continue
        close(ss.symbol_soft_cuda(*ops, k), ss.symbol_soft_reference(*ops, k))
        raw_k = ss.symbol_soft_cuda(*ops, k, raw=True)
        raw_t = ss.symbol_soft_reference(*ops, k, raw=True)
        if dtype == "int8":
            assert torch.equal(raw_k, raw_t)
        else:
            close(raw_k, raw_t)


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


@pytest.mark.parametrize("k", [4, 64])
def test_channelize_on_card_matches_cpu(cuda_dev, k):
    """The channelizer on the card against the host: within 1e-5 of max|y|
    (the float64 DFT product makes them agree far closer)."""
    from opv_tpu_torch.rx.channelizer import channelize
    rng = np.random.default_rng(k)
    n = k * 12 * 4000 + 3 * k + 1
    x = torch.from_numpy(((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                          * 8000).astype(np.complex64))
    want = channelize(x, k)
    got = channelize(x.to(cuda_dev), k)
    assert got.is_cuda and got.shape == want.shape and got.is_contiguous()
    assert float((got.cpu() - want).abs().max()) <= RTOL * float(want.abs().max())


def test_wideband_receiver_on_card_matches_cpu(cuda_dev):
    """tests/test_wideband.py::test_streaming_decode's K = 4 signal through
    the WidebandReceiver on the card and on the host, ragged feeds: the
    same tuples (leakage on the quiet channels within same_wideband's
    bound), every frame of channels 0 and 2."""
    from opv_tpu_torch.stream import WidebandReceiver
    x, frames = wideband_k4()
    runs = [drive_wideband(WidebandReceiver(4, block_frames=3, device=dev), x,
                           chunks=k4_chunks(x.shape[0]))
            for dev in (cuda_dev, torch.device("cpu"))]
    same_wideband(runs[0], runs[1], frames, "wideband K=4 card vs cpu")
    for c in (0, 2):
        assert {r[1] for r in runs[0] if r[0] == c and r[2] <= 16} \
            == set(frames[c])


@pytest.mark.parametrize("channels", [1, 7])
def test_track_symbols_kernel_matches_twin(cuda_dev, channels):
    """The AFC/TED loop kernel against its twin on one chunk of the golden
    captures, then a second call from the carried state and leftover: the
    symbol counts and positions equal, soft and the state within
    chip_smoke.TRACK_RTOL (hold_track)."""
    from opv_tpu_torch.ops import track_symbols as ts
    x, nv, state = track_inputs(channels, cuda_dev)
    n0 = dict(ts.track_symbols_cuda.launches)
    (_, valid, st, used), _, _ = hold_track(x, nv, state, "first call")
    assert ts.track_symbols_cuda.launches == {**n0,
                                              "float64": n0["float64"] + 1}
    assert int(valid.sum()) >= 2160 * channels
    nxt = torch.stack([torch.from_numpy(capture(n)[u:u + x.shape[1]]).to(cuda_dev)
                       for n, u in zip(("bert3", "cfo500", "awgn10", "awgn7",
                                        "awgn8", "dropout", "drift"),
                                       used.tolist())])[:channels]
    hold_track(nxt, nv, st, "second call")


@pytest.mark.parametrize("name", TRACK_EDGE_CASES)
def test_track_symbols_kernel_at_ring_edges(cuda_dev, name):
    """The AFC/TED loop kernel against its twin where its shared-memory
    sample ring meets an edge (chip_smoke.track_edge_case): a whole-capture
    launch, caps below a tile with n_valid under the gate, a window
    clamped at cap - 64, more blocks than SMs, a view at a storage
    offset."""
    x, nv, state = track_edge_case(name, cuda_dev)
    (_, valid, st, used), _, _ = hold_track(x, nv, state, name)
    n_sym = valid.sum(1).tolist()
    if name == "cap 64":
        assert n_sym == [0, 0] and used.tolist() == [0, 0]
        assert torch.equal(st.cpu(), state.cpu())
    elif name == "cap 100":
        assert n_sym == [0, 2]
    elif name.startswith("clamp"):
        assert n_sym == [61]
    elif name == "whole capture":
        assert n_sym[0] > 17_000
    else:
        assert min(n_sym) >= 2160


def test_sync_scan_kernel_matches_twin(cuda_dev):
    """The state machine kernel (GivenSync) bit for bit against its twin on
    inputs that reach every transition (chip_smoke.sync_stress), counted
    once as GivenSync."""
    from opv_tpu_torch.ops import sync_scan as sc
    n0 = dict(sc.sync_scan_cuda.launches)
    (_, _, ready, _, events, _, _), _ = hold_sync(*sync_stress(64, 2284, cuda_dev),
                                                  "stress")
    assert sc.sync_scan_cuda.launches == {**n0,
                                          "GivenSync": n0["GivenSync"] + 1}
    assert set(events.unique().tolist()) == set(range(6))
    assert int(ready.sum()) > 0


#: (channels, symbols) of the sync kernel's shape grid: every width at
#: every tile edge and the main path's chunk; a whole capture at 1 and 3
SYNC_SHAPES = [(c, s) for c in (1, 3, 64, 133) for s in (0, 1, 31, 32, 33, 2284)] \
    + [(1, 26_000), (3, 26_000)]


@pytest.mark.parametrize("channels,steps", SYNC_SHAPES)
def test_sync_scan_kernels_at_shapes(cuda_dev, channels, steps):
    """Both instantiations of the sync kernel bit for bit against their
    twins at every width and tile edge: GivenSync on sync_stress,
    SoftSync on soft_stress (raw and norm too), each counted once."""
    from opv_tpu_torch.ops import sync_scan as sc
    n0 = dict(sc.sync_scan_cuda.launches)
    hold_sync(*sync_stress(channels, steps, cuda_dev), f"{channels}x{steps}")
    hold_sync_soft(*soft_stress(channels, steps, cuda_dev),
                   f"{channels}x{steps}")
    assert sc.sync_scan_cuda.launches == {**n0,
                                          "GivenSync": n0["GivenSync"] + 1,
                                          "SoftSync": n0["SoftSync"] + 1}


@pytest.mark.parametrize("name", SYNC_EDGE_CASES)
def test_sync_scan_kernels_at_edges(cuda_dev, name):
    """Both instantiations on chip_smoke.sync_edge_case (GivenSync on the
    correlation of the same soft stream): short rows, 133 channels, a
    whole capture, events at lanes 0 and 31 and two in a tile, carries at
    the int32 edges, a view 8 bytes off 16."""
    from opv_tpu_torch.rx.sync import sync_correlate
    x, valid, ints, q = sync_edge_case(name, cuda_dev)
    got, _ = hold_sync_soft(x, valid, ints, q, name)
    raw, norm = sync_correlate(x)
    hold_sync(raw, norm, valid, ints, q, name)
    if name == "tile edges":
        at = [np.flatnonzero(e) for e in got[4].cpu().numpy()]
        lanes = {int(t) % 32 for row in at for t in row}
        assert {0, 31} <= lanes
        assert any((np.diff(row // 32) == 0).any() for row in at)
        assert set(got[4].unique().tolist()) == set(range(6))
    if name == "view":
        assert x.data_ptr() % 16 == 8 and x.stride(0) > x.shape[1]


@pytest.mark.parametrize("channels", [1, 7])
def test_track_symbols_f32_kernel_matches_twin(cuda_dev, channels):
    """track_symbols[float32] against its float32 twin on one chunk of the
    golden captures (complex64), then a second call from the carried state
    and leftover: counts and positions equal, soft and the state within
    chip_smoke.TRACK_F32_RTOL; counted as float32 only."""
    from opv_tpu_torch.ops import track_symbols as ts
    x, nv, state = track_inputs(channels, cuda_dev, torch.float32)
    n0 = dict(ts.track_symbols_cuda.launches)
    (soft, valid, st, used), _, _ = hold_track(x, nv, state, "first call")
    assert ts.track_symbols_cuda.launches == {**n0,
                                              "float32": n0["float32"] + 1}
    assert soft.dtype == st.dtype == torch.float32
    assert int(valid.sum()) >= 2160 * channels
    nxt = torch.stack([torch.from_numpy(capture(n)[u:u + x.shape[1]])
                       .to(cuda_dev, torch.complex64)
                       for n, u in zip(("bert3", "cfo500", "awgn10", "awgn7",
                                        "awgn8", "dropout", "drift"),
                                       used.tolist())])[:channels]
    hold_track(nxt, nv, st, "second call")


@pytest.mark.parametrize("name", TRACK_EDGE_CASES + TRACK_F32_EDGE_CASES)
def test_track_symbols_f32_kernel_at_ring_edges(cuda_dev, name):
    """track_symbols[float32] against its twin at the edges of its sample
    ring (chip_smoke.track_edge_case at float32): TRACK_EDGE_CASES, and
    complex64 rows of odd length or off 16 bytes, which the wrapper pads
    for the 16-byte bulk copies."""
    x, nv, state = track_edge_case(name, cuda_dev, torch.float32)
    (_, valid, _, _), _, _ = hold_track(x, nv, state, name)
    n_sym = valid.sum(1).tolist()
    if name == "cap 64":
        assert n_sym == [0, 0]
    elif name.startswith("clamp"):
        assert n_sym == [61]
    elif name == "odd rows":
        assert n_sym[0] > 240 and n_sym[2] > 20
    elif name in ("C=133", "storage offset", "odd cap"):
        assert min(n_sym) >= 2160


@pytest.mark.parametrize("channels,steps", [(1, 31), (3, 33), (64, 2284),
                                            (133, 2284), (1, 26_000)])
def test_sync_scan_f32_kernels_match_twins(cuda_dev, channels, steps):
    """Both float32 instantiations of the sync kernel bit for bit against
    their float32 twins (GivenSync on sync_stress with norms on the locked
    threshold as float32 rounds it, SoftSync on soft_stress), each counted
    once as float32."""
    from opv_tpu_torch.ops import sync_scan as sc
    raw, norm, valid, ints, q = sync_stress(channels, steps, cuda_dev)
    norm[5::6] = CONFIG.sync_locked_norm_thresh
    n0 = dict(sc.sync_scan_cuda.launches)
    hold_sync(raw.float(), norm.float(), valid, ints, q.float(),
              f"float32 {channels}x{steps}")
    x, valid, ints, q = soft_stress(channels, steps, cuda_dev)
    got, _ = hold_sync_soft(x.float(), valid, ints, q.float(),
                            f"float32 {channels}x{steps}")
    assert got[3].dtype == got[7].dtype == torch.float32
    assert sc.sync_scan_cuda.launches == {
        **n0, "GivenSync,float32": n0["GivenSync,float32"] + 1,
        "SoftSync,float32": n0["SoftSync,float32"] + 1}


def test_streaming_f32_on_card_matches_cpu(cuda_dev):
    """StreamingDemodulator(dtype="float32") on bert3 on the card: the
    reference's frames, and the tuples of the same receiver on the host
    given the card's CFO estimate."""
    from opv_tpu_torch.stream import StreamingDemodulator
    x = capture("bert3")
    sd = StreamingDemodulator(device=cuda_dev, dtype="float32")
    got = sd.feed(x) + sd.flush()
    cpu = StreamingDemodulator(device="cpu", dtype="float32",
                               init_offset=sd.est_offset)
    want = cpu.feed(x) + cpu.flush()
    assert [t[0] for t in got] == golden_frames("bert3.frames")
    same_tracking(got, want, "float32 bert3", PRECISION_Q_TOL)


def test_rx_block_runs_one_soft_sync_launch(cuda_dev, monkeypatch):
    """rx_block_from_soft on the card (soft_stress's stream as the block,
    its first 23 symbols the history's last): one SoftSync launch, no
    GivenSync launch and no torch correlation (sync_correlate raises if
    called); every output equal to the same block on the host."""
    from opv_tpu_torch.ops import sync_scan as sc
    from opv_tpu_torch.rx import pipeline, sync
    x, valid, _, _ = soft_stress(8, 2284, torch.device("cpu"))
    hist = torch.zeros((8, EB), dtype=torch.float64)
    hist[:, -23:] = x[:, :23]

    def run(dev):
        st = sync.sync_tracker_init(8, device=dev)
        return pipeline.rx_block_from_soft(x[:, 23:].to(dev), valid.to(dev),
                                           st, hist.to(dev), 3,
                                           with_events=True)
    want = run(torch.device("cpu"))

    def no_torch_correlation(*_):
        raise AssertionError("sync_correlate ran on the tracking path")
    monkeypatch.setattr(sync, "sync_correlate", no_torch_correlation)
    monkeypatch.setattr(sc, "sync_correlate", no_torch_correlation)
    n0 = dict(sc.sync_scan_cuda.launches)
    got = run(cuda_dev)
    torch.cuda.synchronize()
    assert sc.sync_scan_cuda.launches == {**n0,
                                          "SoftSync": n0["SoftSync"] + 1}
    assert int(got[0]["events"].count_nonzero()) > 0
    for k, w in want[0].items():
        assert torch.equal(got[0][k].cpu(), w), k
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.parametrize("name,gold", [("bert3", "bert3.frames"),
                                       ("dropout", "dropout.frames")])
def test_streaming_on_card_matches_cpu(cuda_dev, name, gold):
    """StreamingDemodulator on the card: the reference's frames, and the
    tuples of the same receiver on the host (q within TRACK_Q_TOL)."""
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.stream import StreamingDemodulator
    x = capture(name)
    registry.reset_launch_counts()
    sd = StreamingDemodulator(device=cuda_dev)
    got = sd.feed(x) + sd.flush()
    counts = registry.launch_counts()
    assert min(counts[k] for k in ("track_symbols", "sync_scan[SoftSync]",
                                   "viterbi_r4")) > 0
    assert [t[0] for t in got] == golden_frames(gold)
    sd = StreamingDemodulator(device="cpu")
    same_tracking(got, sd.feed(x) + sd.flush(), f"{name} card vs cpu")


def _cfo_mix():
    """bert3 at 0, -400 and -900 Hz, (3, N) complex64 on the host."""
    s = capture("bert3")
    n = np.arange(len(s))
    return torch.from_numpy(np.stack([
        (s * np.exp(2j * np.pi * f * n / CONFIG.sample_rate)).astype(np.complex64)
        for f in (0.0, -400.0, -900.0)]))


@pytest.mark.parametrize("case", ["bert3", "cfo_mix"])
def test_rx_fast_on_card_matches_cpu(cuda_dev, case):
    """rx_fast on the card against the cpu twin given the cpu's CFO
    (chip_smoke.same_dense: frames, valid and starts equal, a start one
    sample away only at a plateau tie; q within DENSE_Q_TOL); one Viterbi
    launch over every slot, and the reference's frames."""
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.rx import fast
    x = (torch.from_numpy(capture("bert3").astype(np.complex64))[None]
         if case == "bert3" else _cfo_mix())
    want = dense_host(fast.rx_fast(x, max_frames=6))
    foff = torch.from_numpy(want["freq_offset"]).to(cuda_dev)
    kern = vit.CUDA_KERNELS[registry.get_viterbi_radix()]
    n0 = kern.launches
    got = dense_host(fast.rx_fast(x.to(cuda_dev), foff, max_frames=6))
    assert kern.launches == n0 + 1
    raw = fast.dense_sync(fast.dense_soft(x.to(cuda_dev), foff))[0]
    same_dense(got, want, raw.cpu().numpy(), f"rx_fast {case}")
    gold = np.frombuffer(golden("bert3.frames"), np.uint8).reshape(-1, 134)
    for c in range(x.shape[0]):
        np.testing.assert_array_equal(got["frames"][c][got["frame_valid"][c]],
                                      gold)


def test_multichannel_on_card_matches_cpu(cuda_dev):
    """MultiChannelDemodulator on the card against the cpu given each
    block's card CFO estimate: every block's slots held (same_dense), the
    tuple streams equal up to plateau ties."""
    from opv_tpu_torch.stream import MultiChannelDemodulator
    x, frames = _signal(6, [0, 17, 40 + 23])
    record = []
    with dense_blocks(record=record):
        mc = MultiChannelDemodulator(3, block_frames=2, device=cuda_dev)
        got = mc.feed(x.to(cuda_dev)) + mc.flush()
    with dense_blocks(replay=record, what="card vs cpu") as st:
        mc = MultiChannelDemodulator(3, block_frames=2, device="cpu")
        want = mc.feed(x) + mc.flush()
    same_dense_tuples(got, want, "MultiChannelDemodulator card vs cpu")
    assert st["blocks"] == len(record) > 1
    assert sorted(r[1] for r in got) == sorted(
        bytes(f) for f in frames.numpy() for _ in range(3))


def test_coherent_rx_batch_on_card(cuda_dev):
    """rx_batch(coherent=True) on the card: bert3's four reference
    observables, one SoftSync and one Viterbi launch, and the soft stream
    within COHERENT_RTOL of the cpu port's over its first COHERENT_SYMBOLS
    symbols (the loop is chaotic beyond)."""
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.ops import sync_scan as sc
    from opv_tpu_torch.rx.pipeline import rx_batch
    s = capture("bert3")
    kern = vit.CUDA_KERNELS[registry.get_viterbi_radix()]
    n_v, n_s = kern.launches, sc.sync_scan_cuda.launches["SoftSync"]
    got = rx_batch(s, coherent=True, device=cuda_dev)
    assert (kern.launches, sc.sync_scan_cuda.launches["SoftSync"]) == \
        (n_v + 1, n_s + 1)
    assert float(got["est_offset"]) == 1430.0 and got["decoded"] == 0
    assert float(got["freq_offset"]) == 2000.0
    assert int(got["tracker_state"]) == 0
    want = rx_batch(s, coherent=True, device="cpu")
    k = COHERENT_SYMBOLS
    err = np.abs(got["soft"][:k] - want["soft"][:k]).max()
    assert err <= COHERENT_RTOL * np.abs(want["soft"][:k]).max()


# ------------------------------------------------- the mesh modes on the card


def _card_mesh(dev, axes):
    from opv_tpu_torch.parallel import make_mesh
    return make_mesh(axes, devices=[dev] * int(np.prod(list(axes.values()))))


@pytest.mark.parametrize("kw", [dict(), dict(pipeline=True),
                                dict(dtype="int8")],
                         ids=["float32", "pipelined", "int8_agc"])
def test_sharded_engine_on_card_equals_unsharded(cuda_dev, kw):
    """The locked engine on a ('ch'=4) mesh naming the card four times: the
    unsharded engine's tuples on the card, exactly (channels 0-3 clean and
    staggered, 4-7 the gap-burst pattern), K3 and K1 launched per shard."""
    x, _ = _signal(5, [0, 997, 1994, 2991])
    four, _ = impaired_feed(x.to(cuda_dev), cuda_dev)
    feed = torch.cat([x.to(cuda_dev)[:, :four.shape[1]], four])

    def run(**mesh):
        sd = LockedStreamDemodulator(8, block_frames=2, device=cuda_dev,
                                     **kw, **mesh)
        out = []
        for off in range(0, feed.shape[1], 123_457):
            out += sd.feed(feed[:, off:off + 123_457])
        return out + sd.flush(), sd

    want, _ = run()
    registry.reset_launch_counts()
    got, sd = run(mesh=_card_mesh(cuda_dev, {"ch": 4}))
    launches = registry.launch_counts()
    assert got == want and len(want) >= 20
    assert [tuple(p.shape) for p in sd._buf.parts] == \
        [(2, sd.window // 40, 80)] * 4
    rows = "int8" if kw.get("dtype") == "int8" else "float32"
    assert launches["viterbi_r4"] > 0 and launches[f"symbol_soft[{rows}]"] > 0


def test_sharded_rx_fast_on_card(cuda_dev):
    """rx_fast_sharded ('ch'=4) and rx_time_sharded ('time'=2) on the card:
    the unsharded rx_fast's frames and count; one K1 launch per shard."""
    from opv_tpu_torch.parallel import rx_fast_sharded, rx_time_sharded
    from opv_tpu_torch.rx.fast import rx_fast
    x, frames = _signal(4, [0, 13, 27, 39])
    x = x.to(cuda_dev)
    want = rx_fast(x, max_frames=6)
    registry.reset_launch_counts()
    got, n = rx_fast_sharded(_card_mesh(cuda_dev, {"ch": 4}), x,
                             max_frames_per_shard=6)
    assert registry.launch_counts()["viterbi_r4"] == 4
    assert torch.equal(got, want["frames"])
    assert int(n) == int(want["n_decoded"]) == 16
    one = x[:1, : 2 * (x.shape[1] // 2)]
    out = rx_time_sharded(_card_mesh(cuda_dev, {"time": 2}), one,
                          max_frames_per_shard=4)
    owned = out["owned"][0]
    assert int(out["n"]) == 4
    assert torch.equal(out["frames"][0][owned].cpu(), frames)
    starts = out["starts"][0][owned].cpu().numpy()
    assert np.abs(starts - np.arange(4) * CONFIG.samples_per_frame).max() <= 1


def test_grid_stream_on_card(cuda_dev, tmp_path):
    """ShardedStreamDemodulator on a (ch=2, time=2) mesh of the card: every
    frame once and byte-exact over feeds that straddle windows, and a
    checkpoint taken mid-stream resumes to the same tuples."""
    from opv_tpu_torch.stream import (ShardedStreamDemodulator, load_state,
                                      save_state)
    x, frames = _signal(6, [0, 311])
    x = x.to(cuda_dev)
    mesh = _card_mesh(cuda_dev, {"ch": 2, "time": 2})

    def feed(sd, lo, hi):
        out = []
        for off in range(lo, hi, 70_001):
            out += sd.feed(x[:, off:min(off + 70_001, hi)])
        return out

    sd = ShardedStreamDemodulator(mesh, 2, max_frames_per_shard=4)
    cut = x.shape[1] // 2
    head = feed(sd, 0, cut)
    save_state(str(tmp_path / "ck"), sd.state_tree())
    tail = feed(sd, cut, x.shape[1]) + sd.flush()
    for c in range(2):
        got = [r[1] for r in head + tail if r[0] == c]
        assert got == [bytes(f) for f in frames.numpy()]
    sd2 = ShardedStreamDemodulator(mesh, 2, max_frames_per_shard=4)
    sd2.load_state_tree(load_state(str(tmp_path / "ck"), sd2.state_tree()))
    assert feed(sd2, cut, x.shape[1]) + sd2.flush() == tail
