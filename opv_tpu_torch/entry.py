"""Counterparts of the entry points of __graft_entry__.py for the port:
entry(), the locked-grid batch receiver as one forward step on a CUDA
tensor, and dryrun_multichip(n), the multi-device programs (the sharded
locked engine, the sharded wideband receiver, the grid stream) over an
n-entry mesh, each checked bit-exact."""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """-> (step, example_args): step(samples) runs rx_locked(samples,
    n_frames=1, estimate_cfo_flag=True) and returns (frames, metrics,
    frame_valid, n_decoded)."""
    from opv_tpu_torch.rx.locked import rx_locked

    def step(samples):
        out = rx_locked(samples, n_frames=1, estimate_cfo_flag=True)
        return (out["frames"], out["metrics"], out["frame_valid"],
                out["n_decoded"])

    c, n = 1, 178_000
    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))
         ).astype(np.complex64) * 1000.0).to(device)
    return step, (example,)


def mesh_devices(n_devices: int, devices=None) -> list:
    """n_devices entries for a mesh: `devices` (default: the visible CUDA
    devices) repeated in turn when there are fewer of them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device visible; "
                               "pass devices= (e.g. ['cpu'])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    return [devices[i % len(devices)] for i in range(n_devices)]


def _tx_signal(n_frames: int):
    """A BERT transmission through the port's fast TX (host): ((N,)
    complex64 with the trailing zero flush, (n_frames, 134) uint8)."""
    from opv_tpu_torch.core import build_bert_frame, encode_frame
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                            modulate_frames, tx_flush_zeros)
    frames = build_bert_frame("W5NYV", frame_num=np.arange(n_frames))
    iq, _ = modulate_frames(encode_frame(torch.from_numpy(frames)))
    s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
    return s.numpy(), np.asarray(frames)


def _dryrun_locked(n_devices: int, devices: list) -> None:
    """The production engine over a ('ch'=n) mesh: one channel per shard,
    per-channel delays (a distinct grid p0 on every shard), two feeds and
    a flush, every payload checked bit-exact."""
    from opv_tpu_torch.parallel.mesh import make_mesh
    from opv_tpu_torch.stream.locked import LockedStreamDemodulator

    mesh = make_mesh({"ch": n_devices}, devices)
    n_frames = 6
    s, frames = _tx_signal(n_frames)
    sig = np.zeros((n_devices, len(s) + 4000), np.complex64)
    for c in range(n_devices):
        sig[c, c * 487: c * 487 + len(s)] = s

    sd = LockedStreamDemodulator(channels=n_devices, block_frames=1,
                                 mesh=mesh)
    cut = sd.window + 12_345
    results = sd.feed(sig[:, :cut])
    results += sd.feed(sig[:, cut:])
    results += sd.flush()

    shard_rows = {tuple(p.shape) for p in sd._buf.parts}
    assert shard_rows == {(1, sd.window // 40, 80)}, (
        f"window buffer not 1-channel-per-shard: {shard_rows}")
    assert len(results) == n_devices * n_frames, (
        f"locked dryrun decoded {len(results)}, "
        f"expected {n_devices * n_frames}")
    for c in range(n_devices):
        got = [r for r in results if r[0] == c]
        assert [r[1] for r in got] == [bytes(f) for f in frames], (
            f"channel {c} payload mismatch")
        pos = np.array([r[4] for r in got])
        # every frame within one sample of the channel's grid (a warm-up
        # retime may step the grid onto the apex plateau's centre)
        exp = c * 487 + np.arange(n_frames) * 86_720
        assert np.max(np.abs(pos - exp)) <= 1, (c, pos, exp)
    print(f"dryrun locked engine OK: ('ch'={n_devices}) mesh, "
          f"{len(results)} frames bit-exact over multiple streamed batches "
          f"(sharded steady/re-acquire/append/slide, summed counts)")


def _dryrun_grid(n_devices: int, devices: list) -> None:
    """(ch x time) grid: the rolling-window sharded stream (halo exchange,
    summed counts) with exact cross-window seam handoff."""
    from opv_tpu_torch.parallel.mesh import make_mesh
    from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
    from opv_tpu_torch.stream.sharded import ShardedStreamDemodulator

    nch = 2 if n_devices % 4 == 0 else 1
    ntime = n_devices // nch
    mesh = make_mesh({"ch": nch, "time": ntime}, devices)

    # the smallest legal window that still advances by >= 2 halos a step
    shard = max(HALO_SAMPLES, -(-2 * HALO_SAMPLES // ntime))
    shard = -(-shard // 128) * 128
    sd = ShardedStreamDemodulator(mesh, channels=nch, shard_samples=shard,
                                  max_frames_per_shard=6)

    # enough frames for two full windows and a flushed tail
    n_frames = (sd.window + sd.advance) // 86_720 + 1
    s, frames = _tx_signal(n_frames)
    samples = np.stack([s] * nch)

    cut = sd.window + 1000
    results = sd.feed(samples[:, :cut])
    results += sd.feed(samples[:, cut:])
    results += sd.flush()

    expect = nch * n_frames
    assert len(results) == expect, (
        f"grid dryrun decoded {len(results)} frames, expected {expect}")
    for c in range(nch):
        got = np.stack([np.frombuffer(r[1], np.uint8)
                        for r in results if r[0] == c])
        assert np.array_equal(got, frames), "grid dryrun payload mismatch"
    print(f"dryrun grid OK: mesh=({nch}x{ntime}), {len(results)} frames "
          f"decoded bit-exact across {n_devices} shards over multiple "
          f"streamed batches with seam handoff")


def _dryrun_wideband(n_devices: int, devices: list) -> None:
    """The wideband receiver over a ('ch'=n) mesh, K = n: the window
    replicated per device, each shard's DFT columns and engine shard on
    its device; every active channel's frames bit-exact, no clean-metric
    frame on a quiet channel."""
    from opv_tpu_torch.core import build_bert_frame
    from opv_tpu_torch.parallel.mesh import make_mesh
    from opv_tpu_torch.rx.channelizer import (msk_wideband,
                                              synthesize_wideband,
                                              wideband_test_channels)
    from opv_tpu_torch.stream.wideband import WidebandReceiver

    k = n_devices
    mesh = make_mesh({"ch": n_devices}, devices)
    nf = 3
    active = {c: call for c, call in zip(wideband_test_channels(k),
                                         ["W5NYV", "TEST"])}
    sets, wb = {}, {}
    lead = torch.zeros(2000 * k, dtype=torch.complex128)
    for c, call in active.items():
        sets[c] = build_bert_frame(call, frame_num=np.arange(nf) + 7 * c)
        wb[c] = torch.cat([lead, msk_wideband(sets[c], k, device="cpu")])
    x = synthesize_wideband(wb, k, max(len(v) for v in wb.values()),
                            device="cpu").to(torch.complex64)

    rx = WidebandReceiver(k, block_frames=1, mesh=mesh)
    out = rx.feed(x[: rx.window])          # prime exactly one window
    off = rx.window
    while off + rx.quantum <= len(x):      # steady quanta
        out += rx.feed(x[off:off + rx.quantum])
        off += rx.quantum
    out += rx.feed(x[off:])
    out += rx.flush()

    shard_rows = {tuple(p.shape) for p in rx.demod._buf.parts}
    assert shard_rows == {(1, rx.demod.window // 40, 80)}, (
        f"wideband engine buffer not 1-channel-per-shard: {shard_rows}")
    for c, expected in sets.items():
        rows = sorted(((p, np.frombuffer(fb, np.uint8))
                       for cc, fb, m, q, p in out if cc == c and m <= 16),
                      key=lambda t: t[0])
        assert rows, f"wideband channel {c} decoded nothing"
        got = np.stack([f for _, f in rows])
        assert np.array_equal(got, np.asarray(expected)), (
            f"wideband channel {c} payload mismatch")
    quiet = sum(1 for cc, fb, m, q, p in out
                if cc not in sets and m <= 16)
    assert quiet == 0, "clean-metric frames on quiet channels"
    print(f"dryrun wideband OK: ('ch'={n_devices}) mesh, K={k} channels, "
          f"each shard's DFT columns on its device, "
          f"{sum(len(s) for s in sets.values())} frames bit-exact")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The multi-device programs over n_devices mesh entries (counterpart
    of __graft_entry__.dryrun_multichip): the locked engine and the
    wideband receiver on a ('ch'=n) mesh, the grid stream on a (ch x time)
    one.  devices: the visible CUDA devices by default, repeated when
    there are fewer than n_devices (a mesh may name one device several
    times)."""
    devs = mesh_devices(n_devices, devices)
    _dryrun_locked(n_devices, devs)
    _dryrun_wideband(n_devices, devs)
    _dryrun_grid(n_devices, devs)
