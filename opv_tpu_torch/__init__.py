"""opv_tpu_torch: the PyTorch/CUDA port of opv_tpu, the OPV MSK modem.

Layout mirrors opv_tpu/ so each counterpart is easy to find:
  config.py  the numerology (the JAX package's OPVConfig, pinned equal by
             a test; kept here so the port runs without the JAX package)
  core/      codec chain: base40, randomizer, conv code, interleaver, framing
  tx/        MSK modulator (the closed-form fast path and the
             reference-exact float64 path) and the TX frame multiplexer
             (COBS, priority-scheduled traffic -> 40 ms frames; host Python)
  rx/        sync, CFO, Viterbi twins, frame finisher, the feed-forward
             dense receiver (rx/fast.py: dense correlator, detect_frames,
             rx_fast), the locked-grid batch receiver (rx_locked /
             rx_locked_steady) with its re-acquire / retime functions, the
             polyphase analysis channelizer (one wideband stream -> K
             channels), the reference-parity tracking path (rx/demod.py's
             float64 AFC/TED loop, rx/sync.py's correlator and flywheel,
             rx/pipeline.py's rx_batch) and the coherent Costas loop
             (rx/coherent.py, rx_batch(coherent=True))
  stream/    the streaming receivers: LockedStreamDemodulator (synchronous
             or pipelined, eager serving, int8 rows with AGC, the strided
             hunt), MultiChannelDemodulator (rx_fast in overlapped
             blocks), WidebandReceiver (channelizer + either engine) and
             the tracking receivers StreamingDemodulator and
             MultiChannelTrackingDemodulator, with their checkpoint files
             (save_state / load_state)
  ops/       hand-written CUDA kernels (csrc/*.cu: the Viterbi, the fused
             soft stage, the exact TX's phase recurrence, the tracking
             loop T1 track_symbols, the sync flywheel T2 sync_scan with
             the sync correlation as an optional input stage) with their
             plain twins, the nvcc build, and the registry that
             dispatches between them
  io/        the int16 IQ wire format and the UDP frame bridge
  utils/     the reference's stderr formats and JSON-lines metrics
  cli/       opv_mod, opv_demod (batch, --fast, -c, -s, -s --fast,
             --channels, --wideband) and opv_modem, flag-compatible with
             the JAX package's
  entry.py   counterpart of __graft_entry__.entry() (rx_locked on a GPU)

Plain functions on tensors; the device comes from the input tensor (the
engines, the receivers and the CLIs take device=, "cuda" by default).  CPU
tensors run the plain PyTorch twins; CUDA tensors run the kernels (or
raise).  Nothing here imports jax or the JAX package.
"""

from opv_tpu_torch.config import CONFIG, OPVConfig

__all__ = [
    "OPVConfig", "CONFIG",
    # lazy (see __getattr__): importing the package loads no receiver
    "StreamingDemodulator", "MultiChannelDemodulator",
    "MultiChannelTrackingDemodulator",
    "rx_batch", "rx_fast", "rx_locked",
    "modulate_frames", "encode_frame", "build_bert_frame",
    "TxMultiplexer",
]

_LAZY = {
    "StreamingDemodulator": "opv_tpu_torch.stream",
    "MultiChannelDemodulator": "opv_tpu_torch.stream",
    "MultiChannelTrackingDemodulator": "opv_tpu_torch.stream",
    "rx_batch": "opv_tpu_torch.rx.pipeline",
    "rx_fast": "opv_tpu_torch.rx.fast",
    "rx_locked": "opv_tpu_torch.rx.locked",
    "modulate_frames": "opv_tpu_torch.tx",
    "encode_frame": "opv_tpu_torch.core",
    "build_bert_frame": "opv_tpu_torch.core",
    "TxMultiplexer": "opv_tpu_torch.tx.multiplexer",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'opv_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
