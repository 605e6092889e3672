"""opv_tpu_torch: the PyTorch/CUDA port of opv_tpu's locked-grid receiver.

Layout mirrors opv_tpu/ so each counterpart is easy to find:
  config.py  the numerology (the JAX package's OPVConfig, pinned equal by
             a test; kept here so the port runs without the JAX package)
  core/      codec chain: base40, randomizer, conv code, interleaver, framing
  tx/        MSK modulator (closed-form fast path)
  rx/        sync, CFO, dense correlator, Viterbi twins, frame finisher,
             the locked-grid batch receiver (rx_locked / rx_locked_steady)
             and its re-acquire / retime functions
  stream/    the synchronous streaming engine (LockedStreamDemodulator)
             and its checkpoint files (save_state / load_state)
  ops/       hand-written CUDA kernels (csrc/*.cu) with their plain twins,
             and the registry that dispatches between them
  entry.py   counterpart of __graft_entry__.entry() (rx_locked on a GPU)

Plain functions on tensors; the device comes from the input tensor (the
engine takes device=, "cuda" by default).  CPU tensors run the plain
PyTorch twins; CUDA tensors run the kernels (or raise).  Nothing here imports jax or the JAX package.
"""

from opv_tpu_torch.config import CONFIG

__all__ = ["CONFIG"]
