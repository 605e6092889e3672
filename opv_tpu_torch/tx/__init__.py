"""The transmitter (counterpart of opv_tpu/tx/): the MSK modulator's
paths under the JAX package's names; the frame multiplexer is
tx/multiplexer.py."""

from opv_tpu_torch.tx.modulator import (ModulatorState, mod_reset,
                                        modulate_bits_exact,
                                        modulate_bits_fast,
                                        modulate_bits_wire, modulate_frames,
                                        symbol_signs, tx_flush_zeros)

__all__ = [
    "ModulatorState", "mod_reset", "symbol_signs",
    "modulate_bits_exact", "modulate_bits_fast", "modulate_bits_wire",
    "modulate_frames",
    "tx_flush_zeros",
]
