"""Sample and frame I/O of the port: the int16 IQ wire format and the UDP
frame bridge (counterparts of opv_tpu/io/)."""

from opv_tpu_torch.io.iq import (complex_to_iq_bytes, int16_pairs_to_complex,
                                 iq_bytes_to_complex, iq_bytes_to_f32_pairs,
                                 iq_bytes_to_i16_pairs)
from opv_tpu_torch.io.udp import UDPFrameBridge

__all__ = ["iq_bytes_to_complex", "complex_to_iq_bytes", "iq_bytes_to_f32_pairs",
           "int16_pairs_to_complex", "UDPFrameBridge", "iq_bytes_to_i16_pairs"]
