"""The codec chain (counterpart of opv_tpu/core/): base40 callsigns, the
randomizer, the K=7 convolutional code, the interleaver and the frame
bit plumbing, under the JAX package's names."""

from opv_tpu_torch.core.base40 import base40_decode, base40_encode
from opv_tpu_torch.core.convcode import conv_encode_bits
from opv_tpu_torch.core.framing import (build_bert_frame, derandomize,
                                        encode_frame, frame_to_symbol_bits,
                                        pack_frame_bits)
from opv_tpu_torch.core.interleave import deinterleave_gather, interleave_perm
from opv_tpu_torch.core.lfsr import randomizer_mask

__all__ = [
    "base40_encode", "base40_decode",
    "randomizer_mask",
    "conv_encode_bits",
    "interleave_perm", "deinterleave_gather",
    "encode_frame", "build_bert_frame", "pack_frame_bits",
    "derandomize", "frame_to_symbol_bits",
]
