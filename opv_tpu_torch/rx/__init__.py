"""The receiver stages (counterpart of opv_tpu/rx/), under the JAX
package's names."""

from opv_tpu_torch.rx.viterbi import viterbi_decode, viterbi_decode_batch
from opv_tpu_torch.rx.frame_decoder import decode_payloads
from opv_tpu_torch.rx.cfo import estimate_cfo
from opv_tpu_torch.rx.sync import (SyncTrackerState, sync_correlate,
                                   sync_scan, sync_tracker_init)
from opv_tpu_torch.rx.demod import LoopState, demodulate_block, loop_state_init

__all__ = [
    "viterbi_decode", "viterbi_decode_batch", "decode_payloads",
    "estimate_cfo", "SyncTrackerState", "sync_tracker_init", "sync_scan",
    "sync_correlate", "LoopState", "loop_state_init", "demodulate_block",
]
