"""The streaming engine of the port: LockedStreamDemodulator (synchronous)
and its checkpoint files."""

from opv_tpu_torch.stream.locked import LockedStreamDemodulator
from opv_tpu_torch.stream.state import load_state, save_state

__all__ = ["LockedStreamDemodulator", "save_state", "load_state"]
