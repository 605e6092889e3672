"""The streaming receivers of the port: LockedStreamDemodulator (the
multichannel engine), WidebandReceiver (channelizer + engine) and their
checkpoint files."""

from opv_tpu_torch.stream.locked import LockedStreamDemodulator
from opv_tpu_torch.stream.state import load_state, save_state
from opv_tpu_torch.stream.wideband import WidebandReceiver

__all__ = ["LockedStreamDemodulator", "WidebandReceiver", "save_state",
           "load_state"]
